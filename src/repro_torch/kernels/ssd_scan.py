"""Wrapper of the CUDA SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

:func:`ssd_scan` is the Mamba2 chunked SSD scan: y (B, S, H, P) in x's
dtype and, with ``return_final_state``, the (B, H, P, N) float32 state
after the last token. It replaces the Pallas TPU kernel of the JAX
package's ``kernels/ssd_scan.py`` and keeps its rules: ``H % G == 0``, head
h reads B/C group ``h // (H // G)``, chunks of ``min(chunk, S)`` rows, the
decay exponent clamped at 0, float32 sums. Unlike the Pallas wrapper it
takes any S (the kernel masks the ragged last chunk as the JAX XLA path
pads it: dt = 0, x = 0) and returns the final state itself, which the JAX
package gets from its XLA scan.

The chunk walk is split across the card in groups of consecutive chunks
(``autotune.ssd_groups``, a function of the shape alone): with one group a
call is one launch, with more it is three (each group's end state, the
groups' incoming states, then y), over a float32 scratch of one state per
group (``csrc/ssd_scan.cu`` says how). The products run on the tensor cores
with operands split into bf16 planes (ROADMAP section 3 item 12): two for
the float32 operands of the bf16 instance, three for every operand of the
float32 one, which walks chunks of at most ``F32_MAX_CHUNK`` rows so that
its planes fit a block's shared memory (a chunk of 128 is walked as two of
64: the same sums, rounded apart).

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
the plain version, ``kernels/ref.ssd_chunked_ref``, in the same groups,
whose own autograd gives the gradient there.

Gradients: on a CUDA tensor that needs one (grad mode on), the call is a
``torch.autograd.Function`` whose forward is the same launch and whose
backward is :func:`ssd_scan_bwd`, the CUDA backward of the same library
(the gradient ``jax.grad`` takes of the JAX package's XLA scan,
``ops._ssd_xla_chunked``; its Pallas kernel has none). It takes no
cotangent of the final state and raises on one. The backward walks chunks
of ``bwd_chunk`` rows (at most ``BWD_MAX_CHUNK``, chosen from the shape;
a (P, N) state whose block does not fit the card's shared memory at that
chunk raises), and keeps the reference's clamp, which acts within the
forward's chunks: where its chunk is shorter, a tie ``cum_t == cum_s``
across one of its boundaries inside a forward chunk passes the state's 1
in the walk, and a fifth launch takes half of it back (ROADMAP section 3
item 31). Without a gradient (serving, ``inference_mode``) nothing is
saved and no graph is recorded.
``LAUNCHES["ssd_scan_bwd"]`` counts the backward's calls. x,
Bm and Cm share one dtype (float32 or bf16) and may be strided views with a
unit stride on their last axis (the model's B and C are column slices of
one projection); dt, A and D are float32. The kernel keeps the (P, N)
state in its 8 warps' registers as strips of 16 x 64:
ceil(P / 16) * ceil(N / 64) <= 8 (Mamba2's 64 x 128 fills them). The
library is built at the first launch (``kernels/_cuda.py``). ``LAUNCHES``
counts the wrapper's calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from . import autotune
from . import ref

__all__ = ["ssd_scan", "ssd_scan_bwd", "kernel_split", "bwd_chunk", "build",
           "LAUNCHES", "reset_launches", "BWD_MAX_CHUNK"]

# calls that launched the kernels since the last reset_launches()
LAUNCHES = {"ssd_scan": 0, "ssd_scan_bwd": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = [ci] + [vp] * 9 + [ci] * 10 \
        + [cll] * 11 + [vp]
    lib.ssd_scan_launch.restype = ci
    lib.ssd_scan_smem_bytes.argtypes = [ci] * 6
    lib.ssd_scan_smem_bytes.restype = cll
    lib.ssd_scan_bwd_launch.argtypes = [ci] + [vp] * 15 + [ci] * 9 \
        + [cll] * 11 + [vp]
    lib.ssd_scan_bwd_launch.restype = ci
    lib.ssd_scan_bwd_smem_bytes.argtypes = [ci] * 3
    lib.ssd_scan_bwd_smem_bytes.restype = cll


# the kernel's state strips: 8 warps of 16 x 64
STATE_STRIPS = 8
# rows of the float32 instance's chunks, at most
F32_MAX_CHUNK = 64
# rows of the backward's chunks, at most (the block's float32 tiles at
# Mamba2's P 64, N 128 fit an H100 block's shared memory at 64)
BWD_MAX_CHUNK = 64

# checked launch plans by everything _check_args reads (shapes, strides,
# dtypes, devices) and the chunk: the C launcher's shape and stride
# arguments, whether the shapes and strides allow 16-byte loads, and the
# shared memory a block needs without and with them beside what the card
# gives one
_PLANS: dict = {}


def kernel_split(B: int, H: int, S: int, chunk: int,
                 dtype) -> autotune.SsdSplit:
    """The chunks and groups the kernel walks for this shape and dtype."""
    if dtype == torch.float32:
        chunk = min(chunk, F32_MAX_CHUNK)
    return autotune.ssd_groups(B, H, S, chunk)


def _plan(lib, x, dt, A, Bm, Cm, D_skip, chunk: int):
    """The launch plan of :data:`_PLANS`, made and checked once a layout."""
    key = (x.shape, x.stride(), dt.shape, dt.stride(), A.shape, A.stride(),
           Bm.shape, Bm.stride(), Cm.shape, Cm.stride(), D_skip.shape,
           D_skip.stride(), x.dtype, dt.dtype, A.dtype, Bm.dtype, Cm.dtype,
           D_skip.dtype, x.device, dt.device, A.device, Bm.device,
           Cm.device, D_skip.device, chunk)
    plan = _PLANS.get(key)
    if plan is None:
        _check_args(x, dt, A, Bm, Cm, D_skip)
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        B, S, H, P = x.shape
        G, N = Bm.shape[2], Bm.shape[3]
        strips = -(-P // 16) * -(-N // 64)
        if strips > STATE_STRIPS:
            raise ValueError(f"the kernel keeps the (P, N) state in "
                             f"{STATE_STRIPS} strips of 16 x 64: P={P}, "
                             f"N={N} needs {strips}")
        L, nc, per, ng = kernel_split(B, H, S, chunk, x.dtype)
        code = _cuda.DTYPES[x.dtype]
        carry = int(ng > 1 or nc > 1)
        smem = tuple(lib.ssd_scan_smem_bytes(code, L, P, N, carry, vec)
                     for vec in (0, 1))
        optin = torch.cuda.get_device_properties(
            x.device).shared_memory_per_block_optin
        dims = (B, S, H, P, G, N, L, per, ng)
        plan = _PLANS[key] = (code, dims, _strides(x, dt, Bm, Cm),
                              _vec_layout(x, Bm, Cm), smem, optin)
    return plan


def _vec_layout(x, Bm, Cm) -> bool:
    """Whether the shapes and strides allow 16-byte loads of x, B and C
    rows: whole vectors in the last extent and in every batch, sequence and
    head stride (the base addresses are checked at each call)."""
    per_vec = 16 // x.element_size()
    return all(t.shape[-1] % per_vec == 0
               and all(st % per_vec == 0 for st in t.stride()[:3])
               for t in (x, Bm, Cm))


def _vec(vec_layout: bool, x, Bm, Cm) -> int:
    return int(vec_layout and not (x.data_ptr() % 16 or Bm.data_ptr() % 16
                                   or Cm.data_ptr() % 16))


def _strides(x, dt, Bm, Cm):
    """The C launchers' stride arguments (unit last strides implied)."""
    return (*x.stride()[:3], *dt.stride()[:2], *Bm.stride()[:3],
            *Cm.stride()[:3])


def bwd_chunk(S: int, chunk: int = 128) -> int:
    """Rows of the backward's chunks: the forward's ``chunk``, at most S
    and ``BWD_MAX_CHUNK``; a function of the shape alone."""
    return max(1, min(chunk, S, BWD_MAX_CHUNK))


def build() -> ctypes.CDLL:
    """The library of ``csrc/ssd_scan.cu``, built on first use."""
    return _cuda.build("ssd_scan", ("dtype.cuh",), bind=_bind)


def _check_args(x, dt, A, Bm, Cm, D_skip):
    if x.ndim != 4 or dt.ndim != 3 or Bm.ndim != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan takes x (B, S, H, P), dt (B, S, H) and "
                         f"Bm, Cm (B, S, G, N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B, S, H, _ = x.shape
    G = Bm.shape[2]
    if (tuple(dt.shape) != (B, S, H) or tuple(Bm.shape[:2]) != (B, S)
            or A.shape != (H,) or D_skip.shape != (H,)):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, Bm {tuple(Bm.shape)}, A "
                         f"{tuple(A.shape)}, D {tuple(D_skip.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"ssd_scan needs H % G == 0, got H={H}, G={G}")
    if (not _cuda.takes(x.dtype, x.device)
            or not x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"x, Bm and Cm must share one dtype in "
                        f"{list(_cuda.DTYPES)} (or float64 on the CPU), got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    if not dt.dtype == A.dtype == D_skip.dtype == wide:
        raise TypeError(f"dt, A and D must be {wide} (float64 only with a "
                        f"float64 x), got {dt.dtype}, {A.dtype}, "
                        f"{D_skip.dtype}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm, D_skip)):
        raise ValueError("x, dt, A, Bm, Cm and D must lie on one device")
    if any(t.shape[-1] > 1 and t.stride(-1) != 1
           for t in (x, dt, Bm, Cm, A, D_skip)):
        raise ValueError("ssd_scan takes x, dt, Bm, Cm, A and D with a unit "
                         "stride on their last axis (any other strides)")


def ssd_scan(x, dt, A, Bm, Cm, D_skip, *, chunk: int = 128,
             return_final_state: bool = False):
    """Chunked SSD scan; shapes as in ``ref.ssd_scan_ref``. Returns y, or
    ``(y, final_state)`` with ``return_final_state``."""
    if not x.is_cuda:
        _check_args(x, dt, A, Bm, Cm, D_skip)
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D_skip, chunk=chunk,
                                   return_final_state=return_final_state)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm, D_skip)):
        return _SsdScan.apply(x, dt, A, Bm, Cm, D_skip, chunk,
                              return_final_state)
    return _launch(x, dt, A, Bm, Cm, D_skip, chunk, return_final_state)


class _SsdScan(torch.autograd.Function):
    """The kernel with the CUDA backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D_skip, chunk, return_final_state):
        if x.is_cuda:
            out = _launch(x, dt, A, Bm, Cm, D_skip, chunk,
                          return_final_state)
        else:   # the plain route (the gradient checks, in float64)
            out = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D_skip, chunk=chunk,
                                      return_final_state=return_final_state)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D_skip)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, dy, dstate=None):
        if dstate is not None:
            raise RuntimeError("ssd_scan's backward takes no cotangent of the "
                               "final state (the prefill path's): call it "
                               "without return_final_state, or under "
                               "torch.no_grad()")
        if dy is None:
            return (None,) * 8
        grads = ssd_scan_bwd(*ctx.saved_tensors, dy, chunk=ctx.chunk)
        return (*grads, None, None)


def _launch(x, dt, A, Bm, Cm, D_skip, chunk, return_final_state):
    """The forward launch: y, or (y, final state)."""
    lib = build()
    code, dims, strides, vec_layout, smem, optin = _plan(
        lib, x, dt, A, Bm, Cm, D_skip, chunk)
    B, S, H, P, G, N, L, per, ng = dims
    vec = _vec(vec_layout, x, Bm, Cm)
    if smem[vec] > optin:
        raise ValueError(f"a chunk of {L} rows at P={P}, N={N} in {x.dtype} "
                         f"needs {smem[vec]} bytes of shared memory, the "
                         f"card gives a block {optin}")
    dev = x.device
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    state = (torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
             if return_final_state else None)
    # one end state and one decay per (b, h) and group but the last
    scratch = (torch.empty((B * H * (ng - 1) * (P * N + 1),),
                           dtype=torch.float32, device=dev)
               if ng > 1 else None)
    err = lib.ssd_scan_launch(
        code, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), D_skip.data_ptr(), y.data_ptr(),
        state.data_ptr() if state is not None else None,
        scratch.data_ptr() if scratch is not None else None, *dims, vec,
        *strides, torch._C._cuda_getCurrentRawStream(dev.index))
    _cuda.check(err, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return (y, state) if return_final_state else y


def ssd_scan_bwd(x, dt, A, Bm, Cm, D_skip, dy, *, chunk: int = 128):
    """(dx, ddt, dA, dB, dC, dD) of ``ssd_scan(x, dt, A, Bm, Cm, D_skip,
    chunk=chunk)``'s y for the cotangent ``dy`` (B, S, H, P), each in its
    input's dtype, in chunks of ``bwd_chunk(S, chunk)`` rows. On the
    card up to five launches (the chunks' incoming states in two, the
    reverse walk, the ties across its chunks inside a forward chunk, and
    the sums over heads and batch; ``csrc/ssd_scan.cu`` says how) over float32 scratch freed after the call; on the CPU the
    plain version, ``ref.ssd_chunked_bwd_ref`` (float64 too: the gradient
    checks run it)."""
    _check_args(x, dt, A, Bm, Cm, D_skip)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dy.shape) != (B, S, H, P):
        raise ValueError(f"dy must be {(B, S, H, P)}, got {tuple(dy.shape)}")
    L = bwd_chunk(S, chunk)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return ref.ssd_chunked_bwd_ref(x, dt, A, Bm, Cm, D_skip,
                                       dy.to(x.dtype), chunk=L,
                                       fwd_chunk=chunk)
    strips = -(-P // 16) * -(-N // 64)
    if strips > STATE_STRIPS:
        raise ValueError(f"the kernel keeps the (P, N) state in "
                         f"{STATE_STRIPS} strips of 16 x 64: P={P}, N={N} "
                         f"needs {strips}")
    lib = build()
    optin = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    smem = lib.ssd_scan_bwd_smem_bytes(L, P, N)
    if smem > optin:
        raise ValueError(f"the SSD backward's block at L={L}, P={P}, N={N} "
                         f"needs {smem} bytes of shared memory, the card "
                         f"gives a block {optin}")
    dev = x.device
    dy = dy.to(x.dtype).contiguous()
    nc = -(-S // L)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, S, H), **f32)
    dB = torch.empty((B, S, G, N), dtype=x.dtype, device=dev)
    dC = torch.empty_like(dB)
    dA = torch.empty((H,), **f32)
    dD = torch.empty((H,), **f32)
    states = (torch.empty((B * H * (nc - 1) * (P * N + 1),), **f32)
              if nc > 1 else None)
    partial = torch.empty((2 * B * S * H * N + 2 * B * H,), **f32)
    err = lib.ssd_scan_bwd_launch(
        _cuda.DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), D_skip.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dA.data_ptr(), dD.data_ptr(),
        states.data_ptr() if states is not None else None,
        partial.data_ptr(), B, S, H, P, G, N, L, min(chunk, S),
        _vec(_vec_layout(x, Bm, Cm), x, Bm, Cm), *_strides(x, dt, Bm, Cm),
        torch._C._cuda_getCurrentRawStream(dev.index))
    _cuda.check(err, "ssd_scan_bwd")
    LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt, dA, dB, dC, dD
