"""Wrapper of the CUDA flash-attention kernels (``csrc/attention.cu``).

:func:`flash_attention` is online-softmax GQA attention with causal and
sliding-window masks and non-causal rectangular (cross) attention. It
replaces the Pallas TPU kernel of the JAX package's
``kernels/flash_attention.py`` and keeps its rules: a causal or windowed
call needs Sq == Sk, query head h reads kv head ``h // (Hq // Hkv)``, and
the scale multiplies after the dot. Unlike the Pallas wrapper it takes any
Sq and Sk: the kernels mask the ragged last tiles themselves.

On a CUDA tensor it launches a kernel or raises; on a CPU tensor it runs
the plain version, ``kernels/ref.flash_attention_ref``. The kernel is
chosen by dtype, and both are launched and counted:

* bf16: the tensor-core kernel (``fa_wgmma_kernel``: wgmma products, TMA
  loads). It takes a head_dim in ``BF16_HEAD_DIMS`` (multiples of 8 up to
  256: tiles of 64, 128, 192 or 256 columns, zero-padded past D), a value
  head dim whose tile pairs with it in ``BF16_TILE_PAIRS`` (the same tile,
  or 192 with 128: MLA's q, k of 192 and v of 128), and reads
  q, k and v through TMA tensor maps, so every base address and every
  batch, head and sequence stride must be a multiple of 16 bytes. It rounds
  P to bf16 before P . V, as the JAX model's XLA path does (ROADMAP §3
  item 7): :func:`ref.flash_attention_bf16p_ref` is that arithmetic.
* float32: ``fa_f32_kernel``, on the tensor cores in split TF32: each
  operand split into hi = TF32(x) and lo = x - hi (read as TF32 toward
  zero), every product lo.hi + hi.lo + hi.hi (``mma.sync`` m16n8k8),
  about 21 bits; a NaN or an infinity in an operand gives a NaN. One TF32
  product keeps 11 bits of an operand, an error near 2^-11 a term that
  misses the float32 tolerance (2e-4); :func:`ref.split_einsum` is the
  arithmetic on the CPU. Any head_dim and value head dim up to
  ``MAX_HEAD_DIM``, in a tile of 64, 128, 192 or 256 columns (zero past
  them), q, k and v read through 16-byte copies where their strides allow
  and 4-byte ones otherwise.

Both read q, k and v through their batch, head and sequence strides, so
the model's ``(B, S, H, D)`` projections pass as ``swapaxes(1, 2)`` views
without a copy; both need a unit stride on D and raise otherwise. The
library is built at the first launch (``kernels/_cuda.py``) and also holds
the flash decode kernels. ``LAUNCHES`` counts the wrapper's launches.

Gradients: on a CUDA tensor that needs one (grad mode on), the call is a
``torch.autograd.Function`` whose forward also writes each row's float32
log-sum-exp (B, Hq, Sq) and whose backward is :func:`flash_attention_bwd`,
the CUDA backward kernels of the same library (the gradient ``jax.grad``
takes of the JAX package's XLA attention; its Pallas kernel has none).
Without a gradient (serving, ``inference_mode``) no LSE is written and no
graph is recorded. The backward takes D and Dv up to ``MAX_BWD_HEAD_DIM``
(192: MLA's q, k of 192 with v of 128, Nemotron's 192), in float32 any
pair, in bf16 a pair whose tiles are in ``BWD_TILE_PAIRS``; a head dim of
256 has no architecture in the zoo and raises (ROADMAP.md section 2). In
bf16 its passes are wgmma kernels fed by TMA (``fa_bwd_dkdv_kernel``,
``fa_bwd_dq_kernel``), so D and Dv are multiples of 8 and q, k, v follow
the forward's 16-byte rule; a dO or an out that does not (a view off 16
bytes, or without a unit stride on its last axis) is copied to a
contiguous tensor first. In float32 they are the forward's split TF32
(``fa_bwd_dkdv_f32_kernel``, ``fa_bwd_dq_f32_kernel``, the dQ pass a
programmatic dependent launch beside the dK/dV pass).
``LAUNCHES["flash_attention_bwd"]`` counts its calls (three kernel
launches each: D_i, dK/dV, dQ; at the 192 tile the bf16 dK/dV block's two
warpgroups take one accumulator each). ``LAUNCHES`` also counts each
kernel's float32 calls apart (``flash_attention_f32``,
``flash_attention_bwd_f32``), within the totals. On a CPU tensor the plain
version's own autograd gives the gradient.

On a ``meta`` tensor (the dry run) the call launches nothing: after the
card's checks of shapes, dtypes and head dims it returns an empty output
of the kernel's shape and dtype and records the kernel's work
(``launch.roofline.attention_work``) in the active count, through the
same ``autograd.Function`` under a gradient, whose backward records
``flash_attention_bwd``'s. Only a meta tensor takes it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda
from . import ref
from ..launch import roofline

__all__ = ["flash_attention", "flash_attention_bwd", "build", "LAUNCHES",
           "reset_launches", "MAX_HEAD_DIM", "MAX_BWD_HEAD_DIM",
           "BF16_HEAD_DIMS", "BF16_TILE_PAIRS", "BWD_TILE_PAIRS"]

MAX_HEAD_DIM = 256   # both kernels' widest tile
# head dims of the bf16 kernel's instances: tiles of 64, 128, 192 and 256
# columns, each taking the multiples of 8 up to its width
BF16_HEAD_DIMS = tuple(range(8, MAX_HEAD_DIM + 1, 8))
# (q/k tile, v tile) of the bf16 kernel's instances (csrc/attention.cu)
BF16_TILE_PAIRS = ((64, 64), (128, 128), (192, 192), (192, 128), (256, 256))
# the backward kernels' widest head dim (D and Dv), and the (q/k, v) tiles
# of the bf16 backward's instances
MAX_BWD_HEAD_DIM = 192
BWD_TILE_PAIRS = ((64, 64), (128, 128), (192, 192), (192, 128))

# kernel launches since the last reset_launches(); the *_f32 keys count the
# float32 calls among them
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0,
            "flash_attention_f32": 0, "flash_attention_bwd_f32": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cll, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
    lib.flash_attention_launch.argtypes = ([ci, vp, vp, vp, vp]
                                           + [ci] * 7 + [cll] * 9
                                           + [ci, ci, cf, vp, vp])
    lib.flash_attention_launch.restype = ci
    lib.flash_decode_launch.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci,
                                        ci, ci, ci, ci, ci, cf, vp]
    lib.flash_decode_launch.restype = ci
    lib.flash_decode_partial_launch.argtypes = [ci, vp, vp, vp, vp, vp, vp,
                                                vp, ci, ci, ci, ci, ci, ci,
                                                ci, cf, vp]
    lib.flash_decode_partial_launch.restype = ci
    lib.flash_attention_bwd_launch.argtypes = ([ci] + [vp] * 10 + [ci] * 7
                                               + [vp, ci, ci, cf, vp])
    lib.flash_attention_bwd_launch.restype = ci
    lib.flash_attention_bwd_scratch.argtypes = [ci, ci, ci, ci]
    lib.flash_attention_bwd_scratch.restype = cll


def build(defines: tuple = ()) -> ctypes.CDLL:
    """The library of ``csrc/attention.cu``, built on first use;
    ``defines`` (``"NAME=value"``) builds a variant beside it (chip_smoke.py's
    ``--f32-terms`` control)."""
    return _cuda.build("attention", ("dtype.cuh", "wgmma.cuh"),
                       defines=defines, bind=_bind)


def _bf16_tile(d: int) -> int:
    return next(t for t in (64, 128, 192, MAX_HEAD_DIM) if d <= t)


def _check_args(q, k, v, causal, window):
    if (q.ndim != 4 or k.ndim != 4 or v.ndim != 4
            or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"flash_attention takes q (B, Hq, Sq, D), k "
                         f"(B, Hkv, Sk, D) and v (B, Hkv, Sk, Dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} need "
                         f"one B and D and Hq % Hkv == 0")
    if Sq != k.shape[2] and (causal or window is not None):
        raise ValueError("a rectangular call (Sq != Sk) must be non-causal "
                         "and without a window")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0 or None, got {window}")
    if (not _cuda.takes(q.dtype, q.device)
            or not q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must share one dtype in "
                        f"{list(_cuda.DTYPES)} (or float64 on the CPU), got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")


def _strides(t):
    """The B, H and S strides of a (B, H, S, D) tensor. An axis of extent
    1 is never stepped along, so its stride, whatever torch reports, is
    passed as that of a contiguous tensor (a valid TMA stride)."""
    out, span = [], t.shape[3]
    for ax in (2, 1, 0):
        out.append(t.stride(ax) if t.shape[ax] > 1 else span)
        span *= t.shape[ax]
    return out[::-1]


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    sm_scale: Optional[float] = None):
    """q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv) ->
    (B, Hq, Sq, Dv) in q's dtype. ``sm_scale`` defaults to ``D ** -0.5``."""
    _check_args(q, k, v, causal, window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       sm_scale=sm_scale)
    if q.device.type == "meta":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FlashAttention.apply(q, k, v, causal, window, sm_scale)
        return _meta_forward(q, k, v, causal, window, with_lse=False)[0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, sm_scale)
    return _forward(q, k, v, causal, window, sm_scale, with_lse=False)[0]


class _FlashAttention(torch.autograd.Function):
    """The kernel with the CUDA backward kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale):
        if q.is_cuda:
            _check_bwd(q, k, v)
            out, lse = _forward(q, k, v, causal, window, sm_scale,
                                with_lse=True)
        elif q.device.type == "meta":
            _check_bwd(q, k, v)
            out, lse = _meta_forward(q, k, v, causal, window, with_lse=True)
        else:   # the plain route (the gradient checks, in float64)
            out, lse = ref.flash_attention_lse_ref(
                q, k, v, causal=causal, window=window, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, sm_scale = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         sm_scale=sm_scale)
        return dq, dk, dv, None, None, None


def _check_bwd(q, k, v):
    D, Dv = q.shape[3], v.shape[3]
    if max(D, Dv) > MAX_BWD_HEAD_DIM:
        raise ValueError(
            f"flash_attention's backward kernels take head dims up to "
            f"{MAX_BWD_HEAD_DIM}, got D={D}, Dv={Dv}: no architecture of the "
            f"zoo trains a wider head (ROADMAP.md section 2)")
    if q.dtype == torch.bfloat16 and (
            D % 8 or Dv % 8
            or (_bf16_tile(D), _bf16_tile(Dv)) not in BWD_TILE_PAIRS):
        raise ValueError(f"the bf16 backward takes D and Dv in multiples "
                         f"of 8 whose (q/k, v) tiles are in {BWD_TILE_PAIRS}, "
                         f"got D={D}, Dv={Dv}")


def _check_dims(q, v):
    """The forward kernels' head dims (the bf16 kernel's instances)."""
    D, Dv = q.shape[3], v.shape[3]
    if q.dtype == torch.bfloat16:
        if D not in BF16_HEAD_DIMS or Dv not in BF16_HEAD_DIMS:
            raise ValueError(f"the bf16 kernel takes head dims in 8, 16, ..., "
                             f"{MAX_HEAD_DIM} (multiples of 8: tiles of 64, "
                             f"128, 192 and 256), got D={D}, Dv={Dv}")
        pair = (_bf16_tile(D), _bf16_tile(Dv))
        if pair not in BF16_TILE_PAIRS:
            raise ValueError(f"the bf16 kernel has no instance for D={D} "
                             f"with Dv={Dv} (tiles {pair}); its (q/k, v) "
                             f"tiles are {BF16_TILE_PAIRS}")
    elif max(D, Dv) > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims <= {MAX_HEAD_DIM}, "
                         f"got D={D}, Dv={Dv}")


def _meta_forward(q, k, v, causal, window, *, with_lse: bool):
    """The forward's outputs on meta tensors, its work recorded."""
    _check_dims(q, v)
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    roofline.record_kernel("flash_attention", *roofline.attention_work(
        B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, q.element_size()))
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    return out, lse


def _forward(q, k, v, causal, window, sm_scale, *, with_lse: bool):
    """The forward launch: (out, lse), lse (B, Hq, Sq) float32 when
    ``with_lse`` and None otherwise."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    _check_dims(q, v)
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the kernel takes q, k and v with unit stride on "
                         "D (any strides on B, H and S)")
    if q.dtype == torch.bfloat16 and not all(_tma_ready(t)
                                             for t in (q, k, v)):
        raise ValueError(_TMA_RULE)
    strides = [_strides(t) for t in (q, k, v)]
    scale = _scale(D, sm_scale)
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build().flash_attention_launch(
        _cuda.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, Sq, Sk, D, Dv,
        *strides[0], *strides[1], *strides[2],
        int(causal), _window(window, Sq), float(scale),
        lse.data_ptr() if lse is not None else None, stream)
    _cuda.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    if q.dtype == torch.float32:
        LAUNCHES["flash_attention_f32"] += 1
    return out, lse


_TMA_RULE = ("the bf16 kernels read q, k and v with TMA: their base "
             "addresses and their B, H and S strides must be multiples of "
             "16 bytes")


def _tma_ready(t) -> bool:
    """Whether a bf16 (B, H, S, D) tensor can be read by TMA and 16-byte
    loads as it lies: unit stride on D, base and B, H, S strides on 16
    bytes."""
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in _strides(t)))


def _tma_operand(t):
    """``t`` itself where the bf16 backward reads it as it lies, else a
    contiguous copy (the backward's dO and out)."""
    return t if _tma_ready(t) else t.clone(
        memory_format=torch.contiguous_format)


def _scale(D: int, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)


def _window(window: Optional[int], Sq: int) -> int:
    """A window of Sq or more masks nothing beyond causal: passed as none
    (-1)."""
    return -1 if window is None or window >= Sq else int(window)


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: Optional[int] = None,
                        sm_scale: Optional[float] = None):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` given its ``out``, the
    forward's ``lse`` (B, Hq, Sq) float32 and the output cotangent ``dout``
    (B, Hq, Sq, Dv), on the card: three launches (D_i = rowsum(dout . out),
    dK/dV by key tile, dQ by query tile). Each gradient is in its input's
    dtype and, for a dense view, its strides (the model's strided q, k and
    v get gradients in the same layout). In bf16, q, k and v must meet the
    forward's 16-byte rule (it raises otherwise), and a ``dout`` or ``out``
    that does not is copied to a contiguous tensor first (TMA and the D_i
    pass read them; autograd's dO is the model's strided view and is read
    as it lies). On the CPU it runs the kernels' plain version,
    ``ref.flash_attention_bwd_ref`` (any float dtype: the gradient checks
    run it in float64)."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                           causal=causal, window=window,
                                           sm_scale=sm_scale)
    _check_args(q, k, v, causal, window)
    _check_bwd(q, k, v)
    if q.device.type == "meta":
        B, Hq, Sq, D = q.shape
        roofline.record_kernel("flash_attention_bwd",
                               *roofline.attention_bwd_work(
                                   B, Hq, k.shape[1], Sq, k.shape[2], D,
                                   v.shape[3], causal, window,
                                   q.element_size()))
        return tuple(torch.empty_like(t) for t in (q, k, v))
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (out.shape != (B, Hq, Sq, Dv) or dout.shape != out.shape
            or lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32
            or out.dtype != q.dtype):
        raise ValueError(f"flash_attention_bwd takes out and dout "
                         f"{(B, Hq, Sq, Dv)} in q's dtype and lse "
                         f"{(B, Hq, Sq)} float32, got {tuple(out.shape)}, "
                         f"{tuple(dout.shape)}, {tuple(lse.shape)} "
                         f"{lse.dtype}")
    dout = dout.to(q.dtype)
    if q.dtype == torch.bfloat16:
        if not all(_tma_ready(t) for t in (q, k, v)):
            raise ValueError(_TMA_RULE)
        out, dout = _tma_operand(out), _tma_operand(dout)
    elif dout.stride(3) != 1:
        dout = dout.contiguous()
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    lib = build()
    code = _cuda.DTYPES[q.dtype]
    delta = torch.empty(lib.flash_attention_bwd_scratch(code, B, Hq, Sq),
                        dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*[
        st for t in (q, k, v, out, dout, dq, dk, dv) for st in _strides(t)])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_bwd_launch(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
        Dv, strides, int(causal), _window(window, Sq),
        float(_scale(D, sm_scale)), stream)
    _cuda.check(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    if q.dtype == torch.float32:
        LAUNCHES["flash_attention_bwd_f32"] += 1
    return dq, dk, dv
