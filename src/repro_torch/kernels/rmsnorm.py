"""Wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

:func:`rmsnorm` normalizes x over its last axis and scales by w, with
float32 math and the output in x's dtype. It replaces the Pallas TPU kernel
of the JAX package's ``kernels/rmsnorm.py``. On a CUDA tensor it launches
the kernel or raises; on a CPU tensor it runs the plain version,
``kernels/ref.rmsnorm_ref``. The library is built at the first launch
(``kernels/_cuda.py``). ``LAUNCHES`` counts the kernel's launches.

The model calls it ~130-145 times a forward on a few kilobytes to a few
megabytes each, so the host's path per call counts as much as the
kernel's: the checks that raise stay, the launcher is looked up once, and
the current stream is read without building a ``torch.cuda.Stream``.

Gradients: on a CUDA tensor that needs one (grad mode on), the call is a
``torch.autograd.Function`` whose backward is :func:`rmsnorm_bwd`, the CUDA
backward kernels of the same library: dx and a partial dw row a block in
one launch, in the forward's 16-byte vector forms (a scalar form for a
ragged D or a pointer off 16 bytes), then the partial rows' fixed-order
sum; no atomics. It is the gradient ``jax.grad`` takes of the JAX
package's XLA ``rms_norm``; the Pallas kernel has no backward.
``LAUNCHES["rmsnorm_bwd"]`` counts its calls. On a CPU tensor the plain
version's own autograd gives it.

On a ``meta`` tensor (the dry run: shapes without storage) the call
launches nothing: it returns an empty output of the kernel's shape and
dtype and records the kernel's work (``launch.roofline.rmsnorm_work``) in
the active count, through the same ``autograd.Function`` under a gradient,
whose backward records ``rmsnorm_bwd``'s. Only a meta tensor takes it.

Split rows (:func:`rmsnorm_split`): under tensor parallelism a rank may
hold only its columns of each row (Mamba2's gated norm over the rank's SSD
heads, ``models/ssm.py``). Its forward launches :func:`row_stat` (each
row's float32 sum of squares over the rank's columns, the
``rmsnorm_stat`` kernel), all-reduces it over the ranks'
process group (one float a row on the wire) and launches
:func:`rmsnorm_rows`, the forward forms above reading that total and the
global width n; its backward does the same with the row's sum of x w dy
and :func:`rmsnorm_rows_bwd`. The rank's dw is its own columns' and takes
no sum over the ranks. ``LAUNCHES`` counts ``rmsnorm_stat``,
``rmsnorm_split`` and ``rmsnorm_split_bwd``. On the CPU the same
``autograd.Function`` runs the plain versions (``ref.rmsnorm_stat_ref``,
``ref.rmsnorm_split_ref``, ``ref.rmsnorm_split_bwd_ref``); a meta tensor
records each kernel's work.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from . import ref
from ..launch import collectives, roofline

__all__ = ["rmsnorm", "rmsnorm_bwd", "rmsnorm_split", "row_stat",
           "rmsnorm_rows", "rmsnorm_rows_bwd", "build", "LAUNCHES",
           "reset_launches"]

# kernel launches since the last reset_launches()
LAUNCHES = {"rmsnorm": 0, "rmsnorm_bwd": 0, "rmsnorm_stat": 0,
            "rmsnorm_split": 0, "rmsnorm_split_bwd": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cll, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
    lib.rmsnorm_launch.argtypes = [ci, vp, vp, vp, cll, ci, cf, vp]
    lib.rmsnorm_launch.restype = ci
    lib.rmsnorm_bwd_launch.argtypes = [ci] + [vp] * 6 + [cll, ci, cf, vp]
    lib.rmsnorm_bwd_launch.restype = ci
    lib.rmsnorm_bwd_blocks.argtypes = [cll]
    lib.rmsnorm_bwd_blocks.restype = cll
    lib.rmsnorm_stat_launch.argtypes = [ci, vp, vp, vp, vp, cll, ci, vp]
    lib.rmsnorm_stat_launch.restype = ci
    lib.rmsnorm_split_launch.argtypes = [ci, vp, vp, vp, vp, cll, ci, cf,
                                         cf, vp]
    lib.rmsnorm_split_launch.restype = ci
    lib.rmsnorm_split_bwd_launch.argtypes = ([ci] + [vp] * 8
                                             + [cll, ci, cf, cf, vp])
    lib.rmsnorm_split_bwd_launch.restype = ci


def build() -> ctypes.CDLL:
    """The library of ``csrc/rmsnorm.cu``, built on first use."""
    return _cuda.build("rmsnorm", ("dtype.cuh",), bind=_bind)


# the bound C launcher, looked up at the first launch
_launch = None


def _bound_launcher():
    global _launch
    _launch = build().rmsnorm_launch
    return _launch


def _check_args(x, w):
    if w.ndim != 1 or x.ndim < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"rmsnorm takes x (..., D) and w (D,), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not _cuda.takes(x.dtype, x.device) or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm takes x and w of one dtype in "
                        f"{list(_cuda.DTYPES)} (or float64 on the CPU), got "
                        f"{x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.device.type == "cuda" and not (x.is_contiguous()
                                        and w.is_contiguous()):
        raise ValueError("rmsnorm's kernel takes contiguous x and w")


def rmsnorm(x, w, *, eps: float = 1e-6):
    """``(x * rsqrt(mean(x^2, -1) + eps)) * w`` over the last axis."""
    # the card's path first: the same checks as _check_args, each a cheap
    # test that sends any failure to _check_args for its message
    if x.is_cuda:
        code = _cuda.DTYPES.get(x.dtype)
        dev = x.get_device()
        if (x.shape[-1:] != w.shape or code is None or w.dtype is not x.dtype
                or w.get_device() != dev
                or not (x.is_contiguous() and w.is_contiguous())):
            _check_args(x, w)
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _RMSNorm.apply(x, w, eps)
        out = torch.empty_like(x)
        D = w.shape[0]
        rows = x.numel() // D if D else 0
        if rows == 0:
            return out
        # the current stream's handle, without building a torch.cuda.Stream
        err = (_launch or _bound_launcher())(
            code, x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, D,
            float(eps), torch._C._cuda_getCurrentRawStream(dev))
        if err:
            raise RuntimeError(f"CUDA rmsnorm launch failed: cudaError {err}")
        LAUNCHES["rmsnorm"] += 1
        return out
    _check_args(x, w)
    if x.device.type == "meta":
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _RMSNorm.apply(x, w, eps)
        return _meta_forward(x, w)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return ref.rmsnorm_ref(x, w, eps=eps)


def _rows(x, w) -> int:
    D = w.shape[0]
    return x.numel() // D if D else 0


def _meta_forward(x, w):
    """The kernel's output on meta tensors, its work recorded."""
    roofline.record_kernel("rmsnorm", *roofline.rmsnorm_work(
        _rows(x, w), w.shape[0], x.element_size()))
    return torch.empty_like(x)


class _RMSNorm(torch.autograd.Function):
    """The kernel with the CUDA backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, w, eps):
        with torch.no_grad():
            out = (ref.rmsnorm_ref(x, w, eps=eps) if x.device.type == "cpu"
                   else rmsnorm(x, w, eps=eps))
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy, eps=ctx.eps)
        return dx, dw, None


def rmsnorm_bwd(x, w, dy, *, eps: float = 1e-6):
    """(dx, dw) of ``rmsnorm(x, w)`` for the output cotangent ``dy``: dx in
    x's dtype, dw (D,) in w's, float32 sums. On the card the backward
    kernel; on the CPU its plain version, ``ref.rmsnorm_bwd_ref`` (any
    float dtype: the gradient checks run it in float64). An x with no rows
    gives a zero dw: no row contributes to the sum."""
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.rmsnorm_bwd_ref(x, w, dy, eps=eps)
    _check_args(x, w)
    if x.device.type == "meta":
        roofline.record_kernel("rmsnorm_bwd", *roofline.rmsnorm_bwd_work(
            _rows(x, w), w.shape[0], x.element_size()))
        return torch.empty_like(x), torch.empty_like(w)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    dy = dy.to(x.dtype).contiguous()
    D = w.shape[0]
    rows = x.numel() // D if D else 0
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    lib = build()
    part = torch.empty((lib.rmsnorm_bwd_blocks(rows), D),
                       dtype=torch.float32, device=x.device)
    err = lib.rmsnorm_bwd_launch(
        _cuda.DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), part.data_ptr(), rows, D, float(eps),
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    _cuda.check(err, "rmsnorm_bwd")
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dw


# ------------------------------------------------------------ split rows
def _stream(t):
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check_split(x, w, *stats):
    _check_args(x, w)
    for st in stats:
        if st.shape != x.shape[:-1] or st.device != x.device:
            raise ValueError(f"a row total must be x's rows "
                             f"{tuple(x.shape[:-1])} on {x.device}, got "
                             f"{tuple(st.shape)} on {st.device}")
        if x.is_cuda and (st.dtype != torch.float32
                          or not st.is_contiguous()):
            raise TypeError("the kernel takes contiguous float32 row totals")


def row_stat(x, w=None, dy=None):
    """Each row's float32 partial over x's columns (..., D) -> (...,):
    sum(x^2), or with ``w`` and ``dy`` sum(x w dy). On the card the
    ``rmsnorm_stat`` kernel; on the CPU ``ref.rmsnorm_stat_ref``."""
    dot = dy is not None
    if dot:
        _check_args(x, w)
        if dy.shape != x.shape:
            raise ValueError(f"dy {tuple(dy.shape)} must have x's shape "
                             f"{tuple(x.shape)}")
    elif not _cuda.takes(x.dtype, x.device):
        raise TypeError(f"row_stat takes x in {list(_cuda.DTYPES)}, got "
                        f"{x.dtype}")
    if x.device.type == "cpu":
        return ref.rmsnorm_stat_ref(x, w, dy)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if x.device.type == "meta":
        roofline.record_kernel("rmsnorm_stat", *roofline.rmsnorm_stat_work(
            rows, D, x.element_size(), dot))
        return torch.empty(x.shape[:-1], dtype=torch.float32, device="meta")
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("row_stat's kernel takes a contiguous x")
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    if dot:
        dy = dy.to(x.dtype).contiguous()
    err = build().rmsnorm_stat_launch(
        _cuda.DTYPES[x.dtype], x.data_ptr(), w.data_ptr() if dot else None,
        dy.data_ptr() if dot else None, out.data_ptr(), rows, D, _stream(x))
    _cuda.check(err, "rmsnorm_stat")
    LAUNCHES["rmsnorm_stat"] += 1
    return out


def rmsnorm_rows(x, w, ss, n: int, *, eps: float = 1e-6):
    """The split-row forward of a rank's columns x (..., D) given ``ss``
    (...,) float32, each row's sum of squares over all ``n`` columns:
    ``x rsqrt(ss / n + eps) w`` in x's dtype. On the card the forward
    kernel's split mode; on the CPU ``ref.rmsnorm_split_ref``."""
    _check_split(x, w, ss)
    if x.device.type == "cpu":
        return ref.rmsnorm_split_ref(x, w, ss, n, eps=eps)
    rows = _rows(x, w)
    if x.device.type == "meta":
        roofline.record_kernel("rmsnorm_split", *roofline.rmsnorm_split_work(
            rows, w.shape[0], x.element_size()))
        return torch.empty_like(x)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    err = build().rmsnorm_split_launch(
        _cuda.DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
        ss.data_ptr(), rows, w.shape[0], float(n), float(eps), _stream(x))
    _cuda.check(err, "rmsnorm_split")
    LAUNCHES["rmsnorm_split"] += 1
    return out


def rmsnorm_rows_bwd(x, w, dy, ss, dot, n: int, *, eps: float = 1e-6):
    """(dx, dw) of :func:`rmsnorm_rows` for the rank's cotangent ``dy``
    given the row totals ``ss`` and ``dot`` (sum(x w dy) over all ``n``
    columns); dw is the rank's own columns'. On the card the backward
    kernels' split mode (two launches, counted once); on the CPU
    ``ref.rmsnorm_split_bwd_ref``. An x with no rows gives a zero dw: no
    row contributes to the sum."""
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    _check_split(x, w, ss, dot)
    if x.device.type == "cpu":
        return ref.rmsnorm_split_bwd_ref(x, w, dy, ss, dot, n, eps=eps)
    rows = _rows(x, w)
    if x.device.type == "meta":
        roofline.record_kernel(
            "rmsnorm_split_bwd", *roofline.rmsnorm_split_bwd_work(
                rows, w.shape[0], x.element_size()))
        return torch.empty_like(x), torch.empty_like(w)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    dy = dy.to(x.dtype).contiguous()
    D = w.shape[0]
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    lib = build()
    part = torch.empty((lib.rmsnorm_bwd_blocks(rows), D),
                       dtype=torch.float32, device=x.device)
    err = lib.rmsnorm_split_bwd_launch(
        _cuda.DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), part.data_ptr(), ss.data_ptr(),
        dot.data_ptr(), rows, D, float(n), float(eps), _stream(x))
    _cuda.check(err, "rmsnorm_split_bwd")
    LAUNCHES["rmsnorm_split_bwd"] += 1
    return dx, dw


class _SplitRMSNorm(torch.autograd.Function):
    """The split-row norm: the row totals all-reduced over ``group``
    between the two launches of each pass."""

    @staticmethod
    def forward(ctx, x, w, group, n, eps):
        ss = collectives.all_reduce(row_stat(x), group)
        ctx.save_for_backward(x, w, ss)
        ctx.group, ctx.n, ctx.eps = group, n, eps
        return rmsnorm_rows(x, w, ss, n, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, w, ss = ctx.saved_tensors
        dot = collectives.all_reduce(row_stat(x, w, dy.contiguous()),
                                     ctx.group)
        dx, dw = rmsnorm_rows_bwd(x, w, dy, ss, dot, ctx.n, eps=ctx.eps)
        return dx, dw, None, None, None


def rmsnorm_split(x, w, group, n: int, *, eps: float = 1e-6):
    """RMSNorm of rows whose ``n`` columns lie on the ranks of ``group``,
    this rank holding x (..., D) and its scale columns w (D,): each row's
    sum of squares is all-reduced over ``group`` (None: one rank, whose D
    must then be n) and ``x rsqrt(ss / n + eps) w`` comes back in x's
    dtype. Differentiable (the module says how)."""
    if group is None and n != w.shape[0]:
        raise ValueError(f"one rank holds {w.shape[0]} of {n} columns")
    return _SplitRMSNorm.apply(x, w, group, n, eps)
