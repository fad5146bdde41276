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
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from . import ref

__all__ = ["rmsnorm", "rmsnorm_bwd", "build", "LAUNCHES", "reset_launches"]

# kernel launches since the last reset_launches()
LAUNCHES = {"rmsnorm": 0, "rmsnorm_bwd": 0}


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
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return ref.rmsnorm_ref(x, w, eps=eps)


class _RMSNorm(torch.autograd.Function):
    """The kernel with the CUDA backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, w, eps):
        with torch.no_grad():
            out = (rmsnorm(x, w, eps=eps) if x.is_cuda
                   else ref.rmsnorm_ref(x, w, eps=eps))
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
