"""Wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

:func:`rmsnorm` normalizes x over its last axis and scales by w, with
float32 math and the output in x's dtype. It replaces the Pallas TPU kernel
of the JAX package's ``kernels/rmsnorm.py``. On a CUDA tensor it launches
the kernel or raises; on a CPU tensor it runs the plain version,
``kernels/ref.rmsnorm_ref``. The library is built at the first launch
(``kernels/_cuda.py``). ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from . import ref

__all__ = ["rmsnorm", "build", "LAUNCHES", "reset_launches"]

# kernel launches since the last reset_launches()
LAUNCHES = {"rmsnorm": 0}


def reset_launches() -> None:
    LAUNCHES["rmsnorm"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cll, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
    lib.rmsnorm_launch.argtypes = [ci, vp, vp, vp, cll, ci, cf, vp]
    lib.rmsnorm_launch.restype = ci


def build() -> ctypes.CDLL:
    """The library of ``csrc/rmsnorm.cu``, built on first use."""
    return _cuda.build("rmsnorm", ("dtype.cuh",), bind=_bind)


def _check_args(x, w):
    if w.ndim != 1 or x.ndim < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"rmsnorm takes x (..., D) and w (D,), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _cuda.DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm takes x and w of one dtype in "
                        f"{list(_cuda.DTYPES)}, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")


def rmsnorm(x, w, *, eps: float = 1e-6):
    """``(x * rsqrt(mean(x^2, -1) + eps)) * w`` over the last axis."""
    _check_args(x, w)
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm's kernel takes contiguous x and w")
    out = torch.empty_like(x)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build().rmsnorm_launch(_cuda.DTYPES[x.dtype], x.data_ptr(),
                                 w.data_ptr(), out.data_ptr(), rows, D,
                                 float(eps), stream)
    _cuda.check(err, "rmsnorm")
    LAUNCHES["rmsnorm"] += 1
    return out
