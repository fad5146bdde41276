"""Wrapper of the CUDA flash-decode kernel (``csrc/attention.cu``).

:func:`flash_decode` attends one query group per kv head over a KV cache
with an ``(S,)`` validity mask, in one pass with online softmax and the
probabilities in float32. It replaces the Pallas TPU kernel of the JAX
package's ``kernels/flash_decode.py``; unlike that wrapper it takes any
cache length S (the kernel masks the ragged last tile itself), such as the
``prompt + max_new`` caches of ``serve.ServeEngine``.

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
the plain version, ``kernels/ref.decode_attention_ref``. The kernel takes
contiguous q, k, v and valid, and lives in the library of
``kernels/flash_attention.py``. ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from . import _cuda
from . import flash_attention as _fa
from . import ref

__all__ = ["flash_decode", "LAUNCHES", "reset_launches", "MAX_GROUP_WIDTH"]

MAX_GROUP_WIDTH = 1024   # G * D: the kernel's 128 threads x 8 outputs

# kernel launches since the last reset_launches()
LAUNCHES = {"flash_decode": 0}


def reset_launches() -> None:
    LAUNCHES["flash_decode"] = 0


def _check_args(q, k, v, valid):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode takes q (B, Hkv, G, D) and k, v "
                         f"(B, Hkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (q.shape[0], q.shape[1], q.shape[3]) != (k.shape[0], k.shape[1],
                                                k.shape[3]):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} need "
                         f"one B, Hkv and D")
    if valid.dtype != torch.bool or tuple(valid.shape) != (k.shape[2],):
        raise ValueError(f"valid must be a bool ({k.shape[2]},) mask, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if q.dtype not in _cuda.DTYPES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k and v must share one dtype in "
                        f"{list(_cuda.DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(t.device != q.device for t in (k, v, valid)):
        raise ValueError("q, k, v and valid must lie on one device")


def flash_decode(q, k, v, valid, *, sm_scale=None):
    """q: (B, Hkv, G, D); k, v: (B, Hkv, S, D); valid: (S,) bool ->
    (B, Hkv, G, D) in q's dtype. A group with no valid slot gives 0."""
    _check_args(q, k, v, valid)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, Hkv, G, D = q.shape
    S = k.shape[2]
    if G * D > MAX_GROUP_WIDTH:
        raise ValueError(f"the kernel takes G * D <= {MAX_GROUP_WIDTH}, got "
                         f"{G} * {D}")
    if not all(t.is_contiguous() for t in (q, k, v, valid)):
        raise ValueError("the kernel takes contiguous q, k, v and valid")
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fa.build().flash_decode_launch(
        _cuda.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        valid.data_ptr(), out.data_ptr(), B, Hkv, G, S, D, float(scale),
        stream)
    _cuda.check(err, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out
