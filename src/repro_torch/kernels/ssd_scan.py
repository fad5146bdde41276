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

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
the plain version, ``kernels/ref.ssd_chunked_ref``. x, Bm and Cm share one
dtype (float32 or bf16) and may be strided views with a unit stride on
their last axis (the model's B and C are column slices of one projection);
dt, A and D are float32. The library is built at the first launch
(``kernels/_cuda.py``). ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from . import ref

__all__ = ["ssd_scan", "build", "LAUNCHES", "reset_launches"]

# kernel launches since the last reset_launches()
LAUNCHES = {"ssd_scan": 0}


def reset_launches() -> None:
    LAUNCHES["ssd_scan"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = [ci] + [vp] * 8 + [ci] * 7 + [cll] * 11 \
        + [vp]
    lib.ssd_scan_launch.restype = ci
    lib.ssd_scan_smem_bytes.argtypes = [ci, ci, ci]
    lib.ssd_scan_smem_bytes.restype = cll


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
    if x.dtype not in _cuda.DTYPES or not x.dtype == Bm.dtype == Cm.dtype:
        raise TypeError(f"x, Bm and Cm must share one dtype in "
                        f"{list(_cuda.DTYPES)}, got {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}")
    if not dt.dtype == A.dtype == D_skip.dtype == torch.float32:
        raise TypeError(f"dt, A and D must be float32, got {dt.dtype}, "
                        f"{A.dtype}, {D_skip.dtype}")
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
    _check_args(x, dt, A, Bm, Cm, D_skip)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D_skip, chunk=chunk,
                                   return_final_state=return_final_state)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    lib = build()
    smem = lib.ssd_scan_smem_bytes(L, P, N)
    optin = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    if smem > optin:
        raise ValueError(f"a chunk of {L} rows at P={P}, N={N} needs {smem} "
                         f"bytes of shared memory, the card gives a block "
                         f"{optin}")
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = (torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
             if return_final_state else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_launch(
        _cuda.DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), D_skip.data_ptr(), y.data_ptr(),
        state.data_ptr() if state is not None else None,
        B, S, H, P, G, N, L,
        *x.stride()[:3], *dt.stride()[:2], *Bm.stride()[:3],
        *Cm.stride()[:3], stream)
    _cuda.check(err, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return (y, state) if return_final_state else y
