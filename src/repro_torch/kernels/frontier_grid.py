"""Wrappers of the two CUDA frontier kernels (``csrc/frontier_grid.cu``).

:func:`frontier_grid` returns the survival-integral moments ``(mu, var)``
of the max completion time for each candidate row of W;
:func:`frontier_grid_with_grads` fuses them with their analytic adjoints in
W (``grad`` mode) and, with ``param_grads=True``, in mus, sigmas and
``extra`` row 0 (``pgrad`` mode). They replace the Pallas TPU kernels of
the JAX package's ``kernels/frontier_grid.py``; the derivation of the
adjoint is in that module's docstring and in ``kernels/ref.py`` here.

Every family of ``core.distributions.FAMILIES`` is a template instance of
each kernel: normal, lognormal, drift, empirical and defective (5 forward,
10 fused).

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs the kernel's plain version from ``kernels/ref.py``. Nothing else
selects the path. Both are split across the card by
``autotune.lookup_split`` (``csrc/frontier_grid.cu`` says how): the forward
moments in two launches per call (pass 1 over tiles of grid points, an
epilogue), the fused kernel in three. On the card num_t may be up to
``autotune.MAX_NUM_T``; the plain path takes any num_t >= 2.
The shared library is built with ``nvcc`` for ``sm_90a``
at the first launch by ``kernels/_cuda.py`` (importing this module needs
neither ``nvcc`` nor a card), and bound with ``ctypes``. ``LAUNCHES``
counts the wrappers' calls per mode (each call is two or three kernel
launches, ``autotune.split_blocks``); :func:`launch_fwd` and
:func:`launch_grad` launch a given library uncounted (``chip_smoke.py``
times a float32-sum build with them).
"""
from __future__ import annotations

import ctypes

import torch

from ..core import distributions as dists
from . import _cuda
from . import autotune
from . import ref

__all__ = ["frontier_grid", "frontier_grid_with_grads", "launch_fwd",
           "launch_grad", "LAUNCHES", "reset_launches", "build"]

# --fmad=false: no multiply-add contraction, so the kernels round every
# float32 operation as the plain version's tensor operations do
NVCC_FLAGS = _cuda.ARCH_FLAGS + ("--fmad=false",)

# calls of each kernel mode since the last reset_launches()
LAUNCHES = {"fwd": 0, "grad": 0, "pgrad": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(defines: tuple = ()) -> ctypes.CDLL:
    """Compile ``csrc/frontier_grid.cu`` (once per source content) and load
    it (``kernels/_cuda.py``). ``defines`` (``"NAME=value"`` strings) builds
    a variant beside it, such as ``("FG_ACC=float",)`` for float32 sums;
    the wrappers launch only the library of ``build()``."""
    return _cuda.build("frontier_grid", ("family.cuh",), flags=NVCC_FLAGS,
                       defines=defines, bind=_bind)


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fg_forward.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, cf, ci,
                               ci, vp, vp, ctypes.c_longlong, vp]
    lib.fg_forward.restype = ci
    lib.fg_grad.argtypes = [ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, cf, ci,
                            ci, ci, ci, ci, vp, vp, vp, ctypes.c_longlong,
                            vp]
    lib.fg_grad.restype = ci
    lib.fg_acc_bytes.argtypes = []
    lib.fg_acc_bytes.restype = ci
    # the scratch's element type: float64, or float32 in a -DFG_ACC=float
    # build
    lib.acc_dtype = (torch.float64 if lib.fg_acc_bytes() == 8
                     else torch.float32)


def _prepare(W, mus, sigmas, extra, dist_id: str, num_t: int):
    """Validate device, dtype, shapes and contiguity; returns contiguous
    float32 tensors and whether the statistics are per-row."""
    dists.extra_rows(dist_id)  # rejects an unknown family
    if W.ndim != 2:
        raise ValueError(f"W must be (F, K), got {tuple(W.shape)}")
    F, K = W.shape
    if F < 1 or K < 1:
        raise ValueError(f"W must have rows and channels, got {(F, K)}")
    if num_t < 2:
        raise ValueError(f"num_t must be >= 2, got {num_t}")
    per_row = mus.ndim == 2
    want_stat = (F, K) if per_row else (K,)
    E = dists.extra_rows(dist_id)
    want_ex = (E, F, K) if per_row else (E, K)
    if tuple(mus.shape) != want_stat or tuple(sigmas.shape) != want_stat:
        raise ValueError(f"mus/sigmas must be {want_stat}, got "
                         f"{tuple(mus.shape)} / {tuple(sigmas.shape)}")
    if tuple(extra.shape) != want_ex:
        raise ValueError(f"extra for {dist_id!r} must be {want_ex}, got "
                         f"{tuple(extra.shape)}")
    dev = W.device
    for name, x in (("mus", mus), ("sigmas", sigmas), ("extra", extra)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, W on {dev}")
    for name, x in (("W", W), ("mus", mus), ("sigmas", sigmas),
                    ("extra", extra)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    return (W.contiguous(), mus.contiguous(), sigmas.contiguous(),
            extra.contiguous(), per_row)


def frontier_grid(W, mus, sigmas, extra, *, num_t: int = 1024,
                  z: float = 10.0, dist_id: str = "normal"):
    """(mu, var), each (F,), for candidate splits W (F, K).

    ``mus``/``sigmas`` (K,) shared or (F, K) per-row; ``extra`` (E, K) or
    (E, F, K). The launch shapes come from ``kernels.autotune``.
    """
    W, mus, sigmas, extra, per_row = _prepare(W, mus, sigmas, extra, dist_id,
                                              num_t)
    if W.device.type == "cpu":
        return ref.frontier_grid_ref(W, mus, sigmas, num_t=num_t, z=z,
                                     dist_id=dist_id, extra=extra)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    out = launch_fwd(build(), W, mus, sigmas, extra, per_row, num_t=num_t,
                     z=z, dist_id=dist_id)
    LAUNCHES["fwd"] += 1
    return out


def launch_fwd(lib, W, mus, sigmas, extra, per_row: bool, *, num_t: int,
               z: float, dist_id: str):
    """One call of the forward kernel of ``lib`` (a :func:`build` library)
    on checked CUDA inputs: two launches (pass 1, epilogue) in the split of
    ``autotune.launch_plan``; not counted in ``LAUNCHES``."""
    F, K = W.shape
    th, split, n_scratch = autotune.launch_plan(F, K, num_t, "fwd", dist_id)
    dev = W.device
    stats = torch.empty((2, F), dtype=torch.float32, device=dev)
    scratch = torch.empty((n_scratch,), dtype=lib.acc_dtype, device=dev)
    err = lib.fg_forward(dists.DIST_IDS[dist_id], W.data_ptr(),
                         mus.data_ptr(), sigmas.data_ptr(), extra.data_ptr(),
                         int(per_row), F, K, num_t, float(z), th,
                         split.points, stats.data_ptr(), scratch.data_ptr(),
                         n_scratch,
                         torch._C._cuda_getCurrentRawStream(dev.index))
    _cuda.check(err, "frontier forward")
    return stats[0], stats[1]


def frontier_grid_with_grads(W, mus, sigmas, extra, *, num_t: int = 1024,
                             z: float = 10.0, dist_id: str = "normal",
                             param_grads: bool = False):
    """Fused ``(mu, var, dmu_dW, dvar_dW)``; with ``param_grads`` also
    ``(dmu_dmus, dvar_dmus, dmu_dsigmas, dvar_dsigmas, dmu_dex, dvar_dex)``,
    all (F, K) per row (``d*_dex``: extra row 0, zeros where the family has
    no differentiable shape parameter)."""
    W, mus, sigmas, extra, per_row = _prepare(W, mus, sigmas, extra, dist_id,
                                              num_t)
    if W.device.type == "cpu":
        return ref.frontier_grid_with_grads_ref(
            W, mus, sigmas, num_t=num_t, z=z, dist_id=dist_id, extra=extra,
            param_grads=param_grads)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    outs = launch_grad(build(), W, mus, sigmas, extra, per_row,
                       num_t=num_t, z=z, dist_id=dist_id,
                       param_grads=param_grads)
    LAUNCHES["pgrad" if param_grads else "grad"] += 1
    return outs


def launch_grad(lib, W, mus, sigmas, extra, per_row: bool, *, num_t: int,
                z: float, dist_id: str, param_grads: bool):
    """One call of the fused kernel of ``lib`` (a :func:`build` library) on
    checked CUDA inputs: three launches (pass 1, pass 2, epilogue) in the
    split of ``autotune.launch_plan``; not counted in ``LAUNCHES``."""
    mode = "pgrad" if param_grads else "grad"
    F, K = W.shape
    th, split, n_scratch = autotune.launch_plan(F, K, num_t, mode, dist_id)
    dev = W.device
    # three allocations: mu and var, the adjoints, the scratch
    stats = torch.empty((2, F), dtype=torch.float32, device=dev)
    outs = torch.empty((8 if param_grads else 2, F, K), dtype=torch.float32,
                       device=dev)
    scratch = torch.empty((n_scratch,), dtype=lib.acc_dtype, device=dev)
    err = lib.fg_grad(dists.DIST_IDS[dist_id], int(param_grads),
                      W.data_ptr(), mus.data_ptr(), sigmas.data_ptr(),
                      extra.data_ptr(), int(per_row), F, K, num_t, float(z),
                      th, *split, stats.data_ptr(), outs.data_ptr(),
                      scratch.data_ptr(), n_scratch,
                      torch._C._cuda_getCurrentRawStream(dev.index))
    _cuda.check(err, f"frontier {mode}")
    return (*stats.unbind(0), *outs.unbind(0))
