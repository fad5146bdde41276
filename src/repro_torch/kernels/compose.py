"""Wrapper of the CUDA kernel of the composed makespan and its reverse pass
(``csrc/compose.cu``).

:func:`compose_grads` returns, for each row of the stage moments ``smu``,
``svar`` (R, S), the loss ``mk_mu + lam mk_var`` of the makespan composed
over a ``StageDAG.structure`` and its cotangents in ``smu`` and ``svar``:
one launch where the eager composition and its autograd take ~1700 torch
operations a call at S = 32. The JAX package differentiates the same
composition inside its jitted solve; it has no Pallas kernel for it.

The dispatch is ``workflow/solve.py::_compose_grads``: a CUDA tensor comes
here and launches the kernel or raises; a CPU tensor runs the plain version
beside it, ``_compose_grads_plain`` (``compose_structure`` and
``torch.autograd.grad``). :func:`encode` turns a structure into the
kernel's int32 arrays on a device; the solve does that once, beside its
stage stacks (``workflow/solve.py::_Stacks``). The library is built with ``nvcc`` at the first launch (``kernels/_cuda.py``;
importing this module needs neither ``nvcc`` nor a card). ``LAUNCHES``
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda

__all__ = ["compose_grads", "encode", "encode_arrays", "build", "LAUNCHES",
           "reset_launches"]

# --fmad=false: every float32 operation rounds as the plain version's
# tensor operations do
NVCC_FLAGS = _cuda.ARCH_FLAGS + ("--fmad=false",)

# kernel launches since the last reset_launches()
LAUNCHES = {"compose_grads": 0}


def reset_launches() -> None:
    LAUNCHES["compose_grads"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.compose_grads_launch.argtypes = [ci, ci, vp, vp, vp, vp, ci, ci, vp,
                                         vp, cf, vp, vp, vp, vp, vp]
    lib.compose_grads_launch.restype = ci


def build() -> ctypes.CDLL:
    """The library of ``csrc/compose.cu``, built on first use."""
    return _cuda.build("compose", flags=NVCC_FLAGS, bind=_bind)


class Encoded(NamedTuple):
    """A structure as the kernel reads it: int32 tensors on one device."""

    topo: torch.Tensor       # (S,) topological order
    pred_off: torch.Tensor   # (S + 1,) CSR offsets of the predecessors
    pred_idx: torch.Tensor   # predecessor lists in fold order
    sinks: torch.Tensor      # (n_sinks,)
    n_steps: int             # Clark fold steps of one row


def encode_arrays(structure):
    """``(topo, pred_off, pred_idx, sinks, n_steps)`` of a
    ``StageDAG.structure`` as int32 numpy arrays: predecessor lists in the
    order ``_fold_max`` folds them, and the fold steps of one row (each
    join's predecessors less one, and the sinks' less one)."""
    topo, preds, sinks = structure
    off = np.zeros(len(preds) + 1, np.int32)
    off[1:] = np.cumsum([len(p) for p in preds])
    idx = np.asarray([u for p in preds for u in p], np.int32)
    steps = sum(len(p) - 1 for p in preds if len(p) > 1)
    if len(sinks) > 1:
        steps += len(sinks) - 1
    return (np.asarray(topo, np.int32), off, idx, np.asarray(sinks, np.int32),
            int(steps))


def encode(structure, device) -> Encoded:
    """The structure's arrays, uploaded to ``device``."""
    dev = torch.device(device)
    topo, off, idx, sinks, steps = encode_arrays(structure)
    # one padding entry: a structure without joins still has a buffer
    idx = np.concatenate([idx, np.zeros(1, np.int32)])
    return Encoded(*(torch.as_tensor(a, dtype=torch.int32, device=dev)
                     for a in (topo, off, idx, sinks)), steps)


def compose_grads(enc: Encoded, smu: torch.Tensor, svar: torch.Tensor,
                  lam32: float):
    """``(losses (R,), d/dsmu, d/dsvar)`` of ``mk_mu + lam32 mk_var`` over
    the structure ``enc`` (:func:`encode`, on the moments' device) for
    float32 CUDA tensors ``smu``, ``svar`` (R, S): one kernel launch."""
    if not (smu.is_cuda and svar.is_cuda):
        raise ValueError("compose_grads launches the CUDA kernel and takes "
                         "CUDA tensors; the plain version is "
                         "workflow.solve._compose_grads_plain")
    if (smu.dtype != torch.float32 or svar.dtype != torch.float32
            or smu.ndim != 2 or svar.shape != smu.shape
            or svar.device != smu.device):
        raise ValueError(f"compose_grads takes float32 smu and svar (R, S) "
                         f"on one device, got {smu.dtype} {tuple(smu.shape)} "
                         f"and {svar.dtype} {tuple(svar.shape)}")
    R, S = smu.shape
    if enc.topo.numel() != S or enc.topo.device != smu.device:
        raise ValueError(f"the structure has {enc.topo.numel()} stages on "
                         f"{enc.topo.device}, the moments {S} on "
                         f"{smu.device}")
    smu = smu.contiguous()
    svar = svar.contiguous()
    losses = torch.empty((R,), dtype=torch.float32, device=smu.device)
    g_mu = torch.empty_like(smu)
    g_var = torch.empty_like(smu)
    scratch = torch.empty(((2 * S + 2 * enc.n_steps) * R,),
                          dtype=torch.float32, device=smu.device)
    err = build().compose_grads_launch(
        R, S, enc.topo.data_ptr(), enc.pred_off.data_ptr(),
        enc.pred_idx.data_ptr(), enc.sinks.data_ptr(), int(enc.sinks.numel()),
        enc.n_steps, smu.data_ptr(), svar.data_ptr(), float(lam32),
        losses.data_ptr(), g_mu.data_ptr(), g_var.data_ptr(),
        scratch.data_ptr(),
        torch._C._cuda_getCurrentRawStream(smu.get_device()))
    _cuda.check(err, "compose_grads")
    LAUNCHES["compose_grads"] += 1
    return losses, g_mu, g_var
