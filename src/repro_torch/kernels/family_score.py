"""Wrapper of the CUDA kernel of online family selection
(``csrc/family_score.cu``).

:func:`family_score` scores the four candidate families of ``family="auto"``
(normal, lognormal, drift, a 3-component mixture) by BIC on (N, K) float64
windows of rates, work shares and validity masks on the card: two launches
(one block per channel, then one that sums the channels) and one copy back
of the BICs, the channel count, the drift regression's ``rho`` and the
fitted mixture. It replaces, on the card, the host numpy of
``core/bayes.py::score_families``, which stays its plain version (bitwise
the JAX package's, which also runs it on the host); the dispatch is
``score_families(..., device=...)``. The library is built with ``nvcc`` at
the first launch (``kernels/_cuda.py``; importing this module needs neither
``nvcc`` nor a card). ``LAUNCHES`` counts the wrapper's calls.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda

__all__ = ["family_score", "build", "LAUNCHES", "reset_launches",
           "MAX_WINDOW", "COMPONENTS", "FAMILY_ORDER"]

# --fmad=false: every operation rounds as the numpy's does
NVCC_FLAGS = _cuda.ARCH_FLAGS + ("--fmad=false",)

# calls since the last reset_launches() (two kernel launches each)
LAUNCHES = {"family_score": 0}

# the longest window the kernel takes (observations a channel), and the
# mixture's components (csrc/family_score.cu kMaxN, kC)
MAX_WINDOW = 4096
COMPONENTS = 3
# the BICs in the kernel's output, in this order
FAMILY_ORDER = ("normal", "lognormal", "drift", "empirical")
_HEAD = 8


def reset_launches() -> None:
    LAUNCHES["family_score"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.family_score_launch.argtypes = [ci, ci, vp, vp, vp, cd, cd, vp, vp,
                                        vp]
    lib.family_score_launch.restype = ci


def build() -> ctypes.CDLL:
    """The library of ``csrc/family_score.cu``, built on first use."""
    return _cuda.build("family_score", flags=NVCC_FLAGS, bind=_bind)


class Scores(NamedTuple):
    """One scoring pass as the kernel returns it, on the host."""

    bics: np.ndarray     # (4,) float64, FAMILY_ORDER
    n_channels: int      # channels with at least min_obs observations
    rho: np.ndarray      # (K,) float64
    gmm: tuple           # (weights, means, stds), each (C, K) float32


def family_score(rates: torch.Tensor, works: torch.Tensor,
                 mask: torch.Tensor, min_obs: float,
                 max_rho: float) -> Scores:
    """Score the four families on float64 CUDA windows (N, K): two kernel
    launches and one host read."""
    if not (rates.is_cuda and works.is_cuda and mask.is_cuda):
        raise ValueError("family_score launches the CUDA kernel and takes "
                         "CUDA tensors; the plain version is "
                         "core.bayes.score_families on the host")
    if (rates.ndim != 2 or works.shape != rates.shape
            or mask.shape != rates.shape
            or any(t.dtype != torch.float64 for t in (rates, works, mask))
            or works.device != rates.device or mask.device != rates.device):
        raise ValueError(f"family_score takes float64 rates, works and mask "
                         f"(N, K) on one device, got {tuple(rates.shape)}, "
                         f"{tuple(works.shape)}, {tuple(mask.shape)}")
    N, K = rates.shape
    if N > MAX_WINDOW:
        raise ValueError(f"family_score takes windows of up to {MAX_WINDOW} "
                         f"observations, got {N}")
    rates, works, mask = (t.contiguous() for t in (rates, works, mask))
    dev = rates.device
    out = torch.empty((_HEAD + (1 + 3 * COMPONENTS) * K,),
                      dtype=torch.float64, device=dev)
    scratch = torch.empty((6 * K,), dtype=torch.float64, device=dev)
    if N and K:
        err = build().family_score_launch(
            N, K, rates.data_ptr(), works.data_ptr(), mask.data_ptr(),
            float(min_obs), float(max_rho), scratch.data_ptr(),
            out.data_ptr(), torch._C._cuda_getCurrentRawStream(
                rates.get_device()))
        _cuda.check(err, "family_score")
        LAUNCHES["family_score"] += 1
    else:
        out.zero_()
    host = out.cpu().numpy()
    rho = host[_HEAD:_HEAD + K].copy()
    gmm = tuple(host[_HEAD + K + i * COMPONENTS * K:
                     _HEAD + K + (i + 1) * COMPONENTS * K]
                .reshape(COMPONENTS, K).astype(np.float32)
                for i in range(3))
    return Scores(bics=host[:4].copy(), n_channels=int(host[4]), rho=rho,
                  gmm=gmm)
