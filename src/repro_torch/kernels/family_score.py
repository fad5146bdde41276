"""Wrapper of the CUDA kernel of online family selection
(``csrc/family_score.cu``).

:func:`family_score` scores the four candidate families of ``family="auto"``
(normal, lognormal, drift, a 3-component mixture) by BIC on (N, K) float64
windows of rates, work shares and validity masks on the card: two launches
(one warp per channel, :func:`launch_plan`'s channels a block, then one
block that sums the channels) and one copy back
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

__all__ = ["family_score", "build", "launch_plan", "channel_bytes",
           "window_of", "LAUNCHES", "reset_launches", "MAX_WINDOW", "COMPONENTS",
           "FAMILY_ORDER", "SMEM_MAX"]

# --fmad=false: every operation rounds as the numpy's does
NVCC_FLAGS = _cuda.ARCH_FLAGS + ("--fmad=false",)

# calls since the last reset_launches() (two kernel launches each)
LAUNCHES = {"family_score": 0}

# the longest window the kernel takes (observations a channel), the
# mixture's components, the channels a block at most, and the dynamic
# shared memory a block may opt into on the H100 (csrc/family_score.cu
# kMaxN, kC, kWarps, kSmemMax)
MAX_WINDOW = 4096
COMPONENTS = 3
MAX_CHANNELS_A_BLOCK = 8
SMEM_MAX = 232448
# the BICs in the kernel's output, in this order
FAMILY_ORDER = ("normal", "lognormal", "drift", "empirical")
_HEAD = 8


def reset_launches() -> None:
    LAUNCHES["family_score"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.family_score_launch.argtypes = [ci, ci, ci, vp, vp, vp, cd, cd, vp,
                                        vp, vp]
    lib.family_score_launch.restype = ci


def build() -> ctypes.CDLL:
    """The library of ``csrc/family_score.cu``, built on first use."""
    return _cuda.build("family_score", flags=NVCC_FLAGS, bind=_bind)


def window_of(N: int):
    """``(D, P, W, X, total)``: one channel's window in shared memory, in
    floats (csrc/family_score.cu Win): float64 rows D = 16 ceil(N / 16) + 1
    float64 apart and float32 rows P = 32 ceil(N / 32) + 1 floats apart
    (one sample of different rows in different banks); the dead float64
    rows, then the M-step's nine product rows, from 0; the works at W; the
    float32 rates and mask at X and X + P; ``total`` floats."""
    D = 16 * -(-N // 16) + 1
    P = 32 * -(-N // 32) + 1
    W = (max(9 * P, 8 * D) + 1) & ~1
    X = W + 2 * D
    return D, P, W, X, X + 2 * P


def channel_bytes(N: int) -> int:
    """Shared memory of one channel's window of N observations, whole
    float64 (csrc/family_score.cu channel_doubles)."""
    return 8 * ((window_of(N)[4] + 1) // 2)


def launch_plan(N: int, K: int):
    """``(channels a block, blocks, shared memory bytes a block)`` of the
    channel launch for windows (N, K): one warp a channel, as many channels
    a block as fit ``SMEM_MAX`` at :func:`channel_bytes` each, up to
    ``MAX_CHANNELS_A_BLOCK`` and no more than K; block b scores channels
    b c .. min(b c + c, K)."""
    per = channel_bytes(N)
    cpb = max(1, min(MAX_CHANNELS_A_BLOCK, SMEM_MAX // max(per, 1), K))
    return cpb, -(-K // cpb), cpb * per


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
        cpb = launch_plan(N, K)[0]
        err = build().family_score_launch(
            N, K, cpb, rates.data_ptr(), works.data_ptr(), mask.data_ptr(),
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
