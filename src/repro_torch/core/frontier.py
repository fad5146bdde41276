"""Efficient frontier over workflow splits (paper Figs 1 and 2).

For two channels the split is a scalar ``f`` (channel i gets f, channel j
gets 1 - f); for K channels a simplex weight vector. Every candidate batch
is evaluated in one ``kernels.ops.frontier_moments`` call, and the
Pareto-efficient subset in (mu, var) is extracted on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels import ops
from .maxstat import max_moments_quad_w

__all__ = ["FrontierResult", "moments_for_split", "simplex_candidates",
           "curve_2ch", "curve_weights", "pareto_mask", "frontier_2ch",
           "frontier_kch", "select_on_frontier"]


@dataclass(frozen=True)
class FrontierResult:
    """mu(f), sigma^2(f) samples plus the Pareto-efficient subset."""

    f: np.ndarray
    mu: np.ndarray
    var: np.ndarray
    efficient: np.ndarray

    @property
    def f_min_mu(self) -> float:
        return float(np.asarray(self.f)[int(np.argmin(self.mu))]
                     if np.ndim(self.f) == 1 else np.argmin(self.mu))

    @property
    def f_min_var(self) -> float:
        return float(np.asarray(self.f)[int(np.argmin(self.var))]
                     if np.ndim(self.f) == 1 else np.argmin(self.var))


def moments_for_split(w, mus, sigmas, num: int = 2048, family="normal",
                      device="cuda"):
    """(mu, var) of the joint completion time for one split (quadrature)."""
    return max_moments_quad_w(w, mus, sigmas, num=num, family=family,
                              device=device)


def curve_2ch(mu_i, sigma_i, mu_j, sigma_j, num_f: int = 201,
              num_t: int = 2048, family="normal", device="cuda"):
    """(f, mu, var) for f in [0, 1] with channel i taking f: one
    ``frontier_moments`` call over the (num_f, 2) batch."""
    fs = torch.linspace(0.0, 1.0, num_f, dtype=torch.float32)
    W = torch.stack([fs, 1.0 - fs], dim=1)
    mus = torch.tensor([mu_i, mu_j], dtype=torch.float32)
    sgs = torch.tensor([sigma_i, sigma_j], dtype=torch.float32)
    mu, var = ops.frontier_moments(W, mus, sgs, num_t=num_t, device=device,
                                   family=family)
    return fs.numpy(), mu, var


def curve_weights(W, mus, sigmas, num_t: int = 2048, family="normal",
                  device="cuda", block_rows: Optional[int] = None):
    """Batched (mu, var) over K-channel weight vectors W (F, K)."""
    return ops.frontier_moments(W, mus, sigmas, num_t=num_t, device=device,
                                block_rows=block_rows, family=family)


def pareto_mask(mu: np.ndarray, var: np.ndarray) -> np.ndarray:
    """Boolean mask of Pareto-efficient points (minimize both mu and var):
    sort by mu (var breaking ties), keep a point whose var beats the
    running minimum of every point before it."""
    mu = np.asarray(mu)
    var = np.asarray(var)
    order = np.lexsort((var, mu))
    v_sorted = var[order]
    prev_best = np.concatenate(([np.inf],
                                np.minimum.accumulate(v_sorted)[:-1]))
    eff = np.zeros(mu.shape[0], dtype=bool)
    eff[order] = v_sorted < prev_best - 1e-15
    return eff


def frontier_2ch(mu_i, sigma_i, mu_j, sigma_j, num_f: int = 201,
                 num_t: int = 2048, family="normal",
                 device="cuda") -> FrontierResult:
    """The paper's pipeline for two channels: curves plus the frontier."""
    fs, mu, var = curve_2ch(mu_i, sigma_i, mu_j, sigma_j, num_f=num_f,
                            num_t=num_t, family=family, device=device)
    mu, var = mu.cpu().numpy(), var.cpu().numpy()
    return FrontierResult(f=fs, mu=mu, var=var, efficient=pareto_mask(mu, var))


def _with_fixed(W: np.ndarray, fixed: np.ndarray) -> np.ndarray:
    """Append any ``fixed`` rows (vertices, centroid) missing from ``W``."""
    missing = [v for v in fixed
               if not (np.abs(W - v).sum(axis=1) < 1e-12).any()]
    return np.concatenate([W, np.stack(missing)], axis=0) if missing else W


def _triangular_grid(num_f: int) -> np.ndarray:
    """Structured 3-simplex grid with at least ``num_f`` points."""
    m = 1
    while (m + 1) * (m + 2) // 2 < num_f:
        m += 1
    pts = [(i / m, j / m, (m - i - j) / m)
           for i in range(m + 1) for j in range(m + 1 - i)]
    return np.asarray(pts, np.float64)


def simplex_candidates(k: int, num_f: int,
                       rng: Optional[np.random.Generator] = None
                       ) -> np.ndarray:
    """(F, k) candidate splits covering the simplex: a structured grid for
    k <= 3, else vertices, the centroid and ``num_f - k - 1`` rows of a
    scrambled Sobol sequence mapped to the simplex by exponential spacings
    (Dirichlet rows drawn from ``rng``, ``default_rng(0)`` when None, where
    scipy is absent)."""
    if k == 1:
        return np.ones((1, 1))
    fixed = np.concatenate([np.eye(k), np.full((1, k), 1.0 / k)], axis=0)
    if k == 2:
        fs = np.linspace(0.0, 1.0, max(num_f, 2))
        return _with_fixed(np.stack([fs, 1.0 - fs], axis=1), fixed)
    if k == 3:
        return _with_fixed(_triangular_grid(num_f), fixed)
    n_rand = max(num_f - fixed.shape[0], 0)
    if n_rand == 0:
        return fixed
    try:
        from scipy.stats import qmc

        # a power-of-2 draw keeps the Sobol balance; truncate after
        n_pow2 = 1 << (n_rand - 1).bit_length()
        u = qmc.Sobol(d=k, scramble=True, seed=0).random(n_pow2)[:n_rand]
        e = -np.log1p(-np.clip(u, 0.0, 1.0 - 1e-12))
        rand = e / e.sum(axis=1, keepdims=True)
    except ImportError:  # pragma: no cover - depends on environment
        rng = rng if rng is not None else np.random.default_rng(0)
        rand = rng.dirichlet(np.ones(k), size=n_rand)
    return np.concatenate([fixed, rand], axis=0)


def frontier_kch(mus, sigmas, num_f: int = 512, num_t: int = 1024,
                 lam: float = 0.0, rng: Optional[np.random.Generator] = None,
                 include_pgd: bool = True, pgd_steps: int = 120,
                 family="normal", device="cuda") -> FrontierResult:
    """K-channel efficient frontier: simplex candidates plus the PGD
    solution of the scalarized objective, evaluated in one launch."""
    mus = np.asarray(mus, np.float64)
    sigmas = np.asarray(sigmas, np.float64)
    k = mus.shape[0]
    W = simplex_candidates(k, num_f, rng=rng)
    if include_pgd and k > 1:
        from .partitioner import optimize_weights  # lazy: import cycle

        dec = optimize_weights(mus, sigmas, lam=lam, steps=pgd_steps,
                               num_t=num_t, restarts=0, family=family,
                               device=device)
        W = np.concatenate([W, dec.weights[None, :]], axis=0)
    mu, var = curve_weights(W, mus, sigmas, num_t=num_t, family=family,
                            device=device)
    mu, var = mu.cpu().numpy(), var.cpu().numpy()
    return FrontierResult(f=W, mu=mu, var=var, efficient=pareto_mask(mu, var))


def select_on_frontier(result: FrontierResult, lam: float = 0.0):
    """The efficient point minimizing mu + lam * var:
    ``(index, (f, mu, var))``."""
    idx_all = np.nonzero(result.efficient)[0]
    if idx_all.size == 0:
        idx_all = np.arange(result.mu.shape[0])
    score = result.mu[idx_all] + lam * result.var[idx_all]
    pick = idx_all[int(np.argmin(score))]
    return pick, (np.asarray(result.f)[pick], result.mu[pick],
                  result.var[pick])
