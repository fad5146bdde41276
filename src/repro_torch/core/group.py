"""Choosing the *number* of channels (the paper's group-testing extension).

Splitting across more channels shrinks each share (means scale with w) but
the max over more fluctuating channels grows with K, and every extra
channel adds a join cost. Given a fleet of candidate channels
(mu_i, sigma_i) and an optional per-channel enlistment overhead, select the
subset to enlist.

Two stages, as in Dorfman/Mezard group testing: a cheap stage ranks the
channels by a scalar score; an exact stage solves each nested prefix of
that ranking with the full partitioner (``optimize_weights`` on
``device``) and keeps the best scalarized objective.
:func:`select_channels_exhaustive` searches every subset (small fleets
only) and is the oracle.

The family's per-channel ``extra`` is sliced by subset on the host, before
a solve moves it to the device. A one-channel subset is closed form under
the normal family and one quadrature (``predict_moments``) otherwise.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .distributions import defective_moments_np, resolve_family
from .partitioner import PartitionDecision, optimize_weights, predict_moments

__all__ = ["GroupChoice", "select_channels", "select_channels_exhaustive"]


def _expected_attempts(dist_id: str, extra, idx: np.ndarray) -> np.ndarray:
    """Per-channel expected attempt count of a candidate subset.

    The enlistment overhead (``join_cost``) is paid per ATTEMPT a channel
    makes: a defective channel with per-attempt failure probability p joins
    E[attempts] = 1/(1-p) times. Families without failure physics make
    exactly one attempt each, which reduces the objective to the classic
    ``join_cost * k``.
    """
    if dist_id != "defective":
        return np.ones(len(idx), np.float64)
    p = np.clip(np.asarray(extra[0], np.float64)[idx], 0.0, 1.0 - 1e-9)
    return 1.0 / (1.0 - p)


def _ranking_stats(mus: np.ndarray, sigmas: np.ndarray, dist_id: str,
                   extra) -> tuple:
    """Stats the ranking stage scores: under the defective family the
    retry-inflated per-unit ``(a, b)``, so the prefix order already prices
    failures; other families pass through."""
    if dist_id != "defective":
        return mus, sigmas
    return defective_moments_np(mus, sigmas,
                                np.asarray(extra[0], np.float64),
                                np.asarray(extra[1], np.float64))


@dataclass(frozen=True)
class GroupChoice:
    indices: np.ndarray          # selected channel ids (into the fleet arrays)
    decision: PartitionDecision  # split over the selected channels
    objective: float


# repro: allow[RPA001] family-agnostic ranking heuristic; the exact stage
# re-scores every prefix with the caller's family through optimize_weights
def _score(mus: np.ndarray, sigmas: np.ndarray) -> np.ndarray:
    """Cheap ranking: fast channels first, variance-penalized (1/mu is
    throughput, sigma/mu the relative jitter)."""
    return 1.0 / mus - 0.5 * sigmas / (mus * mus)


def _subset_decision(idx: np.ndarray, mus: np.ndarray, sigmas: np.ndarray,
                     dist_id: str, extra, lam: float, pgd_steps: int,
                     device) -> PartitionDecision:
    """Solve (or close-form) the split over one candidate subset, with the
    family's per-channel extras sliced alongside on the host."""
    sub_family = (dist_id, extra[:, idx])
    if len(idx) == 1:
        if dist_id == "normal":
            # the max over one normal channel IS the channel
            return PartitionDecision(weights=np.ones(1), mu=float(mus[idx[0]]),
                                     var=float(sigmas[idx[0]] ** 2),
                                     method="single")
        m, v = predict_moments(np.ones(1), mus[idx], sigmas[idx],
                               family=sub_family, device=device)
        return PartitionDecision(weights=np.ones(1), mu=m, var=v,
                                 method="single")
    return optimize_weights(mus[idx], sigmas[idx], lam=lam, steps=pgd_steps,
                            family=sub_family, device=device)


def _objective(dec: PartitionDecision, lam: float, join_cost: float,
               dist_id: str, extra, idx: np.ndarray) -> float:
    return float(dec.mu + lam * dec.var + join_cost * float(
        _expected_attempts(dist_id, extra, idx).sum()))


def select_channels(mus: Sequence[float], sigmas: Sequence[float],
                    lam: float = 0.0, join_cost: float = 0.0,
                    max_k: Optional[int] = None, pgd_steps: int = 120,
                    family="normal", device="cuda") -> GroupChoice:
    """Greedy nested-prefix selection of how many (and which) channels to
    use.

    ``join_cost`` is the per-channel overhead of joining outputs (the
    paper's "pieced together" step); it makes the objective non-monotone in
    K, so an interior K* exists. Under the defective family the selection
    is failure-aware: the ranking uses retry-inflated stats and the
    enlistment term charges expected attempts (``join_cost * sum
    1/(1-p_i)``). Each prefix of two or more channels is one
    ``optimize_weights`` solve on ``device``.
    """
    mus = np.asarray(mus, np.float64)
    sigmas = np.asarray(sigmas, np.float64)
    dist_id, extra = resolve_family(family, len(mus))
    extra = np.asarray(extra)
    order = np.argsort(-_score(*_ranking_stats(mus, sigmas, dist_id, extra)))
    max_k = max_k or len(mus)

    best: Optional[GroupChoice] = None
    for k in range(1, min(max_k, len(mus)) + 1):
        idx = np.asarray(order[:k])
        dec = _subset_decision(idx, mus, sigmas, dist_id, extra, lam,
                               pgd_steps, device)
        obj = _objective(dec, lam, join_cost, dist_id, extra, idx)
        if best is None or obj < best.objective:
            best = GroupChoice(indices=idx, decision=dec, objective=obj)
    assert best is not None
    return best


def select_channels_exhaustive(mus: Sequence[float], sigmas: Sequence[float],
                               lam: float = 0.0, join_cost: float = 0.0,
                               pgd_steps: int = 120, family="normal",
                               device="cuda") -> GroupChoice:
    """Oracle subset search: 2^n - 1 solves (small fleets only)."""
    mus = np.asarray(mus, np.float64)
    sigmas = np.asarray(sigmas, np.float64)
    dist_id, extra = resolve_family(family, len(mus))
    extra = np.asarray(extra)
    best: Optional[GroupChoice] = None
    for k in range(1, len(mus) + 1):
        for combo in itertools.combinations(range(len(mus)), k):
            idx = np.asarray(combo)
            dec = _subset_decision(idx, mus, sigmas, dist_id, extra, lam,
                                   pgd_steps, device)
            obj = _objective(dec, lam, join_cost, dist_id, extra, idx)
            if best is None or obj < best.objective:
                best = GroupChoice(indices=idx, decision=dec, objective=obj)
    assert best is not None
    return best
