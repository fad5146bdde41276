"""Split optimizers: choose the work partition across uncertain channels.

* :func:`optimize_2ch` — the paper's procedure for two channels: a dense
  f-grid, the efficient frontier, a scalarized pick.
* :func:`optimize_weights` — K-channel projected gradient descent on
  ``mu(w) + lam var(w)``; every step is one fused moments-and-gradient
  launch (``ops.frontier_moments_with_grads``) over all starts at once.
* Baselines: :func:`equal_split` and :func:`inverse_mu_split`.

Under ``REPRO_SANITIZE=1`` a solve checks its inputs once before the PGD
loop and the loop's gradients and iterates on the device at every step,
read once after the loop (``analysis/sanitize.py``): two host reads a
solve, none a step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..analysis import sanitize as _san
from ..device import resolve_device
from ..kernels import ops
from .distributions import remaining_work_stats, resolve_family
from .frontier import frontier_2ch, select_on_frontier
from .maxstat import clark_max_moments_seq, max_moments_quad_w

__all__ = ["PartitionDecision", "equal_split", "inverse_mu_split",
           "optimize_2ch", "optimize_weights", "objective",
           "predict_moments"]


@dataclass(frozen=True)
class PartitionDecision:
    """The chosen split plus its predicted joint moments."""

    weights: np.ndarray
    mu: float
    var: float
    method: str

    def speedup_vs(self, other: "PartitionDecision") -> float:
        return float(other.mu / max(self.mu, 1e-12))


def equal_split(k: int, device="cuda") -> torch.Tensor:
    """Map-reduce baseline: equal shares."""
    return torch.full((k,), 1.0 / k, dtype=torch.float32,
                      device=resolve_device(device))


def inverse_mu_split(mus, device="cuda") -> torch.Tensor:
    """w_i proportional to 1 / mu_i: equal expected finish times."""
    inv = 1.0 / torch.as_tensor(mus, dtype=torch.float32,
                                device=resolve_device(device))
    return inv / torch.sum(inv)


def objective(w, mus, sigmas, lam: float, num_t: int = 1024,
              family="normal", device="cuda"):
    """``mu + lam var`` at one split; differentiable through the analytic
    adjoints of ``frontier_moments``."""
    w = torch.as_tensor(w, dtype=torch.float32, device=resolve_device(device))
    mu, var = ops.frontier_moments(w[None, :], mus, sigmas, num_t=num_t,
                                   device=device, family=family)
    return (mu + lam * var)[0]


def optimize_2ch(mu_i, sigma_i, mu_j, sigma_j, lam: float = 0.0,
                 num_f: int = 401, num_t: int = 2048, family="normal",
                 device="cuda") -> PartitionDecision:
    """The paper's two-channel procedure: dense f-grid, frontier, pick."""
    res = frontier_2ch(mu_i, sigma_i, mu_j, sigma_j, num_f=num_f,
                       num_t=num_t, family=family, device=device)
    _, (f, mu, var) = select_on_frontier(res, lam=lam)
    w = np.asarray([f, 1.0 - f], dtype=np.float64)
    return PartitionDecision(weights=w, mu=float(mu), var=float(var),
                             method="grid-2ch")


# (1..k as v's dtype, 0..k-1) per (k, dtype, device): the projection runs
# once per PGD step, and on the card each arange is a launch
_RANKS: dict = {}


def _ranks(k: int, dtype, device):
    key = (k, dtype, device)
    if key not in _RANKS:
        _RANKS[key] = (torch.arange(1, k + 1, dtype=dtype, device=device),
                       torch.arange(k, device=device))
    return _RANKS[key]


def _project_simplex(v: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of each row of v onto the probability simplex
    (Held et al.): theta = (sum of the rho + 1 largest - 1) / (rho + 1) for
    the last rank rho where the sorted value exceeds its running term.
    Written in ten tensor operations (the projection runs once per PGD
    step, and on the card the host's launch path sets a step's pace): the
    running terms q_j = (cumsum_j - 1) / j are formed once, u > q stands for
    u - q > 0 (a float difference is zero only for equal operands) and theta
    is gathered from q. Rank 0 always qualifies for a finite row, so ranks
    that do not are filled with 0: a row holding a NaN (all ranks fail)
    then projects to NaN, which the sanitizer's in-loop check reports,
    instead of gathering at -1 (a device-side assert on the card)."""
    k = v.shape[-1]
    u = torch.sort(v, dim=-1, descending=True).values
    idx, pos = _ranks(k, v.dtype, v.device)
    q = torch.cumsum(u, dim=-1).sub_(1.0).div_(idx)
    cond = u > q
    rho = torch.amax(torch.where(cond, pos.expand_as(cond), 0), dim=-1,
                     keepdim=True)
    theta = torch.gather(q, -1, rho)
    return (v - theta).clamp_min_(0.0)


def _pgd_multi(W0, mus, sigmas, extra, lam: float, steps: int, num_t: int,
               lr: float = 0.05, dist_id: str = "normal", device="cuda",
               checks: Optional[_san.LoopChecks] = None):
    """All starts as one batched PGD: each step is one fused
    moments-and-gradient launch over the (S, K) iterate stack, the gradient
    row-normalized, a cosine step size, a simplex projection. The caller
    checked the inputs; ``checks`` (the sanitizer's) records the
    gradient's finiteness and the iterate's simplex invariant at every
    step, on the device."""
    lam32 = float(np.float32(lam))
    W = W0
    for i in range(steps):
        _, _, dmu, dvar = ops.frontier_moments_with_grads(
            W, mus, sigmas, num_t=num_t, device=device,
            family=(dist_id, extra), _check=False)
        # in place on the step's own outputs: the same operations, fewer
        # allocations on the host's path
        g = dmu.add_(dvar.mul_(lam32))
        if checks is not None:
            checks.check_finite(g, "PGD gradient", i)
        g = g.div_(torch.linalg.norm(g, dim=-1, keepdim=True).add_(1e-12))
        ang = np.float32(math.pi) * np.float32(i) / np.float32(steps)
        step = np.float32(lr) * np.float32(0.5) * (np.float32(1.0)
                                                    + np.cos(ang))
        W = _project_simplex(W - g.mul_(float(step)))
        if checks is not None:
            checks.check_weight_rows(W, "PGD iterate", i)
    return W


def _dirichlet_starts(k: int, restarts: int,
                      rng: Optional[np.random.Generator]) -> np.ndarray:
    """``restarts`` random starts, Dirichlet(1) rows from ``rng``
    (``default_rng(0)`` when None)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    return rng.dirichlet(np.ones(k), size=restarts)


def optimize_weights(mus, sigmas, lam: float = 0.0, steps: int = 200,
                     num_t: int = 1024, restarts: int = 3,
                     rng: Optional[np.random.Generator] = None,
                     restart_starts=None,
                     warm_start: Optional[np.ndarray] = None,
                     family="normal", risk_lam: float = 0.0,
                     posterior=None, return_sensitivity: bool = False,
                     done=None, eval_num_t: Optional[int] = None,
                     device="cuda"):
    """K-channel simplex optimization by multi-start PGD.

    Starts: ``warm_start`` (if given), the equal split, the inverse-mu
    split, and ``restarts`` random rows — Dirichlet draws from ``rng``, or
    the rows of ``restart_starts`` when given. All starts descend together;
    the finalists are scored in one ``frontier_moments`` call at
    ``eval_num_t`` (default ``max(num_t, 2048)``).

    ``risk_lam > 0`` with a ``posterior`` (an ``NIGState``) adds
    ``risk_lam * fragility`` to the score (one extra full-parameter launch);
    ``return_sensitivity`` returns ``(decision, report)``; ``done`` re-solves
    the remaining work of a partly executed job (shares of the remainder).
    """
    dev = resolve_device(device)
    mus = torch.as_tensor(mus, dtype=torch.float32, device=dev)
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32, device=dev)
    k = mus.shape[0]
    dist_id, extra = resolve_family(family, k)
    extra = torch.as_tensor(extra, dtype=torch.float32, device=dev)
    if done is not None:
        mus_r, sigmas_r, extra_r, r = remaining_work_stats(
            dist_id, mus.cpu().numpy(), sigmas.cpu().numpy(),
            extra.cpu().numpy(), done)
        if r <= 0.0:
            return PartitionDecision(weights=np.zeros(k), mu=0.0, var=0.0,
                                     method="pgd-simplex-done")
        mus = torch.as_tensor(mus_r, dtype=torch.float32, device=dev)
        sigmas = torch.as_tensor(sigmas_r, dtype=torch.float32, device=dev)
        extra = torch.as_tensor(extra_r, dtype=torch.float32, device=dev)
    starts = [equal_split(k, dev), inverse_mu_split(mus, dev)]
    if warm_start is not None:
        ws = torch.as_tensor(warm_start, dtype=torch.float32, device=dev)
        starts.insert(0, torch.clamp_min(ws, 0.0)
                      / torch.clamp_min(torch.sum(ws), 1e-12))
    if restart_starts is None and restarts > 0:
        restart_starts = _dirichlet_starts(k, restarts, rng)
    if restart_starts is not None:
        rs = torch.tensor(np.asarray(restart_starts), dtype=torch.float32,
                          device=dev)
        starts += list(rs)
    W0 = torch.stack(starts)
    checks = None
    if _san.enabled():
        # the sanitizer: the inputs once here, the loop's steps on the
        # device, read once after it
        _san.check_frontier_inputs(W0, mus, sigmas, extra, dist_id=dist_id)
        checks = _san.LoopChecks(dev)
    Wf = _pgd_multi(W0, mus, sigmas, extra, lam, steps=steps, num_t=num_t,
                    dist_id=dist_id, device=dev, checks=checks)
    if checks is not None:
        checks.raise_first()
    et = eval_num_t if eval_num_t is not None else max(num_t, 2048)
    mu_c, var_c = ops.frontier_moments(Wf, mus, sigmas, num_t=et,
                                       device=dev, family=(dist_id, extra),
                                       _check=False)
    mu_c, var_c = mu_c.cpu().numpy(), var_c.cpu().numpy()
    score = mu_c + lam * var_c
    method = "pgd-simplex"
    if risk_lam > 0.0 and posterior is not None:
        from .sensitivity import fragility_batch  # lazy: import cycle

        frag = fragility_batch(Wf, mus, sigmas, posterior,
                               family=(dist_id, extra), num_t=num_t,
                               device=dev)
        score = score + risk_lam * frag
        method = "pgd-simplex-risk"
    bi = int(np.argmin(score))
    decision = PartitionDecision(
        weights=Wf[bi].cpu().numpy().astype(np.float64),
        mu=float(mu_c[bi]), var=float(var_c[bi]), method=method)
    if not return_sensitivity:
        return decision
    from .sensitivity import moment_sensitivity, posterior_sensitivity

    sens = moment_sensitivity(decision.weights, mus, sigmas,
                              family=(dist_id, extra), num_t=num_t,
                              device=dev)
    report = (posterior_sensitivity(sens, posterior)
              if posterior is not None else sens)
    return decision, report


def predict_moments(w, mus, sigmas, exact: bool = True, num_t: int = 2048,
                    family="normal", device="cuda") -> Tuple[float, float]:
    """Predicted (mu, var) for a split: the quadrature oracle, or the Clark
    fold when ``exact`` is False and the family is normal."""
    fam_id = resolve_family(family, np.shape(w)[-1])[0]
    if exact or fam_id != "normal":
        mu, var = max_moments_quad_w(w, mus, sigmas, num=num_t,
                                     family=family, device=device)
    else:
        dev = resolve_device(device)
        w = torch.as_tensor(w, dtype=torch.float32, device=dev)
        mu, var = clark_max_moments_seq(
            w * torch.as_tensor(mus, dtype=torch.float32, device=dev),
            w * torch.as_tensor(sigmas, dtype=torch.float32, device=dev),
            device=dev)
    return float(mu), float(var)
