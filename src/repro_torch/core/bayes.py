"""On-the-fly estimation of channel statistics.

Per-channel Normal-Inverse-Gamma posteriors (Murphy 2007) over the
*normalized rate* ``t / w`` a channel shows for work share ``w``:

    mu, sigma^2 ~ NIG(m, kappa, alpha, beta),  t / w | mu, sigma^2 ~ N(mu, sigma^2)

The NIG state is four float32 tensors of shape (K,) on the caller's device;
the updates are elementwise tensor arithmetic over the whole fleet.
:func:`nig_estimate_ses` gives the standard errors of the point estimates
the solver consumes (what ``core.sensitivity`` prices), and
:func:`score_families` selects the completion-time family online by BIC over
the observed (rate, work) history, in float64 numpy on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["NIGState", "nig_init", "nig_update", "nig_update_batch",
           "nig_point_estimates", "nig_estimate_ses",
           "FamilyScores", "score_families", "fit_selected_family",
           "AUTO_FAMILIES"]


class NIGState(NamedTuple):
    """Per-channel Normal-Inverse-Gamma posterior parameters, each (K,)."""

    m: torch.Tensor      # posterior mean location
    kappa: torch.Tensor  # pseudo-observations on the mean
    alpha: torch.Tensor  # inverse-gamma shape
    beta: torch.Tensor   # inverse-gamma scale


def nig_init(k: int, m0: float = 1.0, kappa0: float = 1e-3,
             alpha0: float = 1.5, beta0: float = 0.5,
             device="cuda") -> NIGState:
    """Weak prior: ``alpha0 > 1`` so E[sigma^2] exists from the first
    update, and a small ``kappa0`` lets the first observation set the
    location."""
    ones = torch.ones((k,), dtype=torch.float32,
                      device=resolve_device(device))
    return NIGState(m=ones * m0, kappa=ones * kappa0, alpha=ones * alpha0,
                    beta=ones * beta0)


def nig_update(state: NIGState, channel: int, rate: float) -> NIGState:
    """One observation ``rate`` (time / work share) for one channel."""
    onehot = torch.zeros_like(state.m)
    onehot[int(channel)] = 1.0
    rate = torch.as_tensor(rate, dtype=state.m.dtype, device=state.m.device)
    kappa_n = state.kappa + onehot
    m_n = (state.kappa * state.m + onehot * rate) / kappa_n
    alpha_n = state.alpha + 0.5 * onehot
    beta_n = state.beta + 0.5 * onehot * (state.kappa / kappa_n) \
        * (rate - state.m) ** 2
    return NIGState(m=m_n, kappa=kappa_n, alpha=alpha_n, beta=beta_n)


def nig_update_batch(state: NIGState, rates, mask) -> NIGState:
    """Every channel at once: ``rates`` (K,) normalized rates, ``mask`` (K,)
    1.0 where a channel reported this round."""
    rates = torch.as_tensor(rates, dtype=state.m.dtype, device=state.m.device)
    mask = torch.as_tensor(mask, dtype=state.m.dtype, device=state.m.device)
    kappa_n = state.kappa + mask
    m_n = (state.kappa * state.m + mask * rates) / kappa_n
    alpha_n = state.alpha + 0.5 * mask
    beta_n = state.beta + 0.5 * mask * (state.kappa / kappa_n) \
        * (rates - state.m) ** 2
    return NIGState(m=m_n, kappa=kappa_n, alpha=alpha_n, beta=beta_n)


def nig_point_estimates(state: NIGState):
    """``(mu_hat, sigma_hat)``: the posterior mean of mu, and
    ``sigma_hat^2 = E[sigma^2] (1 + 1/kappa)`` with
    ``E[sigma^2] = beta / (alpha - 1)`` (finite for alpha > 1)."""
    ev = state.beta / torch.clamp_min(state.alpha - 1.0, 1e-3)
    sigma2 = ev * (1.0 + 1.0 / torch.clamp_min(state.kappa, 1e-6))
    return state.m, torch.sqrt(sigma2)


def nig_estimate_ses(state: NIGState):
    """Standard errors ``(se_mu, se_sigma)`` of the point estimates.

    ``se_mu`` is the sd of the Student-t marginal of mu,
    ``sqrt(beta / ((alpha - 1) kappa))``; ``se_sigma`` the delta-method sd
    of ``sigma_hat`` from the inverse-gamma posterior of sigma^2 (with the
    same ``1 + 1/kappa`` factor as the estimate), capped at ``sigma_hat``
    where alpha <= 2 leaves that variance infinite.
    """
    am1 = torch.clamp_min(state.alpha - 1.0, 1e-3)
    kap = torch.clamp_min(state.kappa, 1e-6)
    se_mu = torch.sqrt(state.beta / (am1 * kap))
    _, sigma_hat = nig_point_estimates(state)
    sd_sig2 = ((1.0 + 1.0 / kap) * state.beta
               / (am1 * torch.sqrt(torch.clamp_min(state.alpha - 2.0, 1e-3))))
    se_sigma = torch.minimum(sd_sig2 / torch.clamp_min(2.0 * sigma_hat, 1e-12),
                             sigma_hat)
    return se_mu, se_sigma


# --------------------------------------------------------------------------
# online family selection: BIC over the observed (rate, work) history
# --------------------------------------------------------------------------

AUTO_FAMILIES = ("normal", "lognormal", "drift", "empirical")

# free parameters per channel for the BIC penalty k ln(n)
_FAMILY_DOF = {"normal": 2.0, "lognormal": 2.0, "drift": 3.0}
_LOG_2PI = float(np.log(2.0 * np.pi))


@dataclass(frozen=True)
class FamilyScores:
    """One BIC scoring pass: ``bics`` (family -> total BIC, lower is
    better), the ``winner``, the channels scored, the drift regression's
    per-channel ``rho`` and the fitted ``gmm`` ``(weights, means, stds)``,
    each (C, K)."""

    bics: Dict[str, float]
    winner: str
    n_channels: int
    rho: np.ndarray
    gmm: tuple


def _masked_moments(x: np.ndarray, mask: np.ndarray):
    """Per-channel (n, mean, var) of ``x`` (N, K) under ``mask`` (N, K)."""
    n = mask.sum(axis=0)
    safe_n = np.maximum(n, 1.0)
    mean = (x * mask).sum(axis=0) / safe_n
    var = (((x - mean) ** 2) * mask).sum(axis=0) / safe_n
    return n, mean, var


def _gauss_loglik(n: np.ndarray, var: np.ndarray, floor: np.ndarray):
    """ln L of per-channel Gaussian MLE fits: -n/2 (ln 2 pi var + 1)."""
    v = np.maximum(var, floor)
    return -0.5 * n * (_LOG_2PI + np.log(v) + 1.0)


def _em_batch(x: np.ndarray, mask: np.ndarray, C: int = 3, iters: int = 16,
              var_floor_frac: float = 1e-3):
    """Per-channel 1-D Gaussian-mixture EM over (N, K) arrays under a
    sample mask: quantile init, a fixed iteration count, floored variances,
    no RNG. The E-step runs in float32 and the log-likelihood accumulates in
    float64. Returns ``(W, M, S, loglik)``: mixtures (C, K), ln L (K,)."""
    x = np.asarray(x, np.float32)
    N, K = x.shape
    m = mask.astype(np.float32)
    n_valid = m.sum(axis=0)
    has_data = n_valid >= 1.0
    n = np.maximum(n_valid, 1.0).astype(np.float32)
    _, mean, var = _masked_moments(x, m)
    spread = np.maximum(np.sqrt(var), np.maximum(np.abs(mean) * 1e-6, 1e-12))
    # idle channels get a unit-variance placeholder: no -inf/NaN leaves the
    # E-step, their log-likelihood is 0 and the caller substitutes for them
    floor = np.where(has_data, (var_floor_frac * spread) ** 2,
                     1.0).astype(np.float32)
    xs = np.where(m > 0, x, np.inf)
    xs = np.sort(xs, axis=0)
    qidx = ((np.arange(C)[:, None] + 0.5) / C * n[None, :]).astype(np.int64)
    qidx = np.minimum(qidx, np.maximum(n.astype(np.int64) - 1, 0))
    mus = np.take_along_axis(xs, qidx, axis=0)
    mus = np.where(np.isfinite(mus), mus, 0.0).astype(np.float32)
    vars_ = np.maximum(np.broadcast_to(var / C, (C, K)), floor
                       ).astype(np.float32)
    pis = np.full((C, K), 1.0 / C, np.float32)
    ll = np.zeros(K)
    for _ in range(iters):
        logp = (-0.5 * (x[None] - mus[:, None]) ** 2 / vars_[:, None]
                - 0.5 * np.log(2 * np.pi * vars_[:, None])
                + np.log(np.maximum(pis[:, None], 1e-30)))
        mx = logp.max(axis=0)
        r = np.exp(logp - mx)
        tot = np.maximum(r.sum(axis=0), 1e-30)
        # select, then sum: a masked sample's -inf/NaN must not reach ln L
        ll = np.where(m > 0, (mx + np.log(tot)).astype(np.float64),
                      0.0).sum(axis=0)
        r = r / tot * m[None]
        nk = np.maximum(r.sum(axis=1), 1e-12)
        mus = (r * x[None]).sum(axis=1) / nk
        vars_ = np.maximum((r * x[None] ** 2).sum(axis=1) / nk - mus ** 2,
                           floor)
        pis = nk / n[None, :]
    order = np.argsort(mus, axis=0)

    def take(a):
        return np.take_along_axis(a, order, axis=0)

    return take(pis), take(mus), np.sqrt(take(vars_)), ll


def score_families(rates: np.ndarray, works: np.ndarray, mask: np.ndarray,
                   min_obs: int = 8, max_rho: float = 8.0,
                   families=AUTO_FAMILIES) -> Optional[FamilyScores]:
    """BIC-score the candidate families on (N, K) windows of rates, the
    work shares they were observed under, and validity masks.

    normal (k = 2), lognormal on log rates with the Jacobian term (k = 2),
    drift as the regression ``rate = a + b w`` with ``rho = 2 b / a``
    (k = 3), and a 3-component mixture (k = 8); BIC = k ln n - 2 ln L
    summed over channels with at least ``min_obs`` observations. None when
    no channel has enough history yet.
    """
    rates = np.asarray(rates, np.float64)
    works = np.asarray(works, np.float64)
    mask = np.asarray(mask, np.float64)
    n_all = mask.sum(axis=0)
    ok = n_all >= min_obs
    if not ok.any():
        return None
    m = mask * ok[None, :]
    n, mean, var = _masked_moments(rates, m)
    spread2 = np.maximum(var, (np.abs(mean) * 1e-6 + 1e-12) ** 2)
    floor = spread2 * 1e-8
    logn = np.log(np.maximum(n, 2.0))
    bics: Dict[str, float] = {}

    def total(k_dof, ll):
        return float(((k_dof * logn - 2.0 * ll) * ok).sum())

    if "normal" in families:
        bics["normal"] = total(_FAMILY_DOF["normal"],
                               _gauss_loglik(n, var, floor))

    if "lognormal" in families:
        pos = rates > 0
        logs = np.log(np.where(pos, rates, 1.0))
        m_ln = m * pos
        n_ln, _, var_ln = _masked_moments(logs, m_ln)
        # the floor is log-space (scale-free); a nonpositive rate is
        # impossible under a lognormal and costs a fixed deficit
        floor_ln = np.full_like(var_ln, 1e-10)
        jac = (-logs * m_ln).sum(axis=0)
        ll_ln = (_gauss_loglik(n_ln, var_ln, floor_ln) + jac
                 - 1e3 * np.maximum(n - n_ln, 0.0))
        bics["lognormal"] = total(_FAMILY_DOF["lognormal"], ll_ln)

    rho_hat = np.zeros(rates.shape[1])
    if "drift" in families:
        # least squares rate = a + b w; a negative slope refits as b = 0
        nw = n
        sw = (works * m).sum(axis=0)
        sww = (works * works * m).sum(axis=0)
        sr = (rates * m).sum(axis=0)
        swr = (works * rates * m).sum(axis=0)
        det = nw * sww - sw * sw
        det_ok = det > 1e-12 * np.maximum(nw * sww, 1e-300)
        safe_det = np.where(det_ok, det, 1.0)
        b = np.where(det_ok, (nw * swr - sw * sr) / safe_det, 0.0)
        b = np.maximum(b, 0.0)
        a = np.where(nw > 0, (sr - b * sw) / np.maximum(nw, 1.0), 1.0)
        resid = rates - (a[None, :] + b[None, :] * works)
        var_d = ((resid ** 2) * m).sum(axis=0) / np.maximum(nw, 1.0)
        rho_hat = np.clip(np.where(a > 1e-12, 2.0 * b / np.maximum(a, 1e-12),
                                   0.0), 0.0, max_rho)
        bics["drift"] = total(_FAMILY_DOF["drift"],
                              _gauss_loglik(nw, var_d, floor))

    gmm = None
    if "empirical" in families:
        from .distributions import EMP_COMPONENTS
        Wg, Mg, Sg, ll_g = _em_batch(rates, m, C=EMP_COMPONENTS)
        # channels below min_obs get one pooled-fleet component, so an idle
        # channel never looks like a point mass at 0 to the solver
        if not ok.all():
            pool_n = max(float((mask * ok[None, :]).sum()), 1.0)
            pool_mean = float((rates * mask * ok[None, :]).sum() / pool_n)
            pool_var = float((((rates - pool_mean) ** 2) * mask
                              * ok[None, :]).sum() / pool_n)
            pool_sd = max(np.sqrt(pool_var), abs(pool_mean) * 1e-3, 1e-6)
            bad = ~ok
            Wg[:, bad] = np.array([[1.0]] + [[0.0]] * (EMP_COMPONENTS - 1))
            Mg[:, bad] = pool_mean
            Sg[:, bad] = pool_sd
        gmm = (Wg, Mg, Sg)
        k_gmm = 3.0 * EMP_COMPONENTS - 1.0
        bics["empirical"] = total(k_gmm, ll_g)

    winner = min(bics, key=bics.get)
    return FamilyScores(bics=bics, winner=winner, n_channels=int(ok.sum()),
                        rho=rho_hat, gmm=gmm)


def fit_selected_family(scores: FamilyScores, winner: Optional[str] = None):
    """The ChannelFamily a scoring pass selected, from its fitted
    parameters (no refit)."""
    from .distributions import Drift, Empirical, get_family

    name = winner or scores.winner
    if name == "drift":
        return Drift(np.asarray(scores.rho, np.float32))
    if name == "empirical":
        Wg, Mg, Sg = scores.gmm
        return Empirical(Wg, Mg, Sg)
    return get_family(name)
