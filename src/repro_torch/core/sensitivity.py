"""Posterior sensitivity: differentiate the solve through the learned
channel statistics.

1. :func:`moment_sensitivity` — ``d(mu, var)/d(mus, sigmas, extra row 0)``
   at a split, from one full-parameter (``pgrad``) launch of
   ``ops.frontier_moments_with_grads``.
2. :func:`posterior_sensitivity` — the same adjoints chained through the NIG
   posterior parameters ``(m, kappa, alpha, beta)`` of ``core.bayes``.
3. :func:`estimation_fragility` / :func:`fragility_batch` — the delta-method
   sd of the predicted mean under the posterior standard errors, the
   risk-adjusted objective's penalty and the adaptive refresh's yardstick.

Chain rule (``sigma_hat^2 = (beta / (alpha - 1)) (1 + 1/kappa)``):

    d sigma_hat/dkappa = -(beta/(alpha-1)) / kappa^2 / (2 sigma_hat)
    d sigma_hat/dalpha = -sigma_hat^2/(alpha-1)    / (2 sigma_hat)
    d sigma_hat/dbeta  =  sigma_hat^2/beta         / (2 sigma_hat)

The results are float64 numpy on the host; the launch is the device work.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..kernels import ops
from .bayes import NIGState, nig_estimate_ses

__all__ = ["MomentSensitivity", "PosteriorSensitivity", "moment_sensitivity",
           "posterior_sensitivity", "estimation_fragility",
           "fragility_batch"]


def _np64(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


@dataclass(frozen=True)
class MomentSensitivity:
    """Adjoints of the joint-completion moments at one split, each (K,);
    ``d*_dextra`` is the adjoint of ``extra`` row 0 (zeros for families
    without a differentiable shape parameter)."""

    weights: np.ndarray
    mu: float
    var: float
    dmu_dw: np.ndarray
    dvar_dw: np.ndarray
    dmu_dmus: np.ndarray
    dvar_dmus: np.ndarray
    dmu_dsigmas: np.ndarray
    dvar_dsigmas: np.ndarray
    dmu_dextra: np.ndarray
    dvar_dextra: np.ndarray


@dataclass(frozen=True)
class PosteriorSensitivity:
    """``d(moments)/d(m, kappa, alpha, beta)`` per channel plus the
    fragility (same time units as ``mu``)."""

    sens: MomentSensitivity
    dmu_dm: np.ndarray
    dmu_dkappa: np.ndarray
    dmu_dalpha: np.ndarray
    dmu_dbeta: np.ndarray
    dvar_dm: np.ndarray
    dvar_dkappa: np.ndarray
    dvar_dalpha: np.ndarray
    dvar_dbeta: np.ndarray
    fragility: float

    @property
    def relative_fragility(self) -> float:
        """Fragility as a fraction of the predicted mean."""
        return float(self.fragility / max(self.sens.mu, 1e-12))


def moment_sensitivity(w, mus, sigmas, family="normal", num_t: int = 1024,
                       z: float = 10.0, device="cuda") -> MomentSensitivity:
    """Full parameter adjoints of the solve at split ``w`` (one launch)."""
    w = _np64(w)
    outs = ops.frontier_moments_with_grads(
        w[None, :].astype(np.float32), mus, sigmas, num_t=num_t,
        device=device, z=z, family=family, param_grads=True)
    (mu, var, dw, dvw, dm, dvm, ds, dvs, de, dve) = (_np64(o) for o in outs)
    return MomentSensitivity(
        weights=w, mu=float(mu[0]), var=float(var[0]),
        dmu_dw=dw[0], dvar_dw=dvw[0], dmu_dmus=dm[0], dvar_dmus=dvm[0],
        dmu_dsigmas=ds[0], dvar_dsigmas=dvs[0],
        dmu_dextra=de[0], dvar_dextra=dve[0])


def _nig_chain(nig: NIGState):
    """d sigma_hat / d(kappa, alpha, beta), each (K,)."""
    kappa = np.maximum(_np64(nig.kappa), 1e-6)
    alpha = _np64(nig.alpha)
    beta = _np64(nig.beta)
    am1 = np.maximum(alpha - 1.0, 1e-3)
    ev = beta / am1
    sigma2 = ev * (1.0 + 1.0 / kappa)
    sigma_hat = np.sqrt(np.maximum(sigma2, 1e-24))
    inv2s = 1.0 / (2.0 * sigma_hat)
    dsig_dkappa = -(ev / (kappa * kappa)) * inv2s
    dsig_dalpha = -(sigma2 / am1) * inv2s
    dsig_dbeta = (sigma2 / np.maximum(beta, 1e-12)) * inv2s
    return dsig_dkappa, dsig_dalpha, dsig_dbeta


def posterior_sensitivity(sens: MomentSensitivity,
                          nig: NIGState) -> PosteriorSensitivity:
    """Chain the solve adjoints through the NIG posterior parameters
    (``mu_hat = m``, so the m-adjoint is the mus adjoint)."""
    dsig_dkappa, dsig_dalpha, dsig_dbeta = _nig_chain(nig)
    return PosteriorSensitivity(
        sens=sens,
        dmu_dm=sens.dmu_dmus.copy(),
        dmu_dkappa=sens.dmu_dsigmas * dsig_dkappa,
        dmu_dalpha=sens.dmu_dsigmas * dsig_dalpha,
        dmu_dbeta=sens.dmu_dsigmas * dsig_dbeta,
        dvar_dm=sens.dvar_dmus.copy(),
        dvar_dkappa=sens.dvar_dsigmas * dsig_dkappa,
        dvar_dalpha=sens.dvar_dsigmas * dsig_dalpha,
        dvar_dbeta=sens.dvar_dsigmas * dsig_dbeta,
        fragility=estimation_fragility(sens, nig))


def estimation_fragility(sens: MomentSensitivity, nig: NIGState) -> float:
    """``sqrt(sum_k (dmu/dmu_k se_mu_k)^2 + (dmu/dsigma_k se_sig_k)^2)``:
    channel posteriors are independent, so first-order variances add."""
    se_mu, se_sigma = (_np64(s) for s in nig_estimate_ses(nig))
    return float(np.sqrt(
        np.sum((sens.dmu_dmus * se_mu) ** 2)
        + np.sum((sens.dmu_dsigmas * se_sigma) ** 2)))


def fragility_batch(W, mus, sigmas, nig: NIGState, family="normal",
                    num_t: int = 1024, device="cuda") -> np.ndarray:
    """Fragility of every candidate row of ``W`` (F, K), one launch."""
    outs = ops.frontier_moments_with_grads(
        W, mus, sigmas, num_t=num_t, device=device, family=family,
        param_grads=True)
    dmu_m = _np64(outs[4])
    dmu_s = _np64(outs[6])
    se_mu, se_sigma = (_np64(s) for s in nig_estimate_ses(nig))
    return np.sqrt(((dmu_m * se_mu) ** 2).sum(axis=1)
                   + ((dmu_s * se_sigma) ** 2).sum(axis=1))
