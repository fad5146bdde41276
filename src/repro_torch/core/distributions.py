"""Pluggable channel completion-time distribution families, in PyTorch.

The families, their kernel-facing contract and the point-mass convention are
those of the JAX package's ``core/distributions.py``; this module is its
PyTorch counterpart and shares no code with it.

``normal``
    ``T(w) ~ N(w mu, (w sigma)^2)`` (the paper's model).
``lognormal``
    ``T(w) = w R`` with ``R`` log-normal moment-matched to ``(mu, sigma)``.
``drift``
    ``T(w) ~ N(w mu (1 + rho w / 2), (w sigma)^2)``, per-channel ``rho``.
``empirical``
    A 3-component Gaussian mixture of per-unit rates, fitted by EM.
``defective``
    Per-attempt failure probability ``p`` with retry pricing ``lam``; the law
    is the Gaussian moment-matched to the retry-inflated moments.

Every family reaches the kernels as ``(dist_id, extra)``: ``extra`` is a
dense ``(E, K)`` float32 array of per-channel shape parameters. The adjoint
math factors as

    d log C_k / d w_k (t) = gate(t) * D_k(t) / C_k(t) * (alpha_k + beta_k t)
    d log C_k / d t   (t) = gate(t) * D_k(t) / C_k(t) * (gamma0_k + gamma1_k t) / t

(see ``kernels/frontier_grid.py``). The same per-family formulas are written
out in CUDA in ``csrc/family.cuh``; the two must change together.

Point-mass convention: a degenerate channel (zero work, zero spread, or a
spread-free mixture) is a point mass at its effective mean with a
right-continuous CDF, ``P(T <= t) = 1`` iff ``t >= mean``
(:func:`point_mass_cdf`).

The ``family_*`` functions are plain tensor functions, broadcasting over any
leading shape, so the (F, T, K) plain path and per-channel calls share them.
``Phi`` keeps the ``0.5 * (1 + erf(x / sqrt 2))`` form: the gradient gate of
the adjoint depends on exactly where that expression saturates to 1.0 in
float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "FAMILIES",
    "EMP_COMPONENTS",
    "DIST_IDS",
    "phi",
    "Phi",
    "Phi_c",
    "log_Phi",
    "scaled_channel_params",
    "point_mass_cdf",
    "safe_cdf",
    "extra_rows",
    "family_effective_moments",
    "family_cdf",
    "family_pdf_parts",
    "family_adjoint_parts",
    "family_coeffs",
    "family_param_coeffs",
    "family_accumulators",
    "family_features",
    "family_has_extra_grads",
    "family_dreach",
    "family_dreach_params",
    "family_sample",
    "lognormal_shape_np",
    "defective_moments_np",
    "ChannelFamily",
    "Normal",
    "LogNormal",
    "Drift",
    "Empirical",
    "Defective",
    "DEFECTIVE_PRICING",
    "remaining_work_stats",
    "get_family",
    "resolve_family",
    "family_from_extra",
]

FAMILIES = ("normal", "lognormal", "drift", "empirical", "defective")

# the CUDA kernels select the family by this index (csrc/family.cuh, enum Fam)
DIST_IDS = {name: i for i, name in enumerate(FAMILIES)}

EMP_COMPONENTS = 3

# multiplied, never divided by: a float32 tensor times a Python float is
# one rounded multiply on every device, which the CUDA kernels repeat
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327
_TINY = 1e-20
_Q_FLOOR = 1e-6


# --------------------------------------------------------------------------
# standard-normal primitives
# --------------------------------------------------------------------------

# The float32 erf every CDF goes through. On the card torch.erf is CUDA's
# erff, the function the kernels call; the CPU's erf differs from it (and
# from XLA's) by a few ulps. Tests that hold the algorithm to the JAX
# package's own error level substitute the reference's erf here.
_erf = torch.erf


def phi(x: torch.Tensor) -> torch.Tensor:
    """Standard normal pdf."""
    return torch.exp(-0.5 * x * x) * _INV_SQRT_2PI


def Phi(x: torch.Tensor) -> torch.Tensor:
    """Standard normal cdf as ``0.5 * (1 + erf(x / sqrt 2))``."""
    return 0.5 * (1.0 + _erf(x * _INV_SQRT2))


def Phi_c(x: torch.Tensor) -> torch.Tensor:
    """Standard normal survival function ``1 - Phi(x)``, stable in the tail."""
    return 0.5 * torch.erfc(x * _INV_SQRT2)


def log_Phi(x: torch.Tensor) -> torch.Tensor:
    """log CDF, clamped away from log 0."""
    return torch.log(torch.clamp(Phi(x), 1e-300, 1.0))


def scaled_channel_params(w, mu, sigma):
    """``(w mu, w sigma)``: the normal family's completion-time moments."""
    return w * mu, w * sigma


def point_mass_cdf(t, mean):
    """CDF of a point mass at ``mean``: right-continuous, 1 iff ``t >= mean``."""
    t = torch.as_tensor(t)
    dtype = t.dtype if t.is_floating_point() else torch.float32
    return (t >= mean).to(dtype)


def safe_cdf(t, mean, std):
    """CDF of N(mean, std^2) at t, a point mass at ``mean`` where std == 0."""
    std_ok = std > 0.0
    z = (t - mean) / torch.where(std_ok, std, 1.0)
    return torch.where(std_ok, Phi(z), point_mass_cdf(t, mean))


# --------------------------------------------------------------------------
# family math, selected by dist_id
# --------------------------------------------------------------------------

def _check_dist(dist_id: str) -> None:
    if dist_id not in FAMILIES:
        raise ValueError(f"dist_id must be one of {FAMILIES}, got {dist_id!r}")


def extra_rows(dist_id: str) -> int:
    """Rows of the (E, K) ``extra`` array: 9 for empirical (weights, means,
    stds of 3 components), 2 for defective (p, lam), 1 (zeros) otherwise."""
    _check_dist(dist_id)
    if dist_id == "empirical":
        return 3 * EMP_COMPONENTS
    if dist_id == "defective":
        return 2
    return 1


def _mixture_stats(extra):
    """(m_mix, s_mix) of the per-unit-rate Gaussian mixture in ``extra``."""
    C = EMP_COMPONENTS
    pis = [extra[c] for c in range(C)]
    ms = [extra[C + c] for c in range(C)]
    ss = [extra[2 * C + c] for c in range(C)]
    m_mix = sum(p * m for p, m in zip(pis, ms))
    e2 = sum(p * (s * s + m * m) for p, m, s in zip(pis, ms, ss))
    s_mix = torch.sqrt(torch.clamp_min(e2 - m_mix * m_mix, 0.0))
    return m_mix, s_mix


def lognormal_shape_np(mu, sigma):
    """``(s_l, base)`` with ``R ~ LN(base, s_l^2)`` moment-matched to
    ``(mu, sigma)``, in float64 numpy (the samplers' twin of
    :func:`_lognormal_shape`)."""
    mu = np.maximum(np.asarray(mu, np.float64), 1e-300)
    s2 = np.log1p((np.asarray(sigma, np.float64) / mu) ** 2)
    return np.sqrt(s2), np.log(mu) - 0.5 * s2


def _lognormal_shape(mu, sigma):
    """(s_l, base) of the moment-matched log-normal per-unit rate."""
    mu_ok = mu > 0.0
    safe_mu = torch.where(mu_ok, mu, 1.0)
    r = sigma / safe_mu
    s2 = torch.log1p(r * r)
    s_l = torch.sqrt(s2)
    base = torch.log(safe_mu) - 0.5 * s2
    return s_l, base


def _drift_mean_scale(w, extra):
    """g(w) = w (1 + rho w / 2): the drift family's mean multiplier."""
    rho = extra[0]
    return w * (1.0 + 0.5 * rho * w)


def defective_moments_np(mu, sigma, p, lam):
    """Retry-inflated per-unit moments ``(a, b)`` of the defective family in
    float64 numpy: ``a = mu (1 + lam p/q)``,
    ``b^2 = sigma^2 (1 + lam^2 p/q) + lam^2 mu^2 p/q^2``, ``q = 1 - p``."""
    mu = np.asarray(mu, np.float64)
    sigma = np.asarray(sigma, np.float64)
    p = np.clip(np.asarray(p, np.float64), 0.0, 1.0 - _Q_FLOOR)
    lam = np.asarray(lam, np.float64)
    q = 1.0 - p
    ratio = p / q
    a = mu * (1.0 + lam * ratio)
    b2 = sigma * sigma * (1.0 + lam * lam * ratio) \
        + (lam * mu) ** 2 * ratio / q
    return a, np.sqrt(np.maximum(b2, 0.0))


def _defective_ab(mu, sigma, extra):
    """Retry-inflated per-unit moments (a, b); ``p`` clamped on the upper
    side only, so the valid boundary ``p = 0`` stays off a max-tie."""
    p = torch.clamp_max(extra[0], 1.0 - _Q_FLOOR)
    lam = extra[1]
    q = 1.0 - p
    ratio = p / q
    a = mu * (1.0 + lam * ratio)
    lm = lam * mu
    b2 = sigma * sigma * (1.0 + lam * lam * ratio) + lm * lm * ratio / q
    return a, torch.sqrt(torch.clamp_min(b2, 0.0))


def family_effective_moments(dist_id: str, w, mu, sigma, extra):
    """(mean, std) of the completion time T(w) under the family."""
    _check_dist(dist_id)
    if dist_id in ("normal", "lognormal"):
        return w * mu, w * sigma
    if dist_id == "drift":
        return mu * _drift_mean_scale(w, extra), w * sigma
    if dist_id == "defective":
        a, b = _defective_ab(mu, sigma, extra)
        return w * a, w * b
    m_mix, s_mix = _mixture_stats(extra)
    return w * m_mix, w * s_mix


def _zscore(dist_id: str, t, w, mu, sigma, extra, ok, safe_w):
    """Standardized score of the single-score families (not empirical)."""
    if dist_id == "normal":
        return (t - w * mu) / torch.where(ok, w * sigma, 1.0)
    if dist_id == "lognormal":
        s_l, base = _lognormal_shape(mu, sigma)
        return (torch.log(torch.clamp_min(t, _TINY)) - torch.log(safe_w)
                - base) / torch.where(ok, s_l, 1.0)
    if dist_id == "drift":
        m_d = mu * _drift_mean_scale(w, extra)
        return (t - m_d) / torch.where(ok, w * sigma, 1.0)
    a, b = _defective_ab(mu, sigma, extra)
    return (t - w * a) / torch.where(ok, w * b, 1.0)


def _mixture_components(t, w, extra, ok):
    """Per-component (pi_c, s_c, c_ok, z_c, point-mass location) of the
    empirical mixture."""
    C = EMP_COMPONENTS
    for c in range(C):
        pi_c, m_c, s_c = extra[c], extra[C + c], extra[2 * C + c]
        c_ok = ok & (s_c > 0.0)
        z_c = (t - w * m_c) / torch.where(c_ok, w * s_c, 1.0)
        yield pi_c, s_c, c_ok, z_c, w * m_c


def _raw_cdf(dist_id: str, t, w, mu, sigma, extra, ok, safe_w):
    """Family CDF with degenerate denominators substituted (gate with ``ok``)."""
    if dist_id != "empirical":
        return Phi(_zscore(dist_id, t, w, mu, sigma, extra, ok, safe_w))
    acc = 0.0
    for pi_c, _, c_ok, z_c, m_c in _mixture_components(t, w, extra, ok):
        acc = acc + pi_c * torch.where(c_ok, Phi(z_c), point_mass_cdf(t, m_c))
    return acc


def _family_ok(dist_id: str, w, mu, sigma, extra):
    """Non-degenerate mask: channels with an absolutely continuous T(w)."""
    if dist_id == "lognormal":
        return (w > 0.0) & (sigma > 0.0) & (mu > 0.0)
    if dist_id == "empirical":
        _, s_mix = _mixture_stats(extra)
        return (w > 0.0) & (s_mix > 0.0)
    if dist_id == "defective":
        _, b = _defective_ab(mu, sigma, extra)
        return (w * b) > 0.0
    return (w * sigma) > 0.0


def family_cdf(dist_id: str, t, w, mu, sigma, extra):
    """P(T(w) <= t) for one channel (broadcasting over any leading shape)."""
    _check_dist(dist_id)
    ok = _family_ok(dist_id, w, mu, sigma, extra)
    safe_w = torch.where(w > 0.0, w, 1.0)
    raw = _raw_cdf(dist_id, t, w, mu, sigma, extra, ok, safe_w)
    m_eff, _ = family_effective_moments(dist_id, w, mu, sigma, extra)
    return torch.where(ok, raw, point_mass_cdf(t, m_eff))


def family_adjoint_parts(dist_id: str, t, w, mu, sigma, extra):
    """Per-grid-point adjoint pieces ``(cdf_raw, D, ok, z)``: the
    un-substituted CDF, the pdf-like numerator, the non-degenerate mask and
    the standardized score (zeros for the empirical mixture)."""
    _check_dist(dist_id)
    ok = _family_ok(dist_id, w, mu, sigma, extra)
    safe_w = torch.where(w > 0.0, w, 1.0)
    cdf_raw = _raw_cdf(dist_id, t, w, mu, sigma, extra, ok, safe_w)
    if dist_id != "empirical":
        z = _zscore(dist_id, t, w, mu, sigma, extra, ok, safe_w)
        return cdf_raw, phi(z), ok, z
    D = 0.0
    for pi_c, s_c, c_ok, z_c, _ in _mixture_components(t, w, extra, ok):
        D = D + torch.where(c_ok, pi_c / torch.where(c_ok, s_c, 1.0),
                            0.0) * phi(z_c)
    return cdf_raw, D, ok, torch.zeros_like(D)


def family_pdf_parts(dist_id: str, t, w, mu, sigma, extra):
    """:func:`family_adjoint_parts` without ``z``: ``(cdf_raw, D, ok)``."""
    cdf_raw, D, ok, _ = family_adjoint_parts(dist_id, t, w, mu, sigma, extra)
    return cdf_raw, D, ok


def family_coeffs(dist_id: str, w, mu, sigma, extra):
    """Per-channel adjoint constants ``(alpha, beta, gamma0, gamma1)`` with
    ``dC/dw = D (alpha + beta t)`` and ``dC/dt = D (gamma0 + gamma1 t) / t``;
    all zero on degenerate channels."""
    _check_dist(dist_id)
    ok = _family_ok(dist_id, w, mu, sigma, extra)
    zero = torch.zeros_like(w * mu)

    def guard(x):
        return torch.where(ok, x, 0.0)

    if dist_id == "normal":
        inv_w2s = 1.0 / torch.where(ok, w * w * sigma, 1.0)
        inv_s = 1.0 / torch.where(ok, w * sigma, 1.0)
        return zero, guard(-inv_w2s), zero, guard(inv_s)
    if dist_id == "lognormal":
        s_l, _ = _lognormal_shape(mu, sigma)
        inv_ws = 1.0 / torch.where(ok, w * s_l, 1.0)
        inv_sl = 1.0 / torch.where(ok, s_l, 1.0)
        return guard(-inv_ws), zero, guard(inv_sl), zero
    if dist_id == "drift":
        rho = extra[0]
        inv_w2s = 1.0 / torch.where(ok, w * w * sigma, 1.0)
        inv_s = 1.0 / torch.where(ok, w * sigma, 1.0)
        alpha = guard(-0.5 * rho * mu / torch.where(ok, sigma, 1.0))
        return alpha, guard(-inv_w2s), zero, guard(inv_s)
    if dist_id == "defective":
        _, b = _defective_ab(mu, sigma, extra)
        inv_w2b = 1.0 / torch.where(ok, w * w * b, 1.0)
        inv_b = 1.0 / torch.where(ok, w * b, 1.0)
        return zero, guard(-inv_w2b), zero, guard(inv_b)
    inv_w2 = 1.0 / torch.where(ok, w * w, 1.0)
    inv_w = 1.0 / torch.where(ok, w, 1.0)
    return zero, guard(-inv_w2), zero, guard(inv_w)


def family_accumulators(dist_id: str) -> Tuple[bool, bool]:
    """``(use_p0, use_p1)`` of the W-only fused adjoint."""
    use_1, use_t, _ = family_features(dist_id, params=False)
    return use_1, use_t


def family_features(dist_id: str, params: bool = False
                    ) -> Tuple[bool, bool, bool]:
    """``(use_1, use_t, use_z)``: the accumulator basis the fused adjoint
    contracts against, for W-gradients only or (``params``) for the
    channel-statistic adjoints too."""
    _check_dist(dist_id)
    if not params:
        return {
            "normal": (False, True, False),
            "lognormal": (True, False, False),
            "drift": (True, True, False),
            "empirical": (False, True, False),
            "defective": (False, True, False),
        }[dist_id]
    return {
        "normal": (True, True, False),
        "lognormal": (True, False, True),
        "drift": (True, True, False),
        "empirical": (False, True, False),
        "defective": (True, True, True),
    }[dist_id]


def family_has_extra_grads(dist_id: str) -> bool:
    """Whether ``extra`` row 0 is differentiable (drift's ``rho``, the
    defective family's ``p``). The empirical mixture's parameters and the
    defective pricing ``lam`` are solve constants: their cotangent is zero
    by contract."""
    _check_dist(dist_id)
    return dist_id in ("drift", "defective")


def family_param_coeffs(dist_id: str, w, mu, sigma, extra):
    """``(c_mu, c_sigma, c_rho)``, each a triple ``(a, b, c)`` against the
    (1, t, z) basis: ``d log C/d theta = g (a + b t + c z)``. Zero on
    degenerate channels, and all zero for the empirical family."""
    _check_dist(dist_id)
    ok = _family_ok(dist_id, w, mu, sigma, extra)
    zero = torch.zeros_like(w * mu)

    def guard(x):
        return torch.where(ok, x, 0.0)

    z3 = (zero, zero, zero)
    if dist_id == "normal":
        inv_s = 1.0 / torch.where(ok, sigma, 1.0)
        inv_ws2 = 1.0 / torch.where(ok, w * sigma * sigma, 1.0)
        c_mu = (guard(-inv_s), zero, zero)
        c_sigma = (guard(mu * inv_s * inv_s), guard(-inv_ws2), zero)
        return c_mu, c_sigma, z3
    if dist_id == "lognormal":
        mu_ok = mu > 0.0
        safe_mu = torch.where(mu_ok, mu, 1.0)
        safe_sg = torch.where(sigma > 0.0, sigma, 1.0)
        rr = sigma / safe_mu
        v = rr * rr
        s_l, _ = _lognormal_shape(mu, sigma)
        s_safe = torch.where(ok, s_l, 1.0)
        r = v / (1.0 + v)
        dbase_dmu = (1.0 + r) / safe_mu
        dsl_dmu = -r / (safe_mu * s_safe)
        dbase_dsg = -r / safe_sg
        dsl_dsg = r / (safe_sg * s_safe)
        c_mu = (guard(-dbase_dmu / s_safe), zero, guard(-dsl_dmu / s_safe))
        c_sigma = (guard(-dbase_dsg / s_safe), zero,
                   guard(-dsl_dsg / s_safe))
        return c_mu, c_sigma, z3
    if dist_id == "drift":
        g = _drift_mean_scale(w, extra)
        inv_ws = 1.0 / torch.where(ok, w * sigma, 1.0)
        inv_ws2 = 1.0 / torch.where(ok, w * sigma * sigma, 1.0)
        c_mu = (guard(-g * inv_ws), zero, zero)
        c_sigma = (guard(mu * g * inv_ws2), guard(-inv_ws2), zero)
        c_rho = (guard(-0.5 * mu * w / torch.where(ok, sigma, 1.0)),
                 zero, zero)
        return c_mu, c_sigma, c_rho
    if dist_id == "defective":
        p = torch.clamp_max(extra[0], 1.0 - _Q_FLOOR)
        lam = extra[1]
        q = 1.0 - p
        ratio = p / q
        _, b = _defective_ab(mu, sigma, extra)
        inv_b = 1.0 / torch.where(ok, b, 1.0)
        inv_b2 = inv_b * inv_b
        da_dmu = 1.0 + lam * ratio
        db_dmu_b = lam * lam * mu * (ratio / q) * inv_b2
        db_dsg_b = sigma * (1.0 + lam * lam * ratio) * inv_b2
        da_dp = mu * lam / (q * q)
        db2_dp = lam * lam * (sigma * sigma / (q * q)
                              + mu * mu * (1.0 + p) / (q * q * q))
        db_dp_b = 0.5 * db2_dp * inv_b2
        c_mu = (guard(-da_dmu * inv_b), zero, guard(-db_dmu_b))
        c_sigma = (zero, zero, guard(-db_dsg_b))
        c_p = (guard(-da_dp * inv_b), zero, guard(-db_dp_b))
        return c_mu, c_sigma, c_p
    return z3, z3, z3


def family_dreach(dist_id: str, w, mu, sigma, extra, z: float):
    """d(reach)/dw per channel, reach = effective mean + z * effective std."""
    _check_dist(dist_id)
    if dist_id in ("normal", "lognormal"):
        return mu + z * sigma
    if dist_id == "drift":
        rho = extra[0]
        return mu * (1.0 + rho * w) + z * sigma
    if dist_id == "defective":
        a, b = _defective_ab(mu, sigma, extra)
        return a + z * b
    m_mix, s_mix = _mixture_stats(extra)
    return (m_mix + z * s_mix) * torch.ones_like(w)


def family_dreach_params(dist_id: str, w, mu, sigma, extra, z: float):
    """``(d reach/dmu, d reach/dsigma, d reach/drho)`` per channel (zeros
    for the empirical family, whose reach ignores mus and sigmas)."""
    _check_dist(dist_id)
    ones = torch.ones_like(w * mu)
    zero = torch.zeros_like(ones)
    if dist_id in ("normal", "lognormal"):
        return w * ones, z * w * ones, zero
    if dist_id == "drift":
        g = _drift_mean_scale(w, extra)
        return g * ones, z * w * ones, 0.5 * mu * w * w * ones
    if dist_id == "defective":
        p = torch.clamp_max(extra[0], 1.0 - _Q_FLOOR)
        lam = extra[1]
        q = 1.0 - p
        ratio = p / q
        _, b = _defective_ab(mu, sigma, extra)
        b_ok = b > 0.0
        inv_b = 1.0 / torch.where(b_ok, b, 1.0)
        db_dmu = torch.where(b_ok, lam * lam * mu * (ratio / q) * inv_b, 0.0)
        db_dsg = torch.where(b_ok, sigma * (1.0 + lam * lam * ratio) * inv_b,
                             0.0)
        db2_dp = lam * lam * (sigma * sigma / (q * q)
                              + mu * mu * (1.0 + p) / (q * q * q))
        db_dp = torch.where(b_ok, 0.5 * db2_dp * inv_b, 0.0)
        d_mu = w * ((1.0 + lam * ratio) + z * db_dmu)
        d_sg = w * z * db_dsg
        d_p = w * (mu * lam / (q * q) + z * db_dp)
        return d_mu * ones, d_sg * ones, d_p * ones
    return zero, zero, zero


def family_sample(dist_id: str, rng: np.random.Generator, w, mu, sigma, extra,
                  size: int) -> np.ndarray:
    """Draw ``size`` completion-time samples T(w) per channel (numpy, host):
    w/mu/sigma (K,), extra (E, K) -> (size, K). The defective family draws
    the physical retry process."""
    _check_dist(dist_id)
    w = np.asarray(w, np.float64)
    mu = np.asarray(mu, np.float64)
    sigma = np.asarray(sigma, np.float64)
    extra = np.asarray(extra, np.float64)
    if dist_id == "normal":
        return w * rng.normal(mu, sigma, size=(size, w.shape[0]))
    if dist_id == "lognormal":
        s_l, base = lognormal_shape_np(mu, sigma)
        return w * rng.lognormal(base, s_l, size=(size, w.shape[0]))
    if dist_id == "drift":
        rho = extra[0]
        base = w * rng.normal(mu, sigma, size=(size, w.shape[0]))
        return base + 0.5 * rho * mu * w * w
    if dist_id == "defective":
        p = np.clip(extra[0], 0.0, 1.0 - _Q_FLOOR)
        lam = extra[1]
        K = w.shape[0]
        succ = rng.normal(mu, sigma, size=(size, K))
        nfail = rng.geometric(1.0 - p, size=(size, K)) - 1
        lost = nfail * mu + np.sqrt(nfail.astype(np.float64)) * sigma \
            * rng.standard_normal((size, K))
        return w * (succ + lam * lost)
    C = EMP_COMPONENTS
    pis = extra[:C].T
    ms, ss = extra[C:2 * C].T, extra[2 * C:3 * C].T
    K = w.shape[0]
    out = np.empty((size, K))
    for k in range(K):
        comp = rng.choice(C, size=size, p=pis[k] / pis[k].sum())
        out[:, k] = w[k] * rng.normal(ms[k][comp], ss[k][comp])
    return out


# --------------------------------------------------------------------------
# the ChannelFamily objects (host-side API surface)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ChannelFamily:
    """A completion-time family: ``dist_id`` plus its parameters.
    :func:`resolve_family` lowers it to the kernel-facing
    ``(dist_id, extra)`` pair."""

    dist_id: str = "normal"

    def extra(self, k: int) -> np.ndarray:
        """(E, K) float32 per-channel shape parameters for the kernels."""
        return np.zeros((extra_rows(self.dist_id), k), np.float32)

    def state_dict(self) -> dict:
        return {"dist_id": self.dist_id}


class Normal(ChannelFamily):
    def __init__(self):
        super().__init__(dist_id="normal")


class LogNormal(ChannelFamily):
    def __init__(self):
        super().__init__(dist_id="lognormal")


@dataclass(frozen=True)
class Drift(ChannelFamily):
    """Straggler family: per-channel drift rate ``rho`` (a scalar
    broadcasts); ``rho = 0`` is the normal family."""

    rho: object = 0.0

    def __init__(self, rho=0.0):
        super().__init__(dist_id="drift")
        object.__setattr__(self, "rho", np.asarray(rho, np.float32))

    def extra(self, k: int) -> np.ndarray:
        rho = np.broadcast_to(np.asarray(self.rho, np.float32), (k,))
        return rho[None, :].copy()

    def state_dict(self) -> dict:
        return {"dist_id": "drift", "rho": np.asarray(self.rho).tolist()}


DEFECTIVE_PRICING = {"retry": 1.0, "resume": 0.5}


@dataclass(frozen=True)
class Defective(ChannelFamily):
    """Failure-aware family: per-channel attempt-failure probability ``p``
    and a pricing mode (``"retry"`` 1.0, ``"resume"`` 0.5, or a float in
    [0, 1]) for the fraction of an attempt a failure costs."""

    p: object = 0.0
    lam: object = 1.0

    def __init__(self, p=0.0, pricing="retry"):
        super().__init__(dist_id="defective")
        if isinstance(pricing, str):
            if pricing not in DEFECTIVE_PRICING:
                raise ValueError(f"pricing must be one of "
                                 f"{sorted(DEFECTIVE_PRICING)} or a float in "
                                 f"[0, 1], got {pricing!r}")
            lam = DEFECTIVE_PRICING[pricing]
        else:
            lam = float(pricing)
            if not 0.0 <= lam <= 1.0:
                raise ValueError(f"pricing fraction must lie in [0, 1], "
                                 f"got {lam}")
        p_arr = np.asarray(p, np.float32)
        if p_arr.size and (float(p_arr.min()) < 0.0
                           or float(p_arr.max()) > 1.0):
            raise ValueError("failure probabilities must lie in [0, 1], got "
                             f"range [{float(p_arr.min())}, "
                             f"{float(p_arr.max())}]")
        object.__setattr__(self, "p", p_arr)
        object.__setattr__(self, "lam", np.float32(lam))

    def extra(self, k: int) -> np.ndarray:
        p = np.broadcast_to(np.asarray(self.p, np.float32), (k,))
        lam = np.full((k,), self.lam, np.float32)
        return np.stack([p, lam])

    def state_dict(self) -> dict:
        return {"dist_id": "defective", "p": np.asarray(self.p).tolist(),
                "lam": float(self.lam)}


@dataclass(frozen=True)
class Empirical(ChannelFamily):
    """Gaussian-mixture fit of observed per-unit rates: ``weights``,
    ``means`` and ``stds`` are (C, K); build from data with
    :meth:`from_samples`."""

    weights: np.ndarray = None
    means: np.ndarray = None
    stds: np.ndarray = None

    def __init__(self, weights, means, stds):
        super().__init__(dist_id="empirical")
        w = np.asarray(weights, np.float32)
        if w.ndim == 1:
            w, means, stds = (np.asarray(a, np.float32)[:, None]
                              for a in (weights, means, stds))
        else:
            means = np.asarray(means, np.float32)
            stds = np.asarray(stds, np.float32)
        if w.shape[0] != EMP_COMPONENTS:
            raise ValueError(f"expected {EMP_COMPONENTS} mixture components, "
                             f"got {w.shape[0]}")
        w = w / np.maximum(w.sum(axis=0, keepdims=True), 1e-12)
        object.__setattr__(self, "weights", w)
        object.__setattr__(self, "means", means)
        object.__setattr__(self, "stds", np.asarray(stds, np.float32))

    @classmethod
    def from_samples(cls, samples, iters: int = 40,
                     var_floor_frac: float = 1e-3) -> "Empirical":
        """Fit per-channel mixtures from an (N, K) array or a sequence of
        per-channel 1-D arrays of per-unit durations (deterministic EM)."""
        if isinstance(samples, np.ndarray) and samples.ndim == 2:
            cols = [samples[:, k] for k in range(samples.shape[1])]
        else:
            cols = [np.asarray(s, np.float64).ravel() for s in samples]
        C = EMP_COMPONENTS
        W = np.empty((C, len(cols)))
        M = np.empty((C, len(cols)))
        S = np.empty((C, len(cols)))
        for k, x in enumerate(cols):
            W[:, k], M[:, k], S[:, k] = _em_1d(np.asarray(x, np.float64),
                                               C, iters, var_floor_frac)
        return cls(W, M, S)

    def extra(self, k: int) -> np.ndarray:
        if self.weights.shape[1] == 1 and k > 1:
            def tile(a):
                return np.broadcast_to(a, (EMP_COMPONENTS, k))
            return np.concatenate([tile(self.weights), tile(self.means),
                                   tile(self.stds)], axis=0).astype(np.float32)
        if self.weights.shape[1] != k:
            raise ValueError(f"family fitted for K={self.weights.shape[1]} "
                             f"channels, asked for K={k}")
        return np.concatenate([self.weights, self.means, self.stds],
                              axis=0).astype(np.float32)

    def state_dict(self) -> dict:
        return {"dist_id": "empirical", "weights": self.weights.tolist(),
                "means": self.means.tolist(), "stds": self.stds.tolist()}


def _em_1d(x: np.ndarray, C: int, iters: int, var_floor_frac: float):
    """Deterministic 1-D Gaussian-mixture EM (quantile init, floored vars)."""
    n = x.shape[0]
    if n == 0:
        raise ValueError("cannot fit an empirical family from zero samples")
    spread = max(float(x.std()), abs(float(x.mean())) * 1e-6, 1e-12)
    floor = (var_floor_frac * spread) ** 2
    mus = np.quantile(x, (np.arange(C) + 0.5) / C)
    vars_ = np.full(C, max(spread ** 2 / C, floor))
    pis = np.full(C, 1.0 / C)
    for _ in range(iters):
        logp = (-0.5 * ((x[None, :] - mus[:, None]) ** 2) / vars_[:, None]
                - 0.5 * np.log(2 * np.pi * vars_[:, None])
                + np.log(np.maximum(pis[:, None], 1e-300)))
        logp -= logp.max(axis=0, keepdims=True)
        r = np.exp(logp)
        r /= np.maximum(r.sum(axis=0, keepdims=True), 1e-300)
        nk = np.maximum(r.sum(axis=1), 1e-12)
        mus = (r @ x) / nk
        vars_ = np.maximum((r @ (x ** 2)) / nk - mus ** 2, floor)
        pis = nk / n
    order = np.argsort(mus)
    return pis[order], mus[order], np.sqrt(vars_[order])


_SINGLETONS = {"normal": Normal(), "lognormal": LogNormal(),
               "drift": Drift(0.0)}


def get_family(family) -> ChannelFamily:
    """Accept a family name, a ChannelFamily, a ``state_dict`` or None
    (normal); return the instance."""
    if isinstance(family, ChannelFamily):
        return family
    if family is None:
        return _SINGLETONS["normal"]
    if isinstance(family, str):
        if family == "empirical":
            raise ValueError("the empirical family carries fitted parameters; "
                             "build it with Empirical.from_samples(...) "
                             "instead of the bare name")
        if family == "defective":
            raise ValueError("the defective family carries failure "
                             "probabilities; build it with Defective(p, "
                             "pricing=...) instead of the bare name")
        if family in _SINGLETONS:
            return _SINGLETONS[family]
        raise ValueError(f"unknown family {family!r}; expected one of "
                         f"{FAMILIES} or a ChannelFamily instance")
    if isinstance(family, dict):
        d = dict(family)
        dist = d.pop("dist_id")
        if dist == "drift":
            return Drift(np.asarray(d["rho"], np.float32))
        if dist == "empirical":
            return Empirical(np.asarray(d["weights"]), np.asarray(d["means"]),
                             np.asarray(d["stds"]))
        if dist == "defective":
            return Defective(np.asarray(d["p"], np.float32),
                             pricing=float(d.get("lam", 1.0)))
        return _SINGLETONS[dist]
    raise TypeError(f"cannot interpret {type(family).__name__} as a family")


def resolve_family(family, k: int):
    """Lower a family spec to the kernel-facing ``(dist_id, extra)``.

    Accepts a name, a ChannelFamily, a ``state_dict`` or an already-lowered
    ``(dist_id, extra)`` pair, whose ``extra`` may be (E, K) or the per-row
    (E, F, K) stack; a lowered pair passes through unchanged.
    """
    if isinstance(family, tuple) and len(family) == 2:
        dist_id, extra = family
        _check_dist(dist_id)
        shape = tuple(extra.shape)
        ok2 = shape == (extra_rows(dist_id), k)
        ok3 = (len(shape) == 3 and shape[0] == extra_rows(dist_id)
               and shape[2] == k)
        if not (ok2 or ok3):
            raise ValueError(f"extra for {dist_id!r} must be "
                             f"({extra_rows(dist_id)}, {k}) or "
                             f"({extra_rows(dist_id)}, F, {k}), got {shape}")
        return dist_id, extra
    fam = get_family(family)
    return fam.dist_id, fam.extra(k)


def family_from_extra(dist_id: str, extra) -> ChannelFamily:
    """Raise a lowered ``(dist_id, extra (E, K))`` pair back to a
    ChannelFamily (the inverse of :func:`resolve_family`)."""
    _check_dist(dist_id)
    ex = np.asarray(extra, np.float32)
    if dist_id == "normal":
        return _SINGLETONS["normal"]
    if dist_id == "lognormal":
        return _SINGLETONS["lognormal"]
    if dist_id == "drift":
        return Drift(ex[0])
    if dist_id == "defective":
        lam = float(ex[1].flat[0]) if ex[1].size else 1.0
        return Defective(np.clip(ex[0], 0.0, 1.0), pricing=lam)
    C = EMP_COMPONENTS
    return Empirical(ex[0:C], ex[C:2 * C], ex[2 * C:3 * C])


def remaining_work_stats(dist_id: str, mus, sigmas, extra, done):
    """Channel statistics for the *remaining* work after sunk progress
    (float64 numpy): ``r = max(1 - sum(done), 0)``; scale families rescale
    ``(mu, sigma) -> (r mu, r sigma)`` (mixture means and stds likewise);
    drift keeps its inflated instantaneous rate,
    ``mu' = r mu (1 + rho d)``, ``sigma' = r sigma``,
    ``rho' = rho r / (1 + rho d)``. Returns ``(mus_r, sigmas_r, extra_r, r)``.
    """
    _check_dist(dist_id)
    mus = np.asarray(mus, np.float64)
    sigmas = np.asarray(sigmas, np.float64)
    extra = np.asarray(extra, np.float64)
    done = np.asarray(done, np.float64)
    if done.shape != mus.shape:
        raise ValueError(f"done must be per-channel {mus.shape}, "
                         f"got {done.shape}")
    if done.size and (float(done.min()) < -1e-9
                      or float(done.sum()) > 1.0 + 1e-6):
        raise ValueError("done fractions must be nonnegative with total "
                         f"<= 1, got sum {float(done.sum()):.6f}, "
                         f"min {float(done.min()):.3e}")
    r = float(max(1.0 - done.sum(), 0.0))
    extra_r = extra.copy()
    if dist_id == "drift":
        rho = extra[0]
        inflate = 1.0 + rho * done
        extra_r[0] = rho * r / np.maximum(inflate, 1e-12)
        return r * mus * inflate, r * sigmas, extra_r, r
    if dist_id == "empirical":
        C = EMP_COMPONENTS
        extra_r[C:3 * C] *= r
    return r * mus, r * sigmas, extra_r, r
