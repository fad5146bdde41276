"""Moments of the max-over-channels completion time (paper Eq. 1).

``T = max_i T_i`` with independent channels; the survival integrals

    mu = int_0^inf [1 - F(t)] dt,  E[T^2] = 2 int_0^inf t [1 - F(t)] dt

with ``F(t) = prod_i CDF_i(t)``. :func:`max_moments_quad` /
:func:`max_moments_quad_w` integrate them by the trapezoid rule,
:func:`clark_max_moments_2` is Clark's closed form for two Gaussians,
:func:`clark_max_moments_seq` folds it over K channels (a Python loop over
channels), and :func:`max_moments_mc` samples with an explicit generator.
Under ``REPRO_SANITIZE=1`` the quadrature and the fold check their inputs
(finite, stds nonnegative) and the quadrature its grid
(``analysis/sanitize.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..analysis import sanitize as _san
from ..device import resolve_device
from . import distributions as dists
from .distributions import Phi, phi, safe_cdf

__all__ = ["joint_cdf", "joint_cdf_w", "time_grid", "max_moments_quad",
           "max_moments_quad_w", "clark_max_moments_2",
           "clark_max_moments_seq", "max_moments_mc"]


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def joint_cdf(t, means, stds, device="cuda"):
    """P(T <= t) = prod_i P(T_i <= t); ``t`` any shape, means/stds (K,)."""
    dev = resolve_device(device)
    t = _f32(t, dev)[..., None]
    return torch.prod(safe_cdf(t, _f32(means, dev), _f32(stds, dev)), dim=-1)


def joint_cdf_w(t, w, mus, sigmas, family="normal", device="cuda"):
    """Family-generic joint CDF P(max_i T_i(w_i) <= t), w/mus/sigmas (K,)."""
    dev = resolve_device(device)
    w = _f32(w, dev)
    dist_id, extra = dists.resolve_family(family, w.shape[-1])
    t = _f32(t, dev)[..., None]
    cdf = dists.family_cdf(dist_id, t, w, _f32(mus, dev), _f32(sigmas, dev),
                           _f32(extra, dev))
    return torch.prod(cdf, dim=-1)


def time_grid(means, stds, num: int = 2048, z: float = 10.0):
    """Grid over [0, max_i(mean_i + z std_i)] (floored at 1e-12)."""
    tmax = torch.clamp_min(torch.max(means + z * stds), 1e-12)
    return torch.linspace(0.0, 1.0, num, dtype=means.dtype,
                          device=means.device) * tmax


def max_moments_quad(means, stds, num: int = 2048, device="cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, variance) of max_i N(means_i, stds_i^2) by survival
    integration; zero-work channels drop out."""
    dev = resolve_device(device)
    means = _f32(means, dev)
    stds = _f32(stds, dev)
    _san.check_fold_inputs(means, stds)
    ts = time_grid(means, stds, num=num)
    _san.assert_monotone_grid("max_moments_quad", ts)
    surv = 1.0 - joint_cdf(ts, means, stds, device=dev)
    mu = torch.trapezoid(surv, ts)
    m2 = 2.0 * torch.trapezoid(ts * surv, ts)
    return mu, torch.clamp_min(m2 - mu * mu, 0.0)


def max_moments_quad_w(w, mus, sigmas, num: int = 2048, family="normal",
                       device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Family-generic single-split oracle: (mean, var) of max_i T_i(w_i)."""
    dev = resolve_device(device)
    w = _f32(w, dev)
    dist_id, extra = dists.resolve_family(family, w.shape[-1])
    mus = _f32(mus, dev)
    sigmas = _f32(sigmas, dev)
    extra = _f32(extra, dev)
    _san.check_fold_inputs(mus, sigmas)
    m_eff, s_eff = dists.family_effective_moments(dist_id, w, mus, sigmas,
                                                  extra)
    ts = time_grid(m_eff, s_eff, num=num)
    _san.assert_monotone_grid("max_moments_quad_w", ts)
    cdf = dists.family_cdf(dist_id, ts[:, None], w, mus, sigmas, extra)
    surv = 1.0 - torch.prod(cdf, dim=-1)
    mu = torch.trapezoid(surv, ts)
    m2 = 2.0 * torch.trapezoid(ts * surv, ts)
    return mu, torch.clamp_min(m2 - mu * mu, 0.0)


def clark_max_moments_2(mu1, s1, mu2, s2, device="cuda"):
    """Exact first two moments of max(X, Y) for independent Gaussians
    (Clark 1961); a deterministic pair (a = 0) is handled by a guard."""
    dev = resolve_device(device)
    mu1, s1, mu2, s2 = (_f32(x, dev) for x in (mu1, s1, mu2, s2))
    a2 = s1 * s1 + s2 * s2
    a = torch.sqrt(torch.clamp_min(a2, 0.0))
    ok = a > 0.0
    alpha = (mu1 - mu2) / torch.where(ok, a, 1.0)
    cdf_a = torch.where(ok, Phi(alpha), (mu1 >= mu2).to(a.dtype))
    pdf_a = torch.where(ok, phi(alpha), 0.0)
    m1 = mu1 * cdf_a + mu2 * (1.0 - cdf_a) + a * pdf_a
    m2 = ((mu1 * mu1 + s1 * s1) * cdf_a
          + (mu2 * mu2 + s2 * s2) * (1.0 - cdf_a)
          + (mu1 + mu2) * a * pdf_a)
    return m1, torch.clamp_min(m2 - m1 * m1, 0.0)


def clark_max_moments_seq(means, stds, device="cuda"):
    """Sequential Clark approximation for K channels, folded left to right
    (exact for K <= 2)."""
    dev = resolve_device(device)
    means = _f32(means, dev)
    stds = _f32(stds, dev)
    _san.check_fold_inputs(means, stds)
    m, v = means[0], stds[0] ** 2
    for i in range(1, means.shape[0]):
        m, v = clark_max_moments_2(m, torch.sqrt(v), means[i], stds[i],
                                   device=dev)
    return m, v


def max_moments_mc(generator: torch.Generator, means, stds,
                   num_samples: int = 200_000,
                   device: Optional[str] = None):
    """Monte-Carlo (mean, var) of the max, drawn from ``generator`` on its
    device unless ``device`` is given."""
    dev = resolve_device(device or generator.device)
    means = _f32(means, dev)
    stds = _f32(stds, dev)
    noise = torch.randn((num_samples, means.shape[-1]), generator=generator,
                        dtype=torch.float32, device=dev)
    t = torch.amax(means + stds * noise, dim=-1)
    return t.mean(), t.var(unbiased=False)
