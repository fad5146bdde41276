"""Plain PyTorch versions of the port's kernels.

The model kernels' plain versions (:func:`flash_attention_ref`,
:func:`decode_attention_ref`, :func:`rmsnorm_ref`, :func:`ssd_scan_ref`)
follow the JAX package's ``kernels/ref.py`` line for line: float32 math,
output in the input's dtype, masked logits at ``-inf`` (a row with no live
key gives NaN here, and 0 from the CUDA kernels, as from the Pallas
kernels). :func:`ssd_chunked_ref` is the chunked block decomposition of the
JAX package's ``ops._ssd_xla_chunked``: the SSD kernel's plain version.

The frontier kernels' plain versions:

:func:`frontier_grid_ref` and :func:`frontier_grid_with_grads_ref` are the
semantics of the two CUDA kernels in ``csrc/frontier_grid.cu``: the CPU path
runs them, and ``chip_smoke.py`` holds each kernel against them on the card.
Every family of ``core.distributions.FAMILIES`` (normal, lognormal, drift,
empirical, defective) flows through the ``family_*`` dispatch.

Grid: ``t_j = tmax * (j / (T - 1))``, with ``j / (T - 1)`` formed in float32
before the multiply, in both the kernels and this module. (The JAX
reference's oracle uses ``linspace``; its TPU kernel uses this form. The two
differ in the last bit of some grid points, inside every test tolerance.)

Numerics, as in the kernels: per-channel terms are float32 and every sum
over channels or grid points is float64 (``log F``, the trapezoid sums, the
P/Pv accumulators, the epilogue). The variance and the var-adjoints are
differences of nearly equal sums, where a float32 sum loses ~3 digits; the
outputs are rounded to float32 at the end. The JAX reference sums in
float32, so this module is the more accurate of the two.

The adjoint is written out by hand, never taken by autograd through the
forward: ``torch.clamp`` passes gradient 1 at its bounds, while the
contract's gate is 0.5 where the CDF saturates at 1.0 and 0 below the floor.
The Pv accumulators sum ``a * (t - mu)`` per grid point; ``P1 - mu * P0``
would cancel catastrophically when var << mu^2.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import distributions as dists
# the module, not the name: importing autotune first reaches this module
# through core before autotune has defined anything
from . import autotune

__all__ = ["frontier_grid_ref", "frontier_grid_with_grads_ref",
           "CDF_FLOOR", "time_fractions", "flash_attention_ref",
           "rmsnorm_ref", "decode_attention_ref",
           "flash_attention_bf16p_ref", "decode_attention_split_ref",
           "decode_attention_partial_ref", "rmsnorm_bwd_ref",
           "rmsnorm_stat_ref", "rmsnorm_split_ref", "rmsnorm_split_bwd_ref",
           "attention_mask", "flash_attention_lse_ref",
           "flash_attention_bwd_ref", "ssd_chunked_bwd_ref", "tf32_round",
           "tf32_trunc", "split_einsum",
           "ssd_bwd_increments_ref", "ssd_bwd_scan_ref",
           "ssd_bwd_chunk_grads_ref"]

# log-CDF clamp floor; a normal float32 so no subnormal reaches the log
CDF_FLOOR = 1e-37


def time_fractions(num_t: int, device) -> torch.Tensor:
    """``j / (T - 1)`` for j = 0..T-1, each a correctly rounded float32
    division (the grid of both paths)."""
    if num_t < 2:
        raise ValueError(f"num_t must be >= 2, got {num_t}")
    frac = np.arange(num_t, dtype=np.float32) / np.float32(num_t - 1)
    return torch.from_numpy(frac).to(device)


def _family_args(dist_id, extra, W):
    if extra is None:
        return torch.zeros((dists.extra_rows(dist_id), W.shape[1]),
                           dtype=torch.float32, device=W.device)
    return torch.as_tensor(extra, dtype=torch.float32, device=W.device)


# repro: allow[RPA001] layout-only axis alignment: the family dispatch
# happens in the family_* call of the caller, which holds dist_id
def _stat_bcast(mus, sigmas, extra):
    """Align shared (K,) / (E, K) or per-row (F, K) / (E, F, K) statistics
    with the (F, T, K) grid."""
    if mus.ndim == 2:
        return mus[:, None, :], sigmas[:, None, :], extra[:, :, None, :]
    return mus, sigmas, extra


def _as_f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def frontier_grid_ref(W, mus, sigmas, num_t: int = 1024, z: float = 10.0,
                      dist_id: str = "normal", extra=None):
    """(mu, var) of the max completion time for each candidate row of W.

    W (F, K); mus/sigmas (K,) shared or (F, K) per-row; extra (E, K) or
    (E, F, K). Per-row grid ``[0, max_k(mean_k + z std_k)]`` on the family's
    effective moments, trapezoid quadrature of the survival integrals.
    """
    W = _as_f32(W, None)
    mus = _as_f32(mus, W.device)
    sigmas = _as_f32(sigmas, W.device)
    extra = _family_args(dist_id, extra, W)
    means_eff, stds_eff = dists.family_effective_moments(
        dist_id, W, mus, sigmas, extra)
    tmax = torch.clamp_min(torch.amax(means_eff + z * stds_eff, dim=-1),
                           1e-12)
    ts = tmax[:, None] * time_fractions(num_t, W.device)[None, :]

    mus_b, sgs_b, ex_b = _stat_bcast(mus, sigmas, extra)
    cdf = dists.family_cdf(dist_id, ts[:, :, None], W[:, None, :],
                           mus_b, sgs_b, ex_b)
    _, mu, m2 = _moments(torch.clamp(cdf, CDF_FLOOR, 1.0), ts, tmax, num_t)
    return mu.float(), torch.clamp_min(m2 - mu * mu, 0.0).float()


def _trapezoid_weights(num_t: int, device) -> torch.Tensor:
    wq = torch.ones((num_t,), dtype=torch.float64, device=device)
    wq[0] = 0.5
    wq[-1] = 0.5
    return wq


def _moments(Cc, ts, tmax, num_t: int):
    """``(w F, mu, m2)`` in float64 from the clamped channel CDFs
    (F, T, K): ``log F`` summed over channels, the trapezoid sums over the
    grid (weights 1/2 at the ends)."""
    logF = torch.sum(torch.log(Cc).double(), dim=-1)
    F_t = torch.exp(logF)
    surv = 1.0 - F_t
    wq = _trapezoid_weights(num_t, ts.device)
    dt = tmax.double() / (num_t - 1)
    mu = torch.sum(wq * surv, -1) * dt
    m2 = 2.0 * torch.sum(wq * ts.double() * surv, -1) * dt
    return wq * F_t, mu, m2


def frontier_grid_with_grads_ref(W, mus, sigmas, num_t: int = 1024,
                                 z: float = 10.0, dist_id: str = "normal",
                                 extra=None, param_grads: bool = False):
    """``(mu, var, dmu_dW, dvar_dW)`` with the analytic adjoints.

    With ``param_grads=True`` the 10-tuple ``(mu, var, dmu_dW, dvar_dW,
    dmu_dmus, dvar_dmus, dmu_dsigmas, dvar_dsigmas, dmu_dex, dvar_dex)``,
    all adjoints (F, K); ``d*_dex`` is the adjoint of ``extra`` row 0 and is
    zero for families without a differentiable shape parameter.

    The conventions are those of autodiff through the quadrature: the clamp
    passes 1 inside its bounds, 0.5 at a saturated CDF of 1.0 and 0 below
    the floor; the tmax term on the argmax channel splits evenly over ties;
    degenerate channels get no direct gradient but still the tmax term;
    ``dvar`` is zero where ``m2 - mu^2 <= 0``.
    """
    W = _as_f32(W, None)
    mus = _as_f32(mus, W.device)
    sigmas = _as_f32(sigmas, W.device)
    extra = _family_args(dist_id, extra, W)
    means_eff, stds_eff = dists.family_effective_moments(
        dist_id, W, mus, sigmas, extra)
    reach = means_eff + z * stds_eff
    amax = torch.amax(reach, dim=-1)
    tmax = torch.clamp_min(amax, 1e-12)
    ts = tmax[:, None] * time_fractions(num_t, W.device)[None, :]

    mus_b, sgs_b, ex_b = _stat_bcast(mus, sigmas, extra)
    cdf_raw, D, ok, zsc = dists.family_adjoint_parts(
        dist_id, ts[:, :, None], W[:, None, :], mus_b, sgs_b, ex_b)
    cdf = torch.where(ok, cdf_raw,
                      dists.point_mass_cdf(ts[:, :, None],
                                           means_eff[:, None, :]))
    Cc = torch.clamp(cdf, CDF_FLOOR, 1.0)
    wF, mu, m2 = _moments(Cc, ts, tmax, num_t)
    var_raw = m2 - mu * mu
    dt = tmax.double() / (num_t - 1)

    gate = (torch.where(cdf_raw >= 1.0, 0.5, 1.0)
            * (cdf_raw > CDF_FLOOR) * ok)
    r = gate * D / Cc
    a = (wF.float()[:, :, None] * r).double()
    use_1, use_t, use_z = dists.family_features(dist_id, params=param_grads)
    ts64 = ts.double()
    tmu = ts64 - mu[:, None]
    P0 = a.sum(1) if use_1 else 0.0
    Pv0 = torch.einsum("ftk,ft->fk", a, tmu) if use_1 else 0.0
    at = a * ts64[:, :, None] if use_t else None
    P1 = at.sum(1) if use_t else 0.0
    Pv1 = torch.einsum("ftk,ft->fk", at, tmu) if use_t else 0.0
    az = a * zsc.double() if use_z else None
    Pz = az.sum(1) if use_z else 0.0
    Pvz = torch.einsum("ftk,ft->fk", az, tmu) if use_z else 0.0

    alpha, beta, gamma0, gamma1 = (c.double() for c in dists.family_coeffs(
        dist_id, W, mus, sigmas, extra))
    tmx = tmax.double()
    b_mu = (mu - dt * torch.sum(gamma0 * P0 + gamma1 * P1, -1)) / tmx
    b_var = 2.0 * (var_raw
                   - dt * torch.sum(gamma0 * Pv0 + gamma1 * Pv1, -1)) / tmx
    ind = (reach == amax[:, None]).double()
    tie = ind / torch.sum(ind, -1, keepdim=True) * (amax > 1e-12)[:, None]
    var_pos = (var_raw > 0.0)[:, None]

    def contract(coeff_1, coeff_t, coeff_z, dreach):
        """Fixed-grid plus moving-grid adjoint for one parameter axis."""
        c1, ct, cz = (torch.as_tensor(c).double()
                      for c in (coeff_1, coeff_t, coeff_z))
        gvec = dreach.double() * tie
        dmu_th = (-dt[:, None] * (c1 * P0 + ct * P1 + cz * Pz)
                  + b_mu[:, None] * gvec)
        dvar_th = torch.where(
            var_pos,
            -2.0 * dt[:, None] * (c1 * Pv0 + ct * Pv1 + cz * Pvz)
            + b_var[:, None] * gvec, 0.0)
        return dmu_th.float(), dvar_th.float()

    mu, var = mu.float(), torch.clamp_min(var_raw, 0.0).float()
    dreach_w = dists.family_dreach(dist_id, W, mus, sigmas, extra, z)
    zero_fk = torch.zeros_like(W * mus)
    dmu, dvar = contract(alpha, beta, 0.0, dreach_w)
    if not param_grads:
        return mu, var, dmu, dvar

    c_mu, c_sigma, c_rho = dists.family_param_coeffs(
        dist_id, W, mus, sigmas, extra)
    dr_mu, dr_sigma, dr_rho = dists.family_dreach_params(
        dist_id, W, mus, sigmas, extra, z)
    dmu_m, dvar_m = contract(*c_mu, dr_mu)
    dmu_s, dvar_s = contract(*c_sigma, dr_sigma)
    if dists.family_has_extra_grads(dist_id):
        dmu_e, dvar_e = contract(*c_rho, dr_rho)
    else:
        dmu_e, dvar_e = zero_fk, zero_fk
    return (mu, var, dmu, dvar, dmu_m, dvar_m, dmu_s, dvar_s, dmu_e, dvar_e)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        sm_scale: Optional[float] = None):
    """GQA attention. q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv,
    Sk, Dv) with its own head dim (MLA); query head h reads kv head
    ``h // (Hq // Hkv)``. Returns (B, Hq, Sq, Dv).

    Rectangular Sq != Sk is allowed here; causal then aligns the last query
    with the last key (standard self-attention when Sq == Sk). Float32 math
    (float64 for float64 inputs).
    """
    Hq, Sq, D = q.shape[1], q.shape[2], q.shape[3]
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    kx = torch.repeat_interleave(k, group, dim=1)
    vx = torch.repeat_interleave(v, group, dim=1)
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), kx.to(ct)) * scale
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vx.to(ct))
    return out.to(q.dtype)


def rmsnorm_ref(x, w, eps: float = 1e-6):
    """RMSNorm over the last axis: ``(x * rsqrt(mean(x^2) + eps)) * w`` in
    float32 (float64 for float64 inputs), cast to x's dtype."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(ct)
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * w.to(ct)).to(x.dtype)


def rmsnorm_bwd_ref(x, w, dy, eps: float = 1e-6):
    """(dx, dw) of :func:`rmsnorm_ref` for the output cotangent ``dy``, the
    backward kernel's formulas: with r = rsqrt(mean(x^2) + eps),
    dx = r (w dy) - x r^3 mean(x w dy) and dw = sum over rows of dy x r,
    in float32 (float64 for float64 inputs), cast to x's and w's dtypes."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, wf, gf = x.to(ct), w.to(ct), dy.to(ct)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    wg = wf * gf
    dx = r * wg - xf * r ** 3 * torch.mean(xf * wg, dim=-1, keepdim=True)
    dw = (gf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


def rmsnorm_stat_ref(x, w=None, dy=None):
    """Each row's partial sum over x's columns (a rank's share of a split
    row), float32 (float64 for float64 inputs), shape x.shape[:-1]:
    sum(x^2) with ``dy`` None, else sum(x w dy)."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(ct)
    if dy is None:
        return torch.sum(xf * xf, dim=-1)
    return torch.sum(xf * w.to(ct) * dy.to(ct), dim=-1)


def rmsnorm_split_ref(x, w, ss, n: int, eps: float = 1e-6):
    """The split-row RMSNorm of a rank's columns x (..., D) given ``ss``
    (...,), the row's sum of squares over all n columns (every rank's
    :func:`rmsnorm_stat_ref` summed): ``x rsqrt(ss / n + eps) w``, cast
    to x's dtype."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    r = torch.rsqrt(ss.to(ct)[..., None] / n + eps)
    return (x.to(ct) * r * w.to(ct)).to(x.dtype)


def rmsnorm_split_bwd_ref(x, w, dy, ss, dot, n: int, eps: float = 1e-6):
    """(dx, dw) of :func:`rmsnorm_split_ref` for the rank's cotangent dy,
    given the row totals ``ss`` and ``dot`` (sum(x w dy) over all n
    columns): with r = rsqrt(ss / n + eps), dx = r (w dy) - x r^3 dot / n
    and dw, the rank's own columns, the sum over rows of dy x r."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, wf, gf = x.to(ct), w.to(ct), dy.to(ct)
    r = torch.rsqrt(ss.to(ct)[..., None] / n + eps)
    dx = r * (wf * gf) - xf * r ** 3 * (dot.to(ct)[..., None] / n)
    dw = (gf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


def attention_mask(Sq: int, Sk: int, causal: bool, window: Optional[int],
                   device):
    """(Sq, Sk) bool: key j is live for query i (the kernels' masks; causal
    aligns the last query with the last key)."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def _scaled_logits(q, k, group, scale, mask, ct, einsum=torch.einsum):
    kx = torch.repeat_interleave(k, group, dim=1).to(ct)
    s = einsum("bhqd,bhkd->bhqk", q.to(ct), kx) * scale
    return s.masked_fill(~mask, float("-inf"))


def flash_attention_lse_ref(q, k, v, *, causal: bool = True,
                            window: Optional[int] = None,
                            sm_scale: Optional[float] = None,
                            einsum=torch.einsum):
    """(out, lse): :func:`flash_attention_ref`'s output and each row's
    natural-log sum of exponentials of its scaled live logits (B, Hq, Sq)
    (+inf for a row with no live key, whose output is 0), as the forward
    kernels write them for the backward; float64 inputs stay float64.
    ``einsum`` takes the two products (the tests pass
    :func:`split_einsum`'s)."""
    Hq, Sq, D = q.shape[1], q.shape[2], q.shape[3]
    Hkv, Sk = k.shape[1], k.shape[2]
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    s = _scaled_logits(q, k, Hq // Hkv, scale, mask, ct, einsum)
    lse = torch.logsumexp(s, dim=-1)
    dead = torch.isneginf(lse)
    p = torch.exp(s - torch.where(dead, 0.0, lse)[..., None])
    vx = torch.repeat_interleave(v, Hq // Hkv, dim=1).to(ct)
    out = einsum("bhqk,bhkd->bhqd", p, vx)
    return out.to(q.dtype), torch.where(dead, float("inf"), lse)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            window: Optional[int] = None,
                            sm_scale: Optional[float] = None,
                            einsum=torch.einsum):
    """(dq, dk, dv) of attention from its ``out`` and ``lse``, the backward
    kernels' formulas: P = exp(S - lse) under the masks, D_i = rowsum(dO O),
    dV = P^T dO, dS = P (dO V^T - D_i), dQ = scale dS K, dK = scale dS^T Q,
    the GQA groups summed into their kv head; float32 (float64 for float64
    inputs), cast to the inputs' dtypes. ``einsum`` takes the five
    products (the tests pass :func:`split_einsum`'s)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    s = _scaled_logits(q, k, group, scale, mask, ct, einsum)
    p = torch.exp(s - lse.to(ct)[..., None])          # masked: exp(-inf) = 0
    g, o = dout.to(ct), out.to(ct)
    delta = (g * o).sum(-1, keepdim=True)
    kx = torch.repeat_interleave(k, group, dim=1).to(ct)
    vx = torch.repeat_interleave(v, group, dim=1).to(ct)
    dv = einsum("bhqk,bhqd->bhkd", p, g)
    ds = p * (einsum("bhqd,bhkd->bhqk", g, vx) - delta)
    dq = scale * einsum("bhqk,bhkd->bhqd", ds, kx)
    dk = scale * einsum("bhqk,bhqd->bhkd", ds, q.to(ct))
    fold = (lambda t: t.reshape(B, Hkv, group, Sk, t.shape[-1]).sum(2))
    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


def decode_attention_ref(q, k_cache, v_cache, valid, sm_scale=None):
    """Single-token GQA attention. q: (B, Hkv, G, D); caches (B, Hkv, S, D);
    valid: (S,) bool -> (B, Hkv, G, D). The probabilities stay float32."""
    D = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k_cache.float()) * scale
    s = s.masked_fill(~valid[None, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return o.to(q.dtype)


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits) to nearest,
    ties away from zero: the bits of ``cvt.rna.tf32.f32``, which the float32
    attention kernels compute as ``(bits + 0x1000) & 0xffffe000``; a NaN
    stays a NaN (test-only)."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    return torch.where(torch.isnan(x), x,
                       ((bits + 0x1000) & -0x2000).view(torch.float32))


def tf32_trunc(x):
    """float32 ``x`` cut to TF32 toward zero: the bits an ``mma.sync``
    reads of a float32 operand (test-only)."""
    x = x.to(torch.float32).contiguous()
    return torch.where(torch.isnan(x), x,
                       (x.view(torch.int32) & -0x2000).view(torch.float32))


def split_einsum(planes: str = "tf32", terms: int = 3):
    """An einsum of two operands as a tensor core would take them in float32
    (test-only). ``"tf32"``: the float32 attention kernels' split, each
    operand x as hi = TF32(x) (:func:`tf32_round`) and lo = x - hi, of which
    the product reads TF32 toward zero (:func:`tf32_trunc`). ``"bf16"``:
    two bf16 planes, hi = bf16(x) and lo = bf16(x - hi), each rounded to
    nearest even. The product is (lo.hi + hi.lo) + hi.hi, each term exact
    in float32 and summed in float32; ``terms=1`` takes hi.hi alone."""
    if planes not in ("tf32", "bf16") or terms not in (1, 3):
        raise ValueError(f"planes is tf32 or bf16 and terms 1 or 3, got "
                         f"{planes!r}, {terms}")

    def split(x):
        x = x.to(torch.float32)
        if planes == "tf32":
            hi = tf32_round(x)
            return hi, tf32_trunc(x - hi)
        hi = x.to(torch.bfloat16).float()
        return hi, (x - hi).to(torch.bfloat16).float()

    def einsum(eq, a, b):
        (ah, al), (bh, bl) = split(a), split(b)
        if terms == 1:
            return torch.einsum(eq, ah, bh)
        return ((torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl))
                + torch.einsum(eq, ah, bh))
    return einsum


# the attention kernels' masked logit and dead-row threshold
NEG_INF = -1e30


def flash_attention_bf16p_ref(q, k, v, *, causal: bool = True,
                              window: Optional[int] = None,
                              sm_scale: Optional[float] = None):
    """The bf16 flash-attention kernel's arithmetic (test-only): online
    softmax over key blocks of the kernel's tile (128 keys for D <= 128,
    else 64), P = exp(s - m) rounded to bf16 before P . V, and l
    summed from the rounded P; masked logits at -1e30, a row with no live
    key gives 0. Same shapes and rules as :func:`flash_attention_ref`
    (causal and window need Sq == Sk; v may have its own head dim)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    bk = 128 if D <= 128 else 64
    kx = torch.repeat_interleave(k, group, dim=1).float()
    vx = torch.repeat_interleave(v, group, dim=1).float()
    qpos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, Hq, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, Hq, Sq, 1), device=q.device)
    acc = torch.zeros((B, Hq, Sq, v.shape[3]), device=q.device)
    for k0 in range(0, Sk, bk):
        kpos = torch.arange(k0, min(k0 + bk, Sk), device=q.device)[None, :]
        live = torch.ones((Sq, kpos.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            live &= qpos >= kpos
        if window is not None:
            live &= (qpos - kpos) < window
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         kx[:, :, k0:k0 + bk]) * scale
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        sub = torch.where(m_new <= NEG_INF / 2, torch.zeros_like(m_new),
                          m_new)
        alpha = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                            torch.exp(m - sub))
        p = torch.where(live, torch.exp(s - sub), torch.zeros_like(s))
        p = p.to(torch.bfloat16).float()
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p,
                                         vx[:, :, k0:k0 + bk])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def decode_attention_split_ref(q, k_cache, v_cache, valid, splits: int,
                               sm_scale=None, return_partials: bool = False):
    """The split flash-decode kernels' arithmetic (test-only). The cache is
    cut into ``splits`` ranges of ``ceil(S / splits)`` slots (trailing
    ranges may be empty); each range gives a float32 partial (m, l, acc):
    the max of its valid logits (-1e30 if it has none), the sum of
    exp(s - m) and the weighted sum of V rows (0 and 0 if none). The
    partials combine in split order with weights exp(m_s - M), 0 for a
    range without a valid slot; o = acc / max(l, 1e-30), so a row with no
    valid slot anywhere gives 0. ``return_partials`` also returns
    (m, l, acc) with a leading split axis."""
    D, S = q.shape[-1], k_cache.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    split_len = -(-S // splits)
    ms, ls, accs = [], [], []
    for sp in range(splits):
        lo, hi = sp * split_len, min(S, (sp + 1) * split_len)
        kk = k_cache[:, :, lo:hi].float()
        s = torch.einsum("bkgd,bksd->bkgs", q.float(), kk) * scale
        ok = valid[lo:hi][None, None, None, :]
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m = (s.amax(-1, keepdim=True) if hi > lo else
             torch.full(s.shape[:-1] + (1,), NEG_INF, device=q.device))
        sub = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
        p = torch.where(ok, torch.exp(s - sub), torch.zeros_like(s))
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bkgs,bksd->bkgd", p,
                                 v_cache[:, :, lo:hi].float()))
    M = ms[0]
    for m in ms[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros_like(accs[0])
    for m, l, acc in zip(ms, ls, accs):
        w = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                        torch.exp(m - M))
        L = L + w * l
        A = A + w * acc
    out = (A / torch.clamp(L, min=1e-30)).to(q.dtype)
    if return_partials:
        return out, (torch.stack(ms), torch.stack(ls), torch.stack(accs))
    return out


def decode_attention_partial_ref(q, k_cache, v_cache, valid,
                                 splits: int = 1, sm_scale=None):
    """The partial mode of the flash-decode kernels (plain version): the
    float32 (m, l, acc) of :func:`decode_attention_split_ref`'s ``splits``
    ranges merged in split order. m (B, Hkv, G, 1) is the max of the valid
    logits (-1e30 where none is valid), l (B, Hkv, G, 1) the sum of
    exp(s - m) and acc (B, Hkv, G, D) the sum of exp(s - m) v (0 and 0
    where none is valid); acc / max(l, 1e-30) is the decode's output."""
    _, (ms, ls, accs) = decode_attention_split_ref(
        q, k_cache, v_cache, valid, splits, sm_scale=sm_scale,
        return_partials=True)
    M = ms[0]
    for m in ms[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros_like(accs[0])
    for m, l, acc in zip(ms, ls, accs):
        w = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                        torch.exp(m - M))
        L = L + w * l
        A = A + w * acc
    return M, L, A


def ssd_scan_ref(x, dt, A, Bm, Cm, D_skip=None):
    """Sequential Mamba2 SSD recurrence (the semantics oracle).

    x: (B, S, H, P); dt: (B, S, H) positive step sizes; A: (H,) negative
    decay rates; Bm, Cm: (B, S, G, N) with H % G == 0 (head h reads group
    ``h // (H // G)``); D_skip: (H,) or None. Returns y (B, S, H, P) in x's
    dtype::

        state_t = exp(dt_t A_h) state_{t-1} + dt_t (x_t ⊗ B_t)
        y_t     = C_t · state_t (+ D_h x_t)
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bh = torch.repeat_interleave(Bm.float(), rep, dim=2)   # (B, S, H, N)
    Ch = torch.repeat_interleave(Cm.float(), rep, dim=2)
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t] * Af)                      # (B, H)
        state = state * dA[..., None, None] + (
            dtf[:, t, :, None, None] * xf[:, t, :, :, None]
            * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, 1)
    if D_skip is not None:
        y = y + D_skip.float()[None, None, :, None] * xf
    return y.to(x.dtype)


def ssd_chunked_ref(x, dt, A, Bm, Cm, D_skip, *, chunk: int = 128,
                    return_final_state: bool = False,
                    groups: Optional[int] = None):
    """The chunked SSD scan: the plain version of ``csrc/ssd_scan.cu``.

    Shapes as in :func:`ssd_scan_ref`. The sequence is cut into chunks of
    ``L = min(chunk, S)``; a ragged tail is padded with dt = 0 and x = 0
    (B = C = 0), which leaves the state unchanged, and the padded rows are
    dropped from y. Within a chunk, with ``cum`` the inclusive cumsum of
    ``dt * A``::

        y_t    = exp(cum_t) C_t · state + sum_{s<=t} (C_t · B_s)
                 exp(min(cum_t - cum_s, 0)) dt_s x_s + D_h x_t
        state' = exp(cum_L) state + sum_s exp(cum_L - cum_s) dt_s x_s ⊗ B_s

    The chunks are walked as the kernel walks them, in groups of
    consecutive chunks (``autotune.ssd_groups`` unless ``groups`` is
    given): each group's end state from a zero start and its total decay,
    the product of its chunks' exp(cum_L); then each group's incoming state,
    summed in group order; then y, each group restarted from its incoming
    state. All groups advance together, one chunk a step. One group is the
    plain sequential chunk walk.

    Returns y (B, S, H, P) in x's dtype and, with ``return_final_state``,
    the (B, H, P, N) state after the last token; the math and the state
    are float32 (float64 for float64 inputs).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    L, nc, per, ng = autotune.ssd_groups(Bsz, H, S, chunk)
    if groups is not None:
        per = -(-nc // max(1, min(int(groups), nc)))
        ng = -(-nc // per)
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    Af = A.to(ct)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    causal = causal[None, None, :, :, None]                 # (1, 1, L, L, 1)
    pad = ng * per * L - S
    # padded steps (dt = 0, x = 0, B = C = 0) leave the state unchanged

    def grouped(t):
        t = torch.cat([t, t.new_zeros((Bsz, pad) + t.shape[2:])], 1) \
            if pad else t
        return t.reshape((Bsz, ng, per, L) + t.shape[2:])

    xg, dtg, bg, cg = (grouped(t) for t in (x, dt, Bm, Cm))

    def step(c):
        """Chunk c of every group, widened to ct (B, C repeated over
        heads): x (B, ng, L, H, P), dt, cum (B, ng, L, H), B and C
        (B, ng, L, H, N), and w = exp(cum_L - cum) dt."""
        xc, dtc = xg[:, :, c].to(ct), dtg[:, :, c].to(ct)
        bc = torch.repeat_interleave(bg[:, :, c].to(ct), rep, dim=3)
        cc = torch.repeat_interleave(cg[:, :, c].to(ct), rep, dim=3)
        cum = torch.cumsum(dtc * Af, dim=2)
        w = torch.exp(cum[:, :, -1:, :] - cum) * dtc
        return xc, dtc, cum, bc, cc, w

    def advance(state, c, xc, cum, bc, w):
        """state' of every group after its chunk c (state None: zero)."""
        new = torch.einsum("bglhp,bglhn->bghpn", xc * w[..., None], bc)
        if state is None:
            return new
        return torch.exp(cum[:, :, -1, :])[..., None, None] * state + new

    # each group's end state from a zero start, and its total decay
    incoming = torch.zeros((Bsz, ng, H, P, N), dtype=ct, device=x.device)
    if ng > 1:
        end, decay = None, None
        for c in range(per):
            xc, _, cum, bc, _, w = step(c)
            end = advance(end, c, xc, cum, bc, w)
            d = torch.exp(cum[:, :, -1, :])
            decay = d if decay is None else decay * d
        # the incoming state of group g + 1, summed in group order
        run = end[:, 0]
        incoming[:, 1] = run
        for g in range(1, ng - 1):
            run = decay[:, g][..., None, None] * run + end[:, g]
            incoming[:, g + 1] = run
    state = incoming
    ys = []
    for c in range(per):
        xc, dtc, cum, bc, cc, w = step(c)
        y_inter = torch.exp(cum)[..., None] * torch.einsum(
            "bglhn,bghpn->bglhp", cc, state)
        cb = torch.einsum("bglhn,bgshn->bglsh", cc, bc)     # (B, ng, L, L, H)
        # the exponent is clamped at 0: exact on the causal region, and
        # the masked entries cannot overflow. torch.minimum, as JAX's
        # jnp.minimum, passes half the gradient to each side at a tie
        # (clamp_max would pass all of it)
        d = cum[:, :, :, None, :] - cum[:, :, None, :, :]
        decay = torch.exp(torch.minimum(d, torch.zeros_like(d)))
        g = torch.where(causal, cb * decay * dtc[:, :, None, :, :], 0.0)
        y_intra = torch.einsum("bglsh,bgshp->bglhp", g, xc)
        state = advance(state, c, xc, cum, bc, w)
        ys.append((y_inter + y_intra
                   + D_skip.to(ct)[None, None, None, :, None] * xc
                   ).to(x.dtype))
    y = torch.stack(ys, 2).reshape((Bsz, ng * per * L, H, P))[:, :S]
    if return_final_state:
        # the last group's state after its last chunk (padding after S
        # leaves it unchanged)
        return y, state[:, -1]
    return y


def _ssd_bwd_chunks(x, dt, A, Bm, Cm, dy, L):
    """The backward's inputs cut into chunks of L rows (a ragged tail padded
    with zeros) in ct: x, dt, dy (B, nc, L, H[, P]), B and C repeated over
    heads (B, nc, L, H, N), and the chunk-local inclusive cumsum of dt A."""
    Bsz, S, H, _ = x.shape
    rep = H // Bm.shape[2]
    nc = -(-S // L)
    pad = nc * L - S
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32

    def chunks(t):
        t = torch.cat([t, t.new_zeros((Bsz, pad) + t.shape[2:])], 1) \
            if pad else t
        return t.reshape((Bsz, nc, L) + t.shape[2:]).to(ct)

    xc, dtc = chunks(x), chunks(dt)
    dyc = chunks(dy) if dy is not None else None
    bc = torch.repeat_interleave(chunks(Bm), rep, dim=3)   # (B, nc, L, H, N)
    cc = torch.repeat_interleave(chunks(Cm), rep, dim=3)
    cum = torch.cumsum(dtc * A.to(ct), dim=2)             # (B, nc, L, H)
    return xc, dtc, dyc, bc, cc, cum


def ssd_bwd_increments_ref(x, dt, A, Bm, Cm, dy, *, chunk: int = 128):
    """What each chunk of ``L = min(chunk, S)`` rows adds to the two
    recurrences of the SSD backward: ``V_c = sum_s w_s x_s (x) B_s``, the
    state it builds from zero (``w_s = exp(cum_L - cum_s) dt_s``), ``U_c =
    sum_t exp(cum_t) dy_t (x) C_t``, what it adds to the cotangent of the
    state before it, and its decay ``exp(cum_L)``: V, U (B, H, nc, P, N) and
    the decay (B, H, nc), in float32 (float64 for float64 inputs). The
    plain version of ``csrc/ssd_scan.cu``'s ``ssd_bwd_incr_kernel`` (which
    skips V of the last chunk and U of the first: nothing reads them)."""
    L = min(chunk, x.shape[1])
    xc, dtc, dyc, bc, cc, cum = _ssd_bwd_chunks(x, dt, A, Bm, Cm, dy, L)
    w = torch.exp(cum[:, :, -1:] - cum) * dtc
    V = torch.einsum("bclhp,bclhn->bhcpn", xc * w[..., None], bc)
    U = torch.einsum("bclhp,bclhn->bhcpn", dyc * torch.exp(cum)[..., None],
                     cc)
    return V, U, torch.exp(cum[:, :, -1]).transpose(1, 2)


def ssd_bwd_scan_ref(V, U, decay):
    """The two recurrences of the SSD backward over the chunks, from
    :func:`ssd_bwd_increments_ref`'s pieces: ``S_c``, the state entering
    chunk c (zero at the first; ``S_{c+1} = decay_c S_c + V_c`` in chunk
    order), and ``dS_c``, the cotangent of the state leaving it (zero after
    the last; ``dS_{c-1} = decay_c dS_c + U_c`` in reverse): two (B, H, nc,
    P, N) tensors. The plain version of ``ssd_bwd_scan_kernel``."""
    nc = V.shape[2]
    states, dstates = torch.zeros_like(V), torch.zeros_like(U)
    run = torch.zeros_like(V[:, :, 0])
    for c in range(nc - 1):
        run = decay[:, :, c, None, None] * run + V[:, :, c]
        states[:, :, c + 1] = run
    run = torch.zeros_like(U[:, :, 0])
    for c in range(nc - 1, 0, -1):
        run = decay[:, :, c, None, None] * run + U[:, :, c]
        dstates[:, :, c - 1] = run
    return states, dstates


def ssd_bwd_chunk_grads_ref(x, dt, A, Bm, Cm, D_skip, dy, states, dstates,
                            *, chunk: int = 128,
                            fwd_chunk: int | None = None):
    """Each chunk's own gradients given ``S_c`` and ``dS_c``
    (:func:`ssd_bwd_scan_ref`): dx (B, S, H, P), ddt (B, S, H) before the
    ties of :func:`ssd_chunked_bwd_ref`'s last step, each head's dB and dC
    rows (B, S, H, N), and each chunk's shares of dA and dD (B, H, nc), in
    float32 (float64 for float64 inputs), in the formulas of
    :func:`ssd_chunked_bwd_ref`. The plain version of
    ``ssd_bwd_chunk_kernel``."""
    Bsz, S, H, P = x.shape
    L = min(chunk, S)
    Lf = min(fwd_chunk or L, S)
    nc = -(-S // L)
    xc, dtc, dyc, bc, cc, cum = _ssd_bwd_chunks(x, dt, A, Bm, Cm, dy, L)
    ct = xc.dtype
    Af = A.to(ct)
    tri = torch.ones((L, L), dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]   # (t, s)
    rows = torch.arange(nc * L, device=x.device).reshape(nc, L) // Lf
    # (t, s) of one forward chunk, by chunk
    same = (rows[:, :, None] == rows[:, None, :])[:, None, :, :, None]
    dx, ddt, dBh, dCh, dA, dD = [], [], [], [], [], []
    for c in range(nc):
        xs, dts, dys, bs, cs, cm = (xc[:, c], dtc[:, c], dyc[:, c], bc[:, c],
                                    cc[:, c], cum[:, c])
        Sc, dS = states[:, :, c].to(ct), dstates[:, :, c].to(ct)
        ecum = torch.exp(cm)                               # (B, L, H)
        cumL = cm[:, -1]                                   # (B, H)
        eL = torch.exp(cumL)
        back = torch.exp(cumL[:, None] - cm)               # exp(cum_L - cum)
        w = back * dts
        d = cm[:, :, None, :] - cm[:, None, :, :]          # (B, t, s, H)
        e = torch.exp(torch.minimum(d, torch.zeros_like(d)))
        f = torch.where(same[c], torch.where(d < 0, 1.0, torch.where(
            d == 0, 0.5, 0.0)), 1.0).to(ct)
        cb = torch.einsum("bthn,bshn->btsh", cs, bs)       # C_t.B_s
        dxy = torch.einsum("bthp,bshp->btsh", dys, xs)     # dy_t.x_s
        dt_s = dts[:, None, :, :]
        m1 = torch.where(tri, cb * e, 0.0)                 # (C_t.B_s) e_ts
        m2 = torch.where(tri, e * dt_s * dxy, 0.0)         # e_ts dt_s dy_t.x_s
        gf = torch.where(tri, cb * e * dt_s * dxy * f, 0.0)
        direct = (m1 * dxy).sum(1)                         # (B, s, H)
        r = torch.einsum("btsh,bthp->bshp", m1, dys)
        v = torch.einsum("bhpn,bshn->bshp", dS, bs)
        dx.append(D_skip.to(ct)[None, None, :, None] * dys
                  + dts[..., None] * r + w[..., None] * v)
        z = torch.einsum("bthp,bhpn->bthn", dys, Sc)       # S_c^T dy_t
        dCh.append(torch.einsum("btsh,bshn->bthn", m2, bs)
                   + ecum[..., None] * z)
        u = torch.einsum("bhpn,bshp->bshn", dS, xs)        # dS^T x_s
        dBh.append(torch.einsum("btsh,bthn->bshn", m2, cs) + w[..., None] * u)
        q = (bs * u).sum(-1)                               # (B, s, H)
        dcum = ecum * (cs * z).sum(-1) + gf.sum(2) - gf.sum(1) - w * q
        dcum[:, -1] = dcum[:, -1] + eL * (dS * Sc).sum((-2, -1)) + (w * q).sum(1)
        da = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        ddt.append(da * Af + direct + back * q)
        dA.append((da * dts).sum(1))
        dD.append((dys * xs).sum((1, 3)))

    def whole(parts):
        t = torch.stack(parts, 1)
        return t.reshape((Bsz, nc * L) + t.shape[3:])[:, :S]

    return (whole(dx), whole(ddt), whole(dBh), whole(dCh),
            torch.stack(dA, 2), torch.stack(dD, 2))


def ssd_chunked_bwd_ref(x, dt, A, Bm, Cm, D_skip, dy, *, chunk: int = 128,
                        fwd_chunk: int | None = None):
    """The gradient of :func:`ssd_chunked_ref`'s y for the cotangent ``dy``
    (B, S, H, P): ``(dx, ddt, dA, dB, dC, dD)``, each in its input's dtype.
    The plain version of ``csrc/ssd_scan.cu``'s backward, in its formulas
    and the order of its steps (the gradient ``jax.grad`` takes of the JAX
    package's ``ops._ssd_xla_chunked``; the final state has no cotangent).

    The sequence is cut into chunks of ``L = min(chunk, S)`` rows (a ragged
    tail padded with zeros, as in the forward). ``S_c`` is the state
    entering chunk c, ``dS_c`` the cotangent of the state leaving it (zero
    after the last), ``cum`` the inclusive cumsum of ``dt * A`` in the
    chunk, ``e_ts = exp(min(cum_t - cum_s, 0))`` and ``w_s = exp(cum_L -
    cum_s) dt_s``. Both recurrences are linear::

        S_{c+1}  = exp(cum_L) S_c + sum_s w_s x_s (x) B_s
        dS_{c-1} = exp(cum_L) dS_c + sum_t exp(cum_t) dy_t (x) C_t

    so each chunk's increments come first (:func:`ssd_bwd_increments_ref`),
    then both scans (:func:`ssd_bwd_scan_ref`), then each chunk's own
    gradients from its two states (:func:`ssd_bwd_chunk_grads_ref`)::

        dx_s  = D dy_s + dt_s sum_{t>=s} (C_t.B_s) e_ts dy_t + w_s dS_c B_s
        dB_s  = sum_{t>=s} e_ts dt_s (dy_t.x_s) C_t + w_s dS_c^T x_s
        dC_t  = exp(cum_t) S_c^T dy_t + sum_{s<=t} e_ts dt_s (dy_t.x_s) B_s
        dcum_t = exp(cum_t) C_t.(S_c^T dy_t) + sum_s G_ts f_ts
                 - sum_u G_ut f_ut - w_t q_t,  q_s = B_s.(dS_c^T x_s)
        dcum_L += exp(cum_L) <dS_c, S_c> + sum_s w_s q_s

    with ``G_ts = (C_t.B_s) e_ts dt_s (dy_t.x_s)`` on ``t >= s`` and the
    clamp's gradient ``f_ts`` 1 below 0, 0.5 at a tie (JAX's) and 0 above.
    Then ``da_t = sum_{u>=t} dcum_u`` in the chunk, ``ddt_t = da_t A +
    sum_{u>=t} (C_u.B_t) e_ut (dy_u.x_t) + exp(cum_L - cum_t) q_t``, ``dA =
    sum da_t dt_t`` and ``dD = sum dy.x``. dB and dC sum the heads of each
    group in head order, dA and dD the batch, then the chunks. The math is
    float32 (float64 for float64 inputs).

    The gradient is that of the forward in chunks of ``fwd_chunk`` rows
    (``chunk`` when None), whose clamp acts within them: a pair of one
    chunk here that lies in two forward chunks takes ``f_ts = 1``, and a
    tied pair of one forward chunk across a boundary ``bd`` here, which
    the state gives the state's 1, gives half back: ``da_u -= 0.5
    sum_{s<u<=t} G_ts``, so ``ddt_u`` gains that times A and dA that
    times ``dt_u``. Such a pair ties where s's chunk-local ``cum`` is flat
    after s and ``dt A`` is 0 on the rows from bd to t.
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    L = min(chunk, S)
    Lf = min(fwd_chunk or L, S)
    if Lf < L:
        raise ValueError(f"the forward's chunk {Lf} is under the backward's "
                         f"{L}")
    states, dstates = ssd_bwd_scan_ref(*ssd_bwd_increments_ref(
        x, dt, A, Bm, Cm, dy, chunk=L))
    dx, ddt, dBh, dCh, dAc, dDc = ssd_bwd_chunk_grads_ref(
        x, dt, A, Bm, Cm, D_skip, dy, states, dstates, chunk=L, fwd_chunk=Lf)
    dA, dD = dAc.sum(2), dDc.sum(2)                        # (B, H)
    if Lf > L:
        ct = dx.dtype
        _, _, _, bc, cc, cum = _ssd_bwd_chunks(x, dt, A, Bm, Cm, None, L)
        dA = dA + _ssd_tie_halves(x.to(ct), dt.to(ct), A.to(ct), bc, cc,
                                  dy.to(ct), cum, ddt, L, Lf)

    def by_group(t):   # the heads of each group, summed in head order
        t = t.reshape(Bsz, S, G, rep, N)
        out = t[:, :, :, 0]
        for k in range(1, rep):
            out = out + t[:, :, :, k]
        return out.to(Bm.dtype)

    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.sum(0).to(A.dtype),
            by_group(dBh), by_group(dCh).to(Cm.dtype),
            dD.sum(0).to(D_skip.dtype))


def _ssd_tie_halves(x, dt, A, bc, cc, dy, cum, ddt, L, Lf):
    """:func:`ssd_chunked_bwd_ref`'s ties across its chunk boundaries inside
    a forward chunk: ``ddt`` (B, S, H) takes its share in place; returns
    dA's (B, H). ``bc``, ``cc`` are the chunked B and C by head, ``cum``
    the chunked cumsum."""
    Bsz, S, H, _ = x.shape
    a = dt * A
    bh = bc.reshape((Bsz, -1) + bc.shape[3:])[:, :S]       # (B, S, H, N)
    ch = cc.reshape((Bsz, -1) + cc.shape[3:])[:, :S]
    dA = torch.zeros((Bsz, H), dtype=x.dtype, device=x.device)
    for bd in range(L, S, L):
        if bd % Lf == 0:
            continue
        f0 = bd - bd % Lf
        f1, c0 = min(f0 + Lf, S), max(f0, bd - L)
        # t in [bd, q): a = 0 from bd; s in [c0, bd): cum flat after s
        tz = torch.cumprod((a[:, bd:f1] == 0).to(x.dtype), 1)
        if not bool(tz[:, 0].any()):
            continue
        cm = cum[:, bd // L - 1]
        sok = (cm[:, c0 - (bd - L):] == cm[:, -1:]).to(x.dtype)
        g = (torch.einsum("bthn,bshn->btsh", ch[:, bd:f1], bh[:, c0:bd])
             * torch.einsum("bthp,bshp->btsh", dy[:, bd:f1], x[:, c0:bd])
             * (dt[:, c0:bd] * sok)[:, None] * tz[:, :, None])
        R, K = g.sum(1), g.sum(2)                    # (B, s, H), (B, t, H)
        corr_s = -0.5 * (torch.cumsum(R, 1) - R)      # -0.5 sum_{s<u} R_s
        corr_t = -0.5 * torch.flip(torch.cumsum(torch.flip(K, [1]), 1), [1])
        ddt[:, c0:bd] += corr_s * A
        ddt[:, bd:f1] += corr_t * A
        dA = dA + (corr_s * dt[:, c0:bd]).sum(1) \
            + (corr_t * dt[:, bd:f1]).sum(1)
    return dA
