// Per-family device math of the frontier kernels.
//
// This header is the CUDA twin of the family_* functions in
// repro_torch/core/distributions.py (effective moments, CDF, adjoint parts,
// coefficients, parameter coefficients, dreach and dreach_params) for the
// five families normal, lognormal, drift, empirical and defective; the two
// must change together. Expressions keep the plain version's operation
// order, and the library is built with --fmad=false, so every float32
// operation rounds as the plain version's separate tensor operations do
// (erff, logf, expf are the functions torch calls on the card). Phi keeps
// the 0.5 * (1 + erf(x / sqrt 2)) form: the adjoint's gate depends on
// exactly where that expression saturates to 1.0 in float32, and another
// formula would move that edge. Build without --use_fast_math: the floor
// 1e-37 and the ratios D / C pass near or through subnormals.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fg {

enum Fam : int { NORMAL = 0, LOGNORMAL = 1, DRIFT = 2, EMPIRICAL = 3,
                 DEFECTIVE = 4 };

constexpr int EMP_C = 3;
constexpr int MAX_E = 3 * EMP_C;
constexpr float INV_SQRT2 = 0.7071067811865476f;
constexpr float INV_SQRT_2PI = 0.3989422804014327f;
constexpr float TINY = 1e-20f;
constexpr float CDF_FLOOR = 1e-37f;
constexpr float P_CLAMP = (float)(1.0 - 1e-6);

__device__ __forceinline__ float Phi(float x) {
  return 0.5f * (1.0f + erff(x * INV_SQRT2));
}

__device__ __forceinline__ float phi(float x) {
  return expf(-0.5f * x * x) * INV_SQRT_2PI;
}

// Accumulator basis (use_1, use_t, use_z) of the fused adjoint, for the
// W-only (P = false) and the full-parameter (P = true) launch.
template <int FAM, bool P> struct Feat;
template <> struct Feat<NORMAL, false> { static constexpr bool u1 = false, ut = true, uz = false; };
template <> struct Feat<LOGNORMAL, false> { static constexpr bool u1 = true, ut = false, uz = false; };
template <> struct Feat<DRIFT, false> { static constexpr bool u1 = true, ut = true, uz = false; };
template <> struct Feat<EMPIRICAL, false> { static constexpr bool u1 = false, ut = true, uz = false; };
template <> struct Feat<DEFECTIVE, false> { static constexpr bool u1 = false, ut = true, uz = false; };
template <> struct Feat<NORMAL, true> { static constexpr bool u1 = true, ut = true, uz = false; };
template <> struct Feat<LOGNORMAL, true> { static constexpr bool u1 = true, ut = false, uz = true; };
template <> struct Feat<DRIFT, true> { static constexpr bool u1 = true, ut = true, uz = false; };
template <> struct Feat<EMPIRICAL, true> { static constexpr bool u1 = false, ut = true, uz = false; };
template <> struct Feat<DEFECTIVE, true> { static constexpr bool u1 = true, ut = true, uz = true; };

template <int FAM> __host__ __device__ constexpr int extra_rows() {
  return FAM == EMPIRICAL ? MAX_E : (FAM == DEFECTIVE ? 2 : 1);
}

// One channel's raw statistics for one candidate row.
struct Raw {
  float w, mu, sg;
  float e[MAX_E];
};

// Channel statistics are shared (per_row == 0: mus/sigmas (K,), extra
// (E, K)) or per row (mus/sigmas (F, K), extra (E, F, K)).
template <int FAM>
__device__ __forceinline__ Raw load_raw(const float* __restrict__ W,
                                        const float* __restrict__ mus,
                                        const float* __restrict__ sgs,
                                        const float* __restrict__ ex, int f,
                                        int k, int F, int K, int per_row) {
  Raw r;
  const long long fk = (long long)f * K + k;
  const long long sk = per_row ? fk : (long long)k;
  r.w = W[fk];
  r.mu = mus[sk];
  r.sg = sgs[sk];
#pragma unroll
  for (int e = 0; e < extra_rows<FAM>(); ++e)
    r.e[e] = per_row ? ex[((long long)e * F + f) * K + k]
                     : ex[(long long)e * K + k];
  return r;
}

__device__ __forceinline__ void lognormal_shape(float mu, float sg,
                                                float& s_l, float& base) {
  const float safe_mu = mu > 0.0f ? mu : 1.0f;
  const float rr = sg / safe_mu;
  const float s2 = log1pf(rr * rr);
  s_l = sqrtf(s2);
  base = logf(safe_mu) - 0.5f * s2;
}

__device__ __forceinline__ void defective_ab(float mu, float sg, float p_raw,
                                             float lam, float& a, float& b) {
  const float p = fminf(p_raw, P_CLAMP);
  const float q = 1.0f - p;
  const float ratio = p / q;
  a = mu * (1.0f + lam * ratio);
  const float lm = lam * mu;
  const float b2 = sg * sg * (1.0f + lam * lam * ratio) + lm * lm * ratio / q;
  b = sqrtf(fmaxf(b2, 0.0f));
}

__device__ __forceinline__ void mixture_stats(const float* e, float& m_mix,
                                              float& s_mix) {
  float m = 0.0f, e2 = 0.0f;
#pragma unroll
  for (int c = 0; c < EMP_C; ++c) {
    const float p = e[c], mc = e[EMP_C + c], sc = e[2 * EMP_C + c];
    m = m + p * mc;
    e2 = e2 + p * (sc * sc + mc * mc);
  }
  m_mix = m;
  s_mix = sqrtf(fmaxf(e2 - m * m, 0.0f));
}

__device__ __forceinline__ float drift_scale(float w, float rho) {
  return w * (1.0f + 0.5f * rho * w);
}

template <int FAM>
__device__ __forceinline__ void effective(const Raw& r, float& mean,
                                          float& std) {
  if (FAM == NORMAL || FAM == LOGNORMAL) {
    mean = r.w * r.mu;
    std = r.w * r.sg;
  } else if (FAM == DRIFT) {
    mean = r.mu * drift_scale(r.w, r.e[0]);
    std = r.w * r.sg;
  } else if (FAM == DEFECTIVE) {
    float a, b;
    defective_ab(r.mu, r.sg, r.e[0], r.e[1], a, b);
    mean = r.w * a;
    std = r.w * b;
  } else {
    float m, s;
    mixture_stats(r.e, m, s);
    mean = r.w * m;
    std = r.w * s;
  }
}

// reach = mean + z * std, rounded the same way at every call site (the
// argmax tie test compares reaches bit for bit)
template <int FAM>
__device__ __forceinline__ float reach(const Raw& r, float z) {
  float mean, std;
  effective<FAM>(r, mean, std);
  return __fadd_rn(mean, __fmul_rn(z, std));
}

template <int FAM>
__device__ __forceinline__ bool family_ok(const Raw& r) {
  if (FAM == LOGNORMAL) return r.w > 0.0f && r.sg > 0.0f && r.mu > 0.0f;
  if (FAM == EMPIRICAL) {
    float m, s;
    mixture_stats(r.e, m, s);
    return r.w > 0.0f && s > 0.0f;
  }
  if (FAM == DEFECTIVE) {
    float a, b;
    defective_ab(r.mu, r.sg, r.e[0], r.e[1], a, b);
    return r.w * b > 0.0f;
  }
  return r.w * r.sg > 0.0f;
}

// Per-channel constants of the CDF and adjoint-part evaluation, built once
// per (row, channel) and read for every grid point.
template <int FAM> struct Chan {
  float loc, base, den, m_eff, ok;
};
template <> struct Chan<EMPIRICAL> {
  float m_eff, ok;
  float pi[EMP_C], mc[EMP_C], dc[EMP_C], pdw[EMP_C], cok[EMP_C];
};

template <int FAM>
__device__ __forceinline__ Chan<FAM> make_chan(const Raw& r) {
  Chan<FAM> c;
  const bool ok = family_ok<FAM>(r);
  c.ok = ok ? 1.0f : 0.0f;
  c.base = 0.0f;
  if (FAM == NORMAL) {
    c.loc = r.w * r.mu;
    c.den = ok ? r.w * r.sg : 1.0f;
    c.m_eff = r.w * r.mu;
  } else if (FAM == LOGNORMAL) {
    float s_l, base;
    lognormal_shape(r.mu, r.sg, s_l, base);
    c.loc = logf(r.w > 0.0f ? r.w : 1.0f);
    c.base = base;
    c.den = ok ? s_l : 1.0f;
    c.m_eff = r.w * r.mu;
  } else if (FAM == DRIFT) {
    const float m_d = r.mu * drift_scale(r.w, r.e[0]);
    c.loc = m_d;
    c.den = ok ? r.w * r.sg : 1.0f;
    c.m_eff = m_d;
  } else {
    float a, b;
    defective_ab(r.mu, r.sg, r.e[0], r.e[1], a, b);
    c.loc = r.w * a;
    c.den = ok ? r.w * b : 1.0f;
    c.m_eff = r.w * a;
  }
  return c;
}

template <>
__device__ __forceinline__ Chan<EMPIRICAL> make_chan<EMPIRICAL>(const Raw& r) {
  Chan<EMPIRICAL> c;
  float m, s;
  mixture_stats(r.e, m, s);
  const bool ok = r.w > 0.0f && s > 0.0f;
  c.ok = ok ? 1.0f : 0.0f;
  c.m_eff = r.w * m;
#pragma unroll
  for (int k = 0; k < EMP_C; ++k) {
    const float pi = r.e[k], mk = r.e[EMP_C + k], sk = r.e[2 * EMP_C + k];
    const bool cok = ok && sk > 0.0f;
    c.pi[k] = pi;
    c.mc[k] = r.w * mk;
    c.dc[k] = cok ? r.w * sk : 1.0f;
    c.pdw[k] = cok ? pi / sk : 0.0f;
    c.cok[k] = cok ? 1.0f : 0.0f;
  }
  return c;
}

// Standardized score; lt = log(max(t, 1e-20)) is shared by all channels.
template <int FAM>
__device__ __forceinline__ float zscore(const Chan<FAM>& c, float t, float lt) {
  if (FAM == LOGNORMAL) return (lt - c.loc - c.base) / c.den;
  return (t - c.loc) / c.den;
}

// CDF with degenerate denominators substituted (the adjoint's cdf_raw).
template <int FAM>
__device__ __forceinline__ float cdf_raw(const Chan<FAM>& c, float t, float lt) {
  return Phi(zscore<FAM>(c, t, lt));
}

template <>
__device__ __forceinline__ float cdf_raw<EMPIRICAL>(const Chan<EMPIRICAL>& c,
                                                    float t, float) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < EMP_C; ++k) {
    const float ck = c.cok[k] != 0.0f ? Phi((t - c.mc[k]) / c.dc[k])
                                      : (t >= c.mc[k] ? 1.0f : 0.0f);
    acc = acc + c.pi[k] * ck;
  }
  return acc;
}

// The family CDF: a right-continuous point mass on degenerate channels.
template <int FAM>
__device__ __forceinline__ float cdf(const Chan<FAM>& c, float t, float lt) {
  if (c.ok == 0.0f) return t >= c.m_eff ? 1.0f : 0.0f;
  return cdf_raw<FAM>(c, t, lt);
}

// Adjoint parts (cdf_raw, D, z) of a non-degenerate channel.
template <int FAM>
__device__ __forceinline__ void adjoint_parts(const Chan<FAM>& c, float t,
                                              float lt, float& craw, float& D,
                                              float& z) {
  z = zscore<FAM>(c, t, lt);
  craw = Phi(z);
  D = phi(z);
}

template <>
__device__ __forceinline__ void adjoint_parts<EMPIRICAL>(
    const Chan<EMPIRICAL>& c, float t, float, float& craw, float& D,
    float& z) {
  float acc = 0.0f, d = 0.0f;
#pragma unroll
  for (int k = 0; k < EMP_C; ++k) {
    const float zk = (t - c.mc[k]) / c.dc[k];
    const float ck = c.cok[k] != 0.0f ? Phi(zk) : (t >= c.mc[k] ? 1.0f : 0.0f);
    acc = acc + c.pi[k] * ck;
    d = d + c.pdw[k] * phi(zk);
  }
  craw = acc;
  D = d;
  z = 0.0f;
}

// (alpha, beta, gamma0, gamma1): dC/dw = D (alpha + beta t),
// dC/dt = D (gamma0 + gamma1 t) / t; zero on degenerate channels.
template <int FAM>
__device__ __forceinline__ void coeffs(const Raw& r, float& al, float& be,
                                       float& g0, float& g1) {
  const bool ok = family_ok<FAM>(r);
  al = be = g0 = g1 = 0.0f;
  if (!ok) return;
  const float w = r.w;
  if (FAM == NORMAL) {
    be = -(1.0f / (w * w * r.sg));
    g1 = 1.0f / (w * r.sg);
  } else if (FAM == LOGNORMAL) {
    float s_l, base;
    lognormal_shape(r.mu, r.sg, s_l, base);
    al = -(1.0f / (w * s_l));
    g0 = 1.0f / s_l;
  } else if (FAM == DRIFT) {
    al = -0.5f * r.e[0] * r.mu / r.sg;
    be = -(1.0f / (w * w * r.sg));
    g1 = 1.0f / (w * r.sg);
  } else if (FAM == DEFECTIVE) {
    float a, b;
    defective_ab(r.mu, r.sg, r.e[0], r.e[1], a, b);
    be = -(1.0f / (w * w * b));
    g1 = 1.0f / (w * b);
  } else {
    be = -(1.0f / (w * w));
    g1 = 1.0f / w;
  }
}

// Coefficient triples (1, t, z) of d log C / d theta for theta = mu, sigma
// and extra row 0; all zero on degenerate channels and for the empirical
// family (its mixture never reads mus or sigmas).
template <int FAM>
__device__ __forceinline__ void param_coeffs(const Raw& r, float* cm,
                                             float* cs, float* ce) {
#pragma unroll
  for (int i = 0; i < 3; ++i) cm[i] = cs[i] = ce[i] = 0.0f;
  if (!family_ok<FAM>(r)) return;
  const float w = r.w, mu = r.mu, sg = r.sg;
  if (FAM == NORMAL) {
    const float inv_s = 1.0f / sg;
    const float inv_ws2 = 1.0f / (w * sg * sg);
    cm[0] = -inv_s;
    cs[0] = mu * inv_s * inv_s;
    cs[1] = -inv_ws2;
  } else if (FAM == LOGNORMAL) {
    const float safe_mu = mu > 0.0f ? mu : 1.0f;
    const float safe_sg = sg > 0.0f ? sg : 1.0f;
    const float rr = sg / safe_mu;
    const float v = rr * rr;
    float s_l, base;
    lognormal_shape(mu, sg, s_l, base);
    const float rv = v / (1.0f + v);
    const float dbase_dmu = (1.0f + rv) / safe_mu;
    const float dsl_dmu = -rv / (safe_mu * s_l);
    const float dbase_dsg = -rv / safe_sg;
    const float dsl_dsg = rv / (safe_sg * s_l);
    cm[0] = -dbase_dmu / s_l;
    cm[2] = -dsl_dmu / s_l;
    cs[0] = -dbase_dsg / s_l;
    cs[2] = -dsl_dsg / s_l;
  } else if (FAM == DRIFT) {
    const float g = drift_scale(w, r.e[0]);
    const float inv_ws = 1.0f / (w * sg);
    const float inv_ws2 = 1.0f / (w * sg * sg);
    cm[0] = -g * inv_ws;
    cs[0] = mu * g * inv_ws2;
    cs[1] = -inv_ws2;
    ce[0] = -0.5f * mu * w / sg;
  } else if (FAM == DEFECTIVE) {
    const float p = fminf(r.e[0], P_CLAMP);
    const float lam = r.e[1];
    const float q = 1.0f - p;
    const float ratio = p / q;
    float a, b;
    defective_ab(mu, sg, r.e[0], lam, a, b);
    const float inv_b = 1.0f / b;
    const float inv_b2 = inv_b * inv_b;
    const float da_dmu = 1.0f + lam * ratio;
    const float db_dmu_b = lam * lam * mu * (ratio / q) * inv_b2;
    const float db_dsg_b = sg * (1.0f + lam * lam * ratio) * inv_b2;
    const float da_dp = mu * lam / (q * q);
    const float db2_dp =
        lam * lam * (sg * sg / (q * q) + mu * mu * (1.0f + p) / (q * q * q));
    const float db_dp_b = 0.5f * db2_dp * inv_b2;
    cm[0] = -da_dmu * inv_b;
    cm[2] = -db_dmu_b;
    cs[2] = -db_dsg_b;
    ce[0] = -da_dp * inv_b;
    ce[2] = -db_dp_b;
  }
}

// d reach / dw
template <int FAM>
__device__ __forceinline__ float dreach_w(const Raw& r, float z) {
  if (FAM == NORMAL || FAM == LOGNORMAL) return r.mu + z * r.sg;
  if (FAM == DRIFT) return r.mu * (1.0f + r.e[0] * r.w) + z * r.sg;
  if (FAM == DEFECTIVE) {
    float a, b;
    defective_ab(r.mu, r.sg, r.e[0], r.e[1], a, b);
    return a + z * b;
  }
  float m, s;
  mixture_stats(r.e, m, s);
  return m + z * s;
}

// (d reach / dmu, d reach / dsigma, d reach / d extra row 0)
template <int FAM>
__device__ __forceinline__ void dreach_params(const Raw& r, float z, float& dm,
                                              float& ds, float& de) {
  const float w = r.w, mu = r.mu, sg = r.sg;
  dm = ds = de = 0.0f;
  if (FAM == NORMAL || FAM == LOGNORMAL) {
    dm = w;
    ds = z * w;
  } else if (FAM == DRIFT) {
    dm = drift_scale(w, r.e[0]);
    ds = z * w;
    de = 0.5f * mu * w * w;
  } else if (FAM == DEFECTIVE) {
    const float p = fminf(r.e[0], P_CLAMP);
    const float lam = r.e[1];
    const float q = 1.0f - p;
    const float ratio = p / q;
    float a, b;
    defective_ab(mu, sg, r.e[0], lam, a, b);
    const bool b_ok = b > 0.0f;
    const float inv_b = 1.0f / (b_ok ? b : 1.0f);
    const float db_dmu = b_ok ? lam * lam * mu * (ratio / q) * inv_b : 0.0f;
    const float db_dsg = b_ok ? sg * (1.0f + lam * lam * ratio) * inv_b : 0.0f;
    const float db2_dp =
        lam * lam * (sg * sg / (q * q) + mu * mu * (1.0f + p) / (q * q * q));
    const float db_dp = b_ok ? 0.5f * db2_dp * inv_b : 0.0f;
    dm = w * ((1.0f + lam * ratio) + z * db_dmu);
    ds = w * z * db_dsg;
    de = w * (mu * lam / (q * q) + z * db_dp);
  }
}

}  // namespace fg
