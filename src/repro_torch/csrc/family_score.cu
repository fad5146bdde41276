// Online family selection on the card: the per-channel part of
// core/bayes.py::score_families and its Gaussian-mixture EM (_em_batch),
// then the fleet's BIC sums, for Hopper (sm_90a).
//
// Replaces, on the card, the host numpy of the port's core/bayes.py (the
// kernel's plain version, bitwise the JAX package's repro/core/bayes.py,
// which also runs it as numpy on the host; there is no Pallas kernel for
// it). Inputs: (N, K) float64 windows of rates, the work shares they were
// observed under and validity masks (N observations a channel, K
// channels). Per channel, as the numpy does it:
//   float64: the masked moments, the normal log-likelihood with its floor,
//   the lognormal one on log rates with the Jacobian and the deficit of
//   nonpositive rates, the drift regression rate = a + b w (det_ok guard,
//   b >= 0) with rho = 2 b / a clipped to [0, max_rho];
//   float32: the C-component mixture EM, quantile starts from the sorted
//   valid samples, 16 iterations (float32 E-step, float64 log-likelihood),
//   floored variances, the components sorted by mean at the end.
// Then over channels: BIC = sum over channels with at least min_obs
// observations of k ln n - 2 ln L, one per family, and the pooled component
// that channels below min_obs get.
//
// Numerics follow the numpy: every sum over observations runs in
// observation order from zero (numpy's reduction over the leading axis of
// an (N, K) array), in float32 where the numpy's arrays are float32, and
// the BIC sums over channels are numpy's pairwise summation (blocks of 8
// accumulators up to 128 terms, halves above), the float32 exp and log are
// numpy's own algorithms (np_expf, np_logf). Built with --fmad=false,
// maxima propagate NaN as np.maximum does. The pooled statistics sum in
// a fixed tree order of their own (float64; numpy sums them pairwise over
// the flattened window).
//
// What bounds it: operations on one SM's latency, not bytes. The window is
// 3 N K float64 (2.4 MB at N = 96, K = 1024); each channel runs 16 EM
// iterations of 3 components over its N samples (an exp and a log a sample
// and component, ~3 N K C 16 = 14e6 float32 operations at the tick), so
// the card's bound is microseconds. The cost that matters is the host's:
// the numpy pass took ~41-46 ms a tick; here it is two launches and one
// copy back. Design: one block per channel, the channel's window in
// shared memory (44 N bytes); the E-step spreads samples over the block,
// each of the M-step's 3 C sums over samples is one thread walking them in
// order (the numpy's order), the starts rank each valid sample by counting
// in shared memory. A second launch (one block) sums the channels. No
// atomics: the result depends on the inputs alone.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kC = 3;               // EMP_COMPONENTS
constexpr int kIters = 16;          // _em_batch's iterations
constexpr int kThreads = 128;
constexpr int kReduceThreads = 256;
constexpr int kHead = 8;            // bics (4), n_channels, unused (3)
constexpr int kMaxN = 4096;
constexpr double kLog2Pi = 1.8378770664093453;  // float(np.log(2 pi))
constexpr float kTwoPiF = 6.283185307179586f;   // 2 * np.pi as float32
constexpr float kVarFloorFrac = 1e-3f;

// np.maximum / np.minimum: NaN wins
__device__ __forceinline__ double npmax(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float npmaxf(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ double npmin(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// numpy's float32 exp and log (its SIMD loops on AVX2/FMA3 and AVX512F
// CPUs), operation for operation: the EM amplifies an ulp of difference in
// a responsibility into ~1e-4 of a fitted weight over its 16 iterations,
// so the kernel computes the numpy's bits rather than CUDA's expf/logf.
// exp: x = q ln2 + r with q = rint(x log2(e)) (Cody-Waite in two fused
// steps), exp(r) as a rational minimax polynomial (5/2, Horner with fused
// multiply-adds), scaled by 2^q; log: x = m 2^k with m in (sqrt(1/2),
// sqrt(2)], log(m) as a rational polynomial (5/5) in m - 1, plus k ln2.
__device__ __forceinline__ float np_expf(float x) {
  if (x != x) return x;
  if (x >= 88.72283935546875f) return INFINITY;
  if (x <= -103.97208404541015625f) return 0.f;
  float q = x * 1.44269502162933349609375f;      // log2(e) as float32
  q = (q + 12582912.f) - 12582912.f;            // rint, 1.5 * 2^23
  float r = fmaf(q, -6.93145752e-1f, x);
  r = fmaf(q, -1.42860677e-6f, r);
  float num = fmaf(5.082762527590693718096e-04f, r,
                   6.757896990527504603057e-03f);
  num = fmaf(num, r, 5.114512081637298353406e-02f);
  num = fmaf(num, r, 2.473615434895520810817e-01f);
  num = fmaf(num, r, 7.257664613233124478488e-01f);
  num = fmaf(num, r, 9.999999999980870924916e-01f);
  float den = fmaf(2.159509375685829852307e-02f, r,
                   -2.742335390411667452936e-01f);
  den = fmaf(den, r, 1.f);
  return ldexpf(num / den, (int)q);
}

__device__ __forceinline__ float np_logf(float x) {
  if (x != x) return x;
  if (x < 0.f) return NAN;
  if (x == 0.f) return -INFINITY;
  if (isinf(x)) return INFINITY;
  int e;
  float m = frexpf(x, &e);                      // m in [0.5, 1)
  if (m <= 0.707106769084930419921875f) {       // sqrt(1/2) as float32
    m = m * 2.f;
    e -= 1;
  }
  const float r = m - 1.f;
  float num = fmaf(2.589979117907922693523e-02f, r,
                   3.808837741388407920751e-01f);
  num = fmaf(num, r, 1.480000633576506585156e+00f);
  num = fmaf(num, r, 2.112677543073053063722e+00f);
  num = fmaf(num, r, 9.999999999999998702752e-01f);
  num = fmaf(num, r, 0.f);
  float den = fmaf(5.875095403124574342950e-03f, r,
                   1.546476374983906719538e-01f);
  den = fmaf(den, r, 9.864942958519418960339e-01f);
  den = fmaf(den, r, 2.453006071784736363091e+00f);
  den = fmaf(den, r, 2.612677543073109236779e+00f);
  den = fmaf(den, r, 1.f);
  return fmaf((float)e, 0.693147182464599609375f, num / den);
}

// _gauss_loglik: -n/2 (ln 2 pi max(var, floor) + 1)
__device__ __forceinline__ double gauss_ll(double n, double var,
                                           double floor) {
  return (-0.5 * n) * ((kLog2Pi + log(npmax(var, floor))) + 1.0);
}

// numpy's pairwise summation of x[0 .. n) (stride 1), from 0.0
__device__ double pairwise_sum(const double* x, int n) {
  // the recursion is at most log2(n / 128) deep
  if (n < 8) {
    double res = 0.0;
    for (int i = 0; i < n; ++i) res += x[i];
    return res;
  }
  if (n <= 128) {
    double r[8];
    for (int j = 0; j < 8; ++j) r[j] = x[j];
    int i = 8;
    for (; i < n - (n % 8); i += 8)
      for (int j = 0; j < 8; ++j) r[j] += x[i + j];
    double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) +
                                                    (r[6] + r[7]));
    for (; i < n; ++i) res += x[i];
    return res;
  }
  int n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(x, n2) + pairwise_sum(x + n2, n - n2);
}

struct ChannelShared {
  double okf, n_all;
  double s[8];        // n, sum r m, n_ln, sum logs m_ln, jac, sw, sww, swr
  double mean, mean_ln, a, b, var, var_ln, var_d;
  float n32, sx32, mean32, var32;
  float nf, floor32;
  int q[kC];
  float qval[kC];
  float mu[kC], var_c[kC], pi[kC], lv[kC], lp[kC];
  float sums[kC][3];
  double ll;
};

__global__ void __launch_bounds__(kThreads)
family_channel_kernel(int N, int K, const double* __restrict__ rates,
                      const double* __restrict__ works,
                      const double* __restrict__ mask, double min_obs,
                      double max_rho, double* __restrict__ terms,
                      double* __restrict__ okv, double* __restrict__ out) {
  extern __shared__ double smem[];
  double* sr = smem;            // rates (N)
  double* sw = sr + N;          // works, then the E-step's ln L terms
  double* sm = sw + N;          // mask * ok
  float* x = reinterpret_cast<float*>(sm + N);  // rates as float32
  float* m32 = x + N;                           // mask * ok as float32
  float* rr = m32 + N;                          // (C, N) responsibilities
  __shared__ ChannelShared cs;
  const int k = blockIdx.x;
  const int tid = threadIdx.x;

  for (int n = tid; n < N; n += kThreads) {
    sr[n] = rates[(size_t)n * K + k];
    sw[n] = works[(size_t)n * K + k];
    sm[n] = mask[(size_t)n * K + k];
  }
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int n = 0; n < N; ++n) s += sm[n];
    cs.n_all = s;
    cs.okf = s >= min_obs ? 1.0 : 0.0;
  }
  __syncthreads();
  for (int n = tid; n < N; n += kThreads) {
    sm[n] = sm[n] * cs.okf;
    x[n] = (float)sr[n];
    m32[n] = (float)sm[n];
  }
  __syncthreads();

  // first-order sums, one thread each, in observation order
  if (tid < 8) {
    double s = 0.0;
    for (int n = 0; n < N; ++n) {
      const double r = sr[n], w = sw[n], m = sm[n];
      const double pos = r > 0.0 ? 1.0 : 0.0;
      const double logs = log(r > 0.0 ? r : 1.0);
      switch (tid) {
        case 0: s += m; break;
        case 1: s += r * m; break;
        case 2: s += m * pos; break;
        case 3: s += logs * (m * pos); break;
        case 4: s += (-logs) * (m * pos); break;
        case 5: s += w * m; break;
        case 6: s += (w * w) * m; break;
        default: s += (w * r) * m; break;
      }
    }
    cs.s[tid] = s;
  } else if (tid == 32) {
    float s = 0.f;
    for (int n = 0; n < N; ++n) s += m32[n];
    cs.n32 = s;
  } else if (tid == 33) {
    float s = 0.f;
    for (int n = 0; n < N; ++n) s += x[n] * m32[n];
    cs.sx32 = s;
  }
  __syncthreads();
  if (tid == 0) {
    const double n = cs.s[0], n_ln = cs.s[2];
    cs.mean = cs.s[1] / npmax(n, 1.0);
    cs.mean_ln = cs.s[3] / npmax(n_ln, 1.0);
    // least squares rate = a + b w; a negative slope refits as b = 0
    const double nw = n, sw_ = cs.s[5], sww = cs.s[6], sr_ = cs.s[1],
                 swr = cs.s[7];
    const double det = nw * sww - sw_ * sw_;
    const bool det_ok = det > 1e-12 * npmax(nw * sww, 1e-300);
    const double safe_det = det_ok ? det : 1.0;
    const double bq = (nw * swr - sw_ * sr_) / safe_det;
    cs.b = npmax(det_ok ? bq : 0.0, 0.0);
    const double aq = (sr_ - cs.b * sw_) / npmax(nw, 1.0);
    cs.a = nw > 0.0 ? aq : 1.0;
    cs.mean32 = cs.sx32 / npmaxf(cs.n32, 1.f);
  }
  __syncthreads();

  // second-order sums about the means
  if (tid < 3) {
    double s = 0.0;
    for (int n = 0; n < N; ++n) {
      const double r = sr[n], m = sm[n];
      if (tid == 0) {
        const double d = r - cs.mean;
        s += (d * d) * m;
      } else if (tid == 1) {
        const double pos = r > 0.0 ? 1.0 : 0.0;
        const double d = log(r > 0.0 ? r : 1.0) - cs.mean_ln;
        s += (d * d) * (m * pos);
      } else {
        const double res = r - (cs.a + cs.b * sw[n]);
        s += (res * res) * m;
      }
    }
    if (tid == 0) cs.var = s / npmax(cs.s[0], 1.0);
    else if (tid == 1) cs.var_ln = s / npmax(cs.s[2], 1.0);
    else cs.var_d = s / npmax(cs.s[0], 1.0);
  } else if (tid == 32) {
    float s = 0.f;
    for (int n = 0; n < N; ++n) {
      const float d = x[n] - cs.mean32;
      s += (d * d) * m32[n];
    }
    cs.var32 = s / npmaxf(cs.n32, 1.f);
  }
  __syncthreads();

  if (tid == 0) {
    const double okf = cs.okf, n = cs.s[0], n_ln = cs.s[2];
    const double am = fabs(cs.mean) * 1e-6 + 1e-12;
    const double floor = npmax(cs.var, am * am) * 1e-8;
    const double logn = log(npmax(n, 2.0));
    const double ll_n = gauss_ll(n, cs.var, floor);
    const double ll_ln = (gauss_ll(n_ln, cs.var_ln, 1e-10) + cs.s[4])
                         - 1e3 * npmax(n - n_ln, 0.0);
    const double ll_d = gauss_ll(n, cs.var_d, floor);
    terms[0 * K + k] = (2.0 * logn - 2.0 * ll_n) * okf;
    terms[1 * K + k] = (2.0 * logn - 2.0 * ll_ln) * okf;
    terms[2 * K + k] = (3.0 * logn - 2.0 * ll_d) * okf;
    const double rho = cs.a > 1e-12 ? (2.0 * cs.b) / npmax(cs.a, 1e-12) : 0.0;
    out[kHead + k] = npmin(npmax(rho, 0.0), max_rho);
    okv[k] = okf;
    terms[4 * K + k] = logn;
    // the mixture's starts (float32, as _em_batch)
    const float n_valid = cs.n32;
    const bool has_data = n_valid >= 1.f;
    const float nf = npmaxf(n_valid, 1.f);
    const float spread = npmaxf(sqrtf(cs.var32),
                                npmaxf(fabsf(cs.mean32) * 1e-6f, 1e-12f));
    const float fs = kVarFloorFrac * spread;
    cs.floor32 = has_data ? fs * fs : 1.f;
    cs.nf = nf;
    const long long cap = (long long)nf - 1 > 0 ? (long long)nf - 1 : 0;
    for (int c = 0; c < kC; ++c) {
      long long q = (long long)((((double)c + 0.5) / kC) * (double)nf);
      q = q < cap ? q : cap;
      cs.q[c] = q < N ? (int)q : N - 1;
      cs.qval[c] = INFINITY;
      cs.var_c[c] = npmaxf(cs.var32 / (float)kC, cs.floor32);
      cs.pi[c] = 1.f / (float)kC;
    }
  }
  __syncthreads();
  // the q-th smallest valid sample, by rank (ties in index order, as a
  // stable sort); invalid samples are +inf and rank last
  for (int i = tid; i < N; i += kThreads) {
    const float vi = m32[i] > 0.f ? x[i] : INFINITY;
    int rank = 0;
    for (int j = 0; j < N; ++j) {
      const float vj = m32[j] > 0.f ? x[j] : INFINITY;
      rank += (vj < vi) || (vj == vi && j < i);
    }
    for (int c = 0; c < kC; ++c)
      if (rank == cs.q[c]) cs.qval[c] = vi;
  }
  __syncthreads();
  if (tid < kC) cs.mu[tid] = isfinite(cs.qval[tid]) ? cs.qval[tid] : 0.f;
  __syncthreads();

  for (int it = 0; it < kIters; ++it) {
    const bool last = it == kIters - 1;
    if (tid < kC) {
      cs.lv[tid] = 0.5f * np_logf(kTwoPiF * cs.var_c[tid]);
      cs.lp[tid] = np_logf(npmaxf(cs.pi[tid], 1e-30f));
    }
    __syncthreads();
    for (int n = tid; n < N; n += kThreads) {
      float lpn[kC];
      float mx = 0.f;
      for (int c = 0; c < kC; ++c) {
        const float d = x[n] - cs.mu[c];
        lpn[c] = (((-0.5f) * (d * d)) / cs.var_c[c] - cs.lv[c]) + cs.lp[c];
        mx = c == 0 ? lpn[0] : npmaxf(mx, lpn[c]);
      }
      float r[kC];
      float tot = 0.f;
      for (int c = 0; c < kC; ++c) {
        r[c] = np_expf(lpn[c] - mx);
        tot = c == 0 ? r[0] : tot + r[c];
      }
      tot = npmaxf(tot, 1e-30f);
      if (last) sw[n] = m32[n] > 0.f ? (double)(mx + np_logf(tot)) : 0.0;
      for (int c = 0; c < kC; ++c) rr[c * N + n] = (r[c] / tot) * m32[n];
    }
    __syncthreads();
    if (tid < 3 * kC) {
      const int c = tid / 3, q = tid % 3;
      const float* rc = rr + c * N;
      float s = 0.f;
      for (int n = 0; n < N; ++n) {
        const float xn = x[n];
        s += q == 0 ? rc[n] : (q == 1 ? rc[n] * xn : rc[n] * (xn * xn));
      }
      cs.sums[c][q] = s;
    } else if (tid == 32 && last) {
      double s = 0.0;
      for (int n = 0; n < N; ++n) s += sw[n];
      cs.ll = s;
    }
    __syncthreads();
    if (tid < kC) {
      const float nk = npmaxf(cs.sums[tid][0], 1e-12f);
      const float mu = cs.sums[tid][1] / nk;
      cs.mu[tid] = mu;
      cs.var_c[tid] = npmaxf(cs.sums[tid][2] / nk - mu * mu, cs.floor32);
      cs.pi[tid] = nk / cs.nf;
    }
    __syncthreads();
  }

  if (tid == 0) {
    // the components by mean, stable, NaN last (np.argsort)
    int order[kC];
    for (int c = 0; c < kC; ++c) order[c] = c;
    for (int i = 1; i < kC; ++i) {
      const int o = order[i];
      int j = i - 1;
      while (j >= 0) {
        const float a = cs.mu[order[j]], b = cs.mu[o];
        const bool shift = (a != a) ? (b == b) : (b < a);
        if (!shift) break;
        order[j + 1] = order[j];
        --j;
      }
      order[j + 1] = o;
    }
    double* W = out + kHead + K;
    double* M = W + kC * K;
    double* S = M + kC * K;
    for (int c = 0; c < kC; ++c) {
      W[c * K + k] = cs.pi[order[c]];
      M[c * K + k] = cs.mu[order[c]];
      S[c * K + k] = sqrtf(cs.var_c[order[c]]);
    }
    terms[3 * K + k] = ((3.0 * kC - 1.0) * terms[4 * K + k]
                        - 2.0 * cs.ll) * cs.okf;
  }
}

// The fleet's sums: BICs (pairwise over channels), the channels scored and
// the pooled component of the channels below min_obs.
__global__ void __launch_bounds__(kReduceThreads)
family_reduce_kernel(int N, int K, const double* __restrict__ rates,
                     const double* __restrict__ mask,
                     const double* __restrict__ terms,
                     const double* __restrict__ okv,
                     double* __restrict__ out) {
  __shared__ double red[3][kReduceThreads];
  __shared__ double pool_mean, pool_sd;
  const int tid = threadIdx.x;
  double cnt = 0.0, pn = 0.0, ps = 0.0;
  for (int k = tid; k < K; k += kReduceThreads) {
    const double ok = okv[k];
    cnt += ok;
    for (int n = 0; n < N; ++n) {
      const double m = mask[(size_t)n * K + k];
      pn += m * ok;
      ps += (rates[(size_t)n * K + k] * m) * ok;
    }
  }
  red[0][tid] = cnt;
  red[1][tid] = pn;
  red[2][tid] = ps;
  __syncthreads();
  for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
    if (tid < h)
      for (int q = 0; q < 3; ++q) red[q][tid] += red[q][tid + h];
    __syncthreads();
  }
  const double n_ok = red[0][0];
  const double pool_n = npmax(red[1][0], 1.0);
  if (tid == 0) pool_mean = red[2][0] / pool_n;
  __syncthreads();
  if (n_ok < (double)K) {
    double pv = 0.0;
    for (int k = tid; k < K; k += kReduceThreads) {
      const double ok = okv[k];
      for (int n = 0; n < N; ++n) {
        const double d = rates[(size_t)n * K + k] - pool_mean;
        pv += ((d * d) * mask[(size_t)n * K + k]) * ok;
      }
    }
    __syncthreads();
    red[0][tid] = pv;
    __syncthreads();
    for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
      if (tid < h) red[0][tid] += red[0][tid + h];
      __syncthreads();
    }
    if (tid == 0) {
      const double sd = sqrt(red[0][0] / pool_n);
      pool_sd = fmax(fmax(sd, fabs(pool_mean) * 1e-3), 1e-6);
    }
    __syncthreads();
    double* W = out + kHead + K;
    double* M = W + kC * K;
    double* S = M + kC * K;
    const float pm = (float)pool_mean, psd = (float)pool_sd;
    for (int k = tid; k < K; k += kReduceThreads) {
      if (okv[k] != 0.0) continue;
      for (int c = 0; c < kC; ++c) {
        W[c * K + k] = c == 0 ? 1.0 : 0.0;
        M[c * K + k] = pm;
        S[c * K + k] = psd;
      }
    }
  }
  if (tid < 4) out[tid] = pairwise_sum(terms + (size_t)tid * K, K);
  if (tid == 4) out[4] = n_ok;
}

}  // namespace

// rates, works, mask: (N, K) float64, row-major, N <= 4096. scratch holds
// 6 K doubles; out holds 8 + 10 K doubles: the BICs of normal, lognormal,
// drift and empirical, the channel count, then rho (K) and the mixture's
// weights, means and stds (C, K) each. Returns cudaGetLastError().
extern "C" int family_score_launch(int N, int K, const double* rates,
                                   const double* works, const double* mask,
                                   double min_obs, double max_rho,
                                   double* scratch, double* out,
                                   cudaStream_t stream) {
  if (N <= 0 || K <= 0) return 0;
  if (N > kMaxN) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)N * (3 * sizeof(double) +
                                   (2 + kC) * sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        family_channel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  double* terms = scratch;          // (4, K) BIC terms, then ln n (K)
  double* okv = scratch + 5 * (size_t)K;  // 1.0 where a channel is scored
  family_channel_kernel<<<K, kThreads, smem, stream>>>(
      N, K, rates, works, mask, min_obs, max_rho, terms, okv, out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  family_reduce_kernel<<<1, kReduceThreads, 0, stream>>>(N, K, rates, mask,
                                                         terms, okv, out);
  return (int)cudaGetLastError();
}
