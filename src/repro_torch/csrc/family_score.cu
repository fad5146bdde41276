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
// What bounds it: one warp's latency, not bytes or operations. The window is
// 3 N K float64 (2.4 MB at N = 96, K = 1024); each channel runs 16 EM
// iterations of 3 components over its N samples (an exp and a log a sample
// and component, ~3 N K C 16 = 14e6 float32 operations at the tick), so
// the card's bound is microseconds; what is left is the chains of ordered
// sums (N dependent adds each) and the EM's 16 rounds. Design: one warp a
// channel, several channels a block (kernels/family_score.py launch_plan:
// as many as fit shared memory at 52 N bytes a channel, up to 8; 1 at
// N = 4096). The block copies its channels' windows as one box with
// cp.async, neighbouring channels of an observation in neighbouring
// words; per-sample terms (the float64 logs, mask * (r > 0), the
// E-step's responsibilities times 1, x and x x) are computed once across
// lanes into shared memory; the channel's independent ordered sums run
// side by side, one a lane (the 8 first-order sums, the 3 second-order
// ones, the M-step's 9), each lane forming its next eight terms before
// adding them in order; the starts' ranks by bisection on
// order-preserving keys (32 rounds of counts, not N^2 compares); warp
// barriers only. A second launch (one
// block) sums the channels. No atomics: the result depends on the inputs
// alone.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kC = 3;               // EMP_COMPONENTS
constexpr int kIters = 16;          // _em_batch's iterations
constexpr int kWarps = 8;           // channels a block at most
constexpr int kAhead = 8;           // terms of an ordered sum formed ahead
constexpr int kSmemMax = 232448;    // a block's opt-in maximum
constexpr unsigned kFull = 0xffffffffu;
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
// multiply-adds), scaled by 2^q as two powers of two (the first product is
// exact, the second rounds once, as ldexpf does); the special cases are
// selected, not branched to, so the lanes of a warp stay together. log:
// x = m 2^k with m in (sqrt(1/2), sqrt(2)], log(m) as a rational polynomial
// (5/5) in m - 1, plus k ln2.
__device__ __forceinline__ float np_expf(float x) {
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
  // q is in [-150, 128] where the result is taken; both halves of it then
  // give normal powers of two
  const int e = (int)fminf(fmaxf(q, -150.f), 128.f);
  const int h = e / 2;
  const float p = ((num / den) * __int_as_float((h + 127) << 23))
                  * __int_as_float((e - h + 127) << 23);
  return (x != x) ? x
                  : (x >= 88.72283935546875f
                         ? INFINITY
                         : (x <= -103.97208404541015625f ? 0.f : p));
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

// cp.async of one float64 from device to shared memory
__device__ __forceinline__ void copy8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// ones in shared memory: the factor a lane reads at a stride of 0
__shared__ float s_one;
__shared__ double s_one_d;

// A float32's rank key: the unsigned order of the keys is the float order
// (-0 ranks as +0, every NaN last, as np.sort puts it); key_value inverts it
__device__ __forceinline__ unsigned rank_key(float v) {
  v = (v != v) ? NAN : v + 0.f;
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// One channel's window in shared memory, in floats from its base (8-byte
// aligned; kernels/family_score.py window_of): float64 rows D = 16
// ceil(N / 16) + 1 float64 apart and float32 rows P = 32 ceil(N / 32) + 1
// floats apart, so that one sample of different rows falls in different
// banks. The rates (at 0), the mask, then mask * ok (2 D), the float64
// logs (4 D) and mask * (rate > 0) (6 D) are read up to the second-order
// sums; the rank keys (at 0), then the nine rows of the M-step's products
// (L P) take their place. Then the works, later the last E-step's ln L
// terms (float64, at W), the rates and mask * ok as float32 (X, X + P).
struct Win {
  int D, P, W, X, total;
};
__host__ __device__ __forceinline__ Win window_of(int N) {
  Win w;
  w.D = 16 * ((N + 15) / 16) + 1;
  w.P = 32 * ((N + 31) / 32) + 1;
  const int dead = 9 * w.P > 8 * w.D ? 9 * w.P : 8 * w.D;
  w.W = (dead + 1) & ~1;
  w.X = w.W + 2 * w.D;
  w.total = w.X + 2 * w.P;
  return w;
}
__host__ __device__ __forceinline__ size_t channel_doubles(int N) {
  return ((size_t)window_of(N).total + 1) / 2;
}

// One channel, one warp, over its window (Win).
// Every sum over observations is one lane's chain in observation order;
// where a sum is needed by all lanes, every lane walks it (the same bits);
// where lanes walk different sums at once, every lane runs the same loop
// and selects its own term, so the warp never diverges, and the results
// reach the other lanes by shuffles.
__device__ void score_channel(int N, int K, int k, int lane, double* base,
                              double min_obs, double max_rho,
                              double* __restrict__ terms,
                              double* __restrict__ okv,
                              double* __restrict__ out) {
  const Win win = window_of(N);
  float* const fb = reinterpret_cast<float*>(base);
  const double* sr = base;
  double* sm = reinterpret_cast<double*>(fb + 2 * win.D);
  double* lg = reinterpret_cast<double*>(fb + 4 * win.D);
  double* mp = reinterpret_cast<double*>(fb + 6 * win.D);
  double* sw = reinterpret_cast<double*>(fb + win.W);
  float* x = fb + win.X;
  float* m32 = x + win.P;
  unsigned* key = reinterpret_cast<unsigned*>(fb);
  // row L of the M-step's products: component L / 3's responsibilities
  // times 1, x or x x (L % 3)
  float* const prod = fb;
  const int P = win.P;

  // per-sample terms across lanes: the rates as float32, the float64 logs
  for (int n = lane; n < N; n += 32) {
    const double r = sr[n];
    x[n] = (float)r;
    lg[n] = log(r > 0.0 ? r : 1.0);
  }
  double n_all = 0.0;
  {
    int n = 0;
    for (; n + kAhead <= N; n += kAhead) {
      double t[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) t[u] = sm[n + u];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) n_all += t[u];
    }
    for (; n < N; ++n) n_all += sm[n];
  }
  const double okf = n_all >= min_obs ? 1.0 : 0.0;
  __syncwarp();
  for (int n = lane; n < N; n += 32) {
    const double m = sm[n] * okf;
    sm[n] = m;
    m32[n] = (float)m;
    mp[n] = m * (sr[n] > 0.0 ? 1.0 : 0.0);
  }
  __syncwarp();

  // first-order sums: lanes 0-7 the float64 n, sum r m, n_ln, sum logs
  // m_ln, the Jacobian, sum w m, sum w w m, sum w r m; lanes 8, 9 the
  // float32 n and sum x m. Lane j's term is sgn (A B) Q, its factors read
  // from rows it picks here (a stride of 0 reads a one), so the loop body
  // is the same in every lane and the warp never branches apart in it
  const double* A = &s_one_d;
  const double* B = &s_one_d;
  const double* Q = sm;
  int as = 0, bs = 0;
  double sgn = 1.0;
  if (lane == 1) {
    A = sr;
    as = 1;
  }
  if (lane == 3 || lane == 4) {
    A = lg;
    as = 1;
  }
  if (lane >= 5 && lane <= 7) {
    A = sw;
    as = 1;
  }
  if (lane == 6 || lane == 7) {
    B = lane == 6 ? sw : sr;
    bs = 1;
  }
  if (lane >= 2 && lane <= 4) Q = mp;
  if (lane == 4) sgn = -1.0;
  const float* F = lane == 9 ? x : &s_one;
  const int fstep1 = lane == 9 ? 1 : 0;
  double s = 0.0;
  float f = 0.f;
  {
    // kAhead samples' terms first, then their adds in order
    int n = 0;
    for (; n + kAhead <= N; n += kAhead) {
      double t[kAhead];
      float g[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int i = n + u;
        t[u] = sgn * ((A[i * as] * B[i * bs]) * Q[i]);
        g[u] = F[i * fstep1] * m32[i];
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        s += t[u];
        f += g[u];
      }
    }
    for (; n < N; ++n) {
      s += sgn * ((A[n * as] * B[n * bs]) * Q[n]);
      f += F[n * fstep1] * m32[n];
    }
  }
  double sums[8];
  for (int j = 0; j < 8; ++j) sums[j] = __shfl_sync(kFull, s, j);
  const float n32 = __shfl_sync(kFull, f, 8);
  const float sx32 = __shfl_sync(kFull, f, 9);
  const double n_obs = sums[0], n_ln = sums[2];
  const double mean = sums[1] / npmax(n_obs, 1.0);
  const double mean_ln = sums[3] / npmax(n_ln, 1.0);
  // least squares rate = a + b w; a negative slope refits as b = 0
  const double nw = n_obs, sw_ = sums[5], sww = sums[6], sr_ = sums[1],
               swr = sums[7];
  const double det = nw * sww - sw_ * sw_;
  const bool det_ok = det > 1e-12 * npmax(nw * sww, 1e-300);
  const double safe_det = det_ok ? det : 1.0;
  const double bq = (nw * swr - sw_ * sr_) / safe_det;
  const double b = npmax(det_ok ? bq : 0.0, 0.0);
  const double aq = (sr_ - b * sw_) / npmax(nw, 1.0);
  const double a = nw > 0.0 ? aq : 1.0;
  const float mean32 = sx32 / npmaxf(n32, 1.f);

  // second-order sums about the means: lanes 0-2 float64 (normal,
  // lognormal, the drift residual), lane j's d = U - (c0 + c1 W) and term
  // (d d) Q from rows it picks (c1 = 0 where the centre is a mean: the
  // same d d); the float32 one in every lane
  const double* U = lane == 1 ? lg : sr;
  const double* W = lane == 2 ? sw : &s_one_d;
  const int ws = lane == 2 ? 1 : 0;
  const double c0 = lane == 0 ? mean : lane == 1 ? mean_ln : a;
  const double c1 = lane == 2 ? b : 0.0;
  const double* Q2 = lane == 1 ? mp : sm;
  s = 0.0;
  f = 0.f;
  {
    int n = 0;
    for (; n + kAhead <= N; n += kAhead) {
      double t[kAhead];
      float g[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int i = n + u;
        const double d = U[i] - (c0 + c1 * W[i * ws]);
        t[u] = (d * d) * Q2[i];
        const float d32 = x[i] - mean32;
        g[u] = (d32 * d32) * m32[i];
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        s += t[u];
        f += g[u];
      }
    }
    for (; n < N; ++n) {
      const double d = U[n] - (c0 + c1 * W[n * ws]);
      s += (d * d) * Q2[n];
      const float d32 = x[n] - mean32;
      f += (d32 * d32) * m32[n];
    }
  }
  const double var = __shfl_sync(kFull, s, 0) / npmax(n_obs, 1.0);
  const double var_ln = __shfl_sync(kFull, s, 1) / npmax(n_ln, 1.0);
  const double var_d = __shfl_sync(kFull, s, 2) / npmax(n_obs, 1.0);
  const float var32 = f / npmaxf(n32, 1.f);

  const double logn = log(npmax(n_obs, 2.0));
  if (lane == 0) {
    const double am = fabs(mean) * 1e-6 + 1e-12;
    const double floor = npmax(var, am * am) * 1e-8;
    const double ll_n = gauss_ll(n_obs, var, floor);
    const double ll_ln = (gauss_ll(n_ln, var_ln, 1e-10) + sums[4])
                         - 1e3 * npmax(n_obs - n_ln, 0.0);
    const double ll_d = gauss_ll(n_obs, var_d, floor);
    terms[0 * K + k] = (2.0 * logn - 2.0 * ll_n) * okf;
    terms[1 * K + k] = (2.0 * logn - 2.0 * ll_ln) * okf;
    terms[2 * K + k] = (3.0 * logn - 2.0 * ll_d) * okf;
    const double rho = a > 1e-12 ? (2.0 * b) / npmax(a, 1e-12) : 0.0;
    out[kHead + k] = npmin(npmax(rho, 0.0), max_rho);
    okv[k] = okf;
    terms[4 * K + k] = logn;
  }
  // the mixture's starts (float32, as _em_batch), in every lane
  const bool has_data = n32 >= 1.f;
  const float nf = npmaxf(n32, 1.f);
  const float spread = npmaxf(sqrtf(var32),
                              npmaxf(fabsf(mean32) * 1e-6f, 1e-12f));
  const float fs = kVarFloorFrac * spread;
  const float floor32 = has_data ? fs * fs : 1.f;
  const long long cap = (long long)nf - 1 > 0 ? (long long)nf - 1 : 0;
  int qi[kC];
  for (int c = 0; c < kC; ++c) {
    long long q = (long long)((((double)c + 0.5) / kC) * (double)nf);
    q = q < cap ? q : cap;
    qi[c] = q < N ? (int)q : N - 1;
  }

  // the q-th smallest valid sample (invalid samples are +inf and rank
  // last): bisection on the keys, the three starts at once, each count
  // summed across the warp (integers: any order gives the same); the value
  // is the q-th of the sorted samples.
  __syncwarp();   // the logs are read; the keys take their place
  for (int n = lane; n < N; n += 32)
    key[n] = rank_key(m32[n] > 0.f ? x[n] : INFINITY);
  __syncwarp();
  unsigned lo[kC], hi[kC];
  for (int c = 0; c < kC; ++c) {
    lo[c] = 0u;
    hi[c] = 0xffffffffu;
  }
  for (int bit = 0; bit < 32; ++bit) {
    unsigned mid[kC];
    int cnt[kC];
    for (int c = 0; c < kC; ++c) {
      mid[c] = lo[c] + ((hi[c] - lo[c]) >> 1);
      cnt[c] = 0;
    }
    for (int n = lane; n < N; n += 32) {
      const unsigned kn = key[n];
      for (int c = 0; c < kC; ++c) cnt[c] += kn <= mid[c] ? 1 : 0;
    }
    for (int c = 0; c < kC; ++c) {
      if (__reduce_add_sync(kFull, cnt[c]) > qi[c]) hi[c] = mid[c];
      else lo[c] = mid[c] + 1u;
    }
  }
  float mu[kC];
  for (int c = 0; c < kC; ++c) {
    const float v = key_value(lo[c]);
    mu[c] = isfinite(v) ? v : 0.f;
  }

  // EM. Component c's parameters live in lane c (< kC), which also takes
  // their logs and their M-step update; shuffles give every lane a copy.
  // The E-step runs across lanes (a sample each) and writes, for each
  // component c, its responsibility r times 1, x and x x (rows 3 c + q);
  // lane 3 c + q sums its row in observation order; the last iteration's
  // ln L (float64) is summed by every lane.
  const int cc = lane < kC ? lane : 0;
  float my_mu = cc == 0 ? mu[0] : cc == 1 ? mu[1] : mu[2];
  float my_var = npmaxf(var32 / (float)kC, floor32);
  float my_pi = 1.f / (float)kC;
  const int L = lane < 3 * kC ? lane : 0;
  const float* row = prod + L * P;
  double ll = 0.0;
  for (int it = 0; it < kIters; ++it) {
    const bool last = it == kIters - 1;
    const float my_lv = 0.5f * np_logf(kTwoPiF * my_var);
    const float my_lp = np_logf(npmaxf(my_pi, 1e-30f));
    float lv[kC], lp[kC], var_c[kC];
    for (int c = 0; c < kC; ++c) {
      mu[c] = __shfl_sync(kFull, my_mu, c);
      var_c[c] = __shfl_sync(kFull, my_var, c);
      lv[c] = __shfl_sync(kFull, my_lv, c);
      lp[c] = __shfl_sync(kFull, my_lp, c);
    }
    __syncwarp();   // the keys, or the last M-step's reads, are done
    for (int n = lane; n < N; n += 32) {
      const float xn = x[n];
      float lpn[kC];
      float mx = 0.f;
      for (int c = 0; c < kC; ++c) {
        const float d = xn - mu[c];
        lpn[c] = (((-0.5f) * (d * d)) / var_c[c] - lv[c]) + lp[c];
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
      const float xx = xn * xn;
      for (int c = 0; c < kC; ++c) {
        const float rc = (r[c] / tot) * m32[n];
        prod[(3 * c) * P + n] = rc;
        prod[(3 * c + 1) * P + n] = rc * xn;
        prod[(3 * c + 2) * P + n] = rc * xx;
      }
    }
    __syncwarp();
    float t = 0.f;
    {
      int n = 0;
      for (; n + kAhead <= N; n += kAhead) {
        float g[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) g[u] = row[n + u];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) t += g[u];
      }
      for (; n < N; ++n) t += row[n];
    }
    if (last) {
      int n = 0;
      for (; n + kAhead <= N; n += kAhead) {
        double g[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) g[u] = sw[n + u];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) ll += g[u];
      }
      for (; n < N; ++n) ll += sw[n];
    }
    const float s0 = __shfl_sync(kFull, t, 3 * cc);
    const float s1 = __shfl_sync(kFull, t, 3 * cc + 1);
    const float s2 = __shfl_sync(kFull, t, 3 * cc + 2);
    const float nk = npmaxf(s0, 1e-12f);
    my_mu = s1 / nk;
    my_var = npmaxf(s2 / nk - my_mu * my_mu, floor32);
    my_pi = nk / nf;
  }
  float var_c[kC], pi[kC];
  for (int c = 0; c < kC; ++c) {
    mu[c] = __shfl_sync(kFull, my_mu, c);
    var_c[c] = __shfl_sync(kFull, my_var, c);
    pi[c] = __shfl_sync(kFull, my_pi, c);
  }

  if (lane == 0) {
    // the components by mean, stable, NaN last (np.argsort)
    int order[kC];
    for (int c = 0; c < kC; ++c) order[c] = c;
    for (int i = 1; i < kC; ++i) {
      const int o = order[i];
      int j = i - 1;
      while (j >= 0) {
        const float va = mu[order[j]], vb = mu[o];
        const bool shift = (va != va) ? (vb == vb) : (vb < va);
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
      W[c * K + k] = pi[order[c]];
      M[c * K + k] = mu[order[c]];
      S[c * K + k] = sqrtf(var_c[order[c]]);
    }
    terms[3 * K + k] = ((3.0 * kC - 1.0) * logn - 2.0 * ll) * okf;
  }
}

// cpb channels a block (blockDim.x = 32 cpb), channels blockIdx.x * cpb ..
__global__ void __launch_bounds__(kWarps * 32)
family_channel_kernel(int N, int K, const double* __restrict__ rates,
                      const double* __restrict__ works,
                      const double* __restrict__ mask, double min_obs,
                      double max_rho, double* __restrict__ terms,
                      double* __restrict__ okv, double* __restrict__ out) {
  extern __shared__ double smem[];
  const int cpb = blockDim.x >> 5;
  const int k0 = blockIdx.x * cpb;
  const int nc = K - k0 < cpb ? K - k0 : cpb;
  const Win win = window_of(N);
  const size_t stride = channel_doubles(N);
  // the block's windows as one box: observation n's nc channels are
  // neighbours in each (N, K) array, so consecutive threads copy
  // consecutive words; each lands in its channel's rows
  for (int e = threadIdx.x; e < N * nc; e += blockDim.x) {
    const int n = e / nc, c = e - n * nc;
    const size_t g = (size_t)n * K + k0 + c;
    double* base = smem + c * stride;
    copy8(base + n, rates + g);
    copy8(base + win.D + n, mask + g);
    copy8(base + win.W / 2 + n, works + g);
  }
  if (threadIdx.x == 0) {
    s_one = 1.f;
    s_one_d = 1.0;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int w = threadIdx.x >> 5;
  if (w >= nc) return;
  score_channel(N, K, k0 + w, threadIdx.x & 31, smem + w * stride, min_obs,
                max_rho, terms, okv, out);
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

// rates, works, mask: (N, K) float64, row-major, N <= 4096; cpb channels
// a block (1-8, kernels/family_score.py launch_plan: cpb windows of
// channel_doubles(N) float64 must fit 227 KB of shared memory). scratch
// holds 6 K doubles; out holds
// 8 + 10 K doubles: the BICs of normal, lognormal, drift and empirical, the
// channel count, then rho (K) and the mixture's weights, means and stds
// (C, K) each. Returns cudaGetLastError().
extern "C" int family_score_launch(int N, int K, int cpb,
                                   const double* rates, const double* works,
                                   const double* mask, double min_obs,
                                   double max_rho, double* scratch,
                                   double* out, cudaStream_t stream) {
  if (N <= 0 || K <= 0) return 0;
  if (N > kMaxN || cpb < 1 || cpb > kWarps) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cpb * channel_doubles(N) * sizeof(double);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  // the dynamic shared memory allowed so far (the default 48 KB holds the
  // static s_one too, so any size is opted into once)
  static size_t opted = 0;
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        family_channel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  double* terms = scratch;          // (4, K) BIC terms, then ln n (K)
  double* okv = scratch + 5 * (size_t)K;  // 1.0 where a channel is scored
  family_channel_kernel<<<(K + cpb - 1) / cpb, 32 * cpb, smem, stream>>>(
      N, K, rates, works, mask, min_obs, max_rho, terms, okv, out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  family_reduce_kernel<<<1, kReduceThreads, 0, stream>>>(N, K, rates, mask,
                                                         terms, okv, out);
  return (int)cudaGetLastError();
}
