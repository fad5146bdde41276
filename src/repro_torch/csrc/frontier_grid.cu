// Frontier kernels for Hopper (sm_90a): survival-integral moments of the
// max completion time for a batch of candidate splits, and the same moments
// fused with their analytic adjoints.
//
// Replaces the two Pallas TPU kernels of the JAX package,
// kernels/frontier_grid.py::frontier_grid (_frontier_kernel) and
// kernels/frontier_grid.py::frontier_grid_with_grads (_frontier_grad_kernel).
// The plain PyTorch versions are repro_torch/kernels/ref.py; the two follow
// the same arithmetic, step for step.
//
// Work: every CDF evaluation C_k(t_j) of every candidate row, F * T * K per
// pass (one pass forward, two for the adjoints), each an erf, a log (pass 1)
// or an exp (pass 2) and a few dozen float32 operations. The inputs are
// small ((F, K) weights), so on the H100 the kernels are bound by
// operations, not by memory.
//
// Numerics: per-channel terms are float32; every sum over channels or grid
// points is float64. The variance and the var-adjoints are differences of
// nearly equal sums (var << mu^2; the Pv accumulators sum a * (t - mu) with
// both signs), so a float32 running sum loses ~3 digits there; float64
// sums leave only the terms' own rounding. The Pv accumulators sum
// a * (t - mu) per grid point, never P1 - mu P0.
//
// Design (simple first):
// * One thread block per candidate row; nothing crosses blocks, so there
//   are no atomics and every sum is taken in a fixed order: a run is
//   bitwise repeatable, as the kill/restore contract needs.
// * Pass 1: a block reduction of reach_k = mean_k + z std_k gives tmax;
//   each thread owns grid points j = tid, tid + blockDim, ... (at most 8)
//   and streams the channels through shared-memory tiles of per-channel
//   constants, summing log clamp(C_k(t_j), 1e-37, 1) in registers; block
//   reductions give mu and m2 (trapezoid weights 1/2 at the ends).
// * Pass 2 (adjoints): t_j, log t_j, w_j F(t_j) and t_j - mu go to shared
//   memory (mu must be final first). Threads own channels and loop over the
//   grid in order, keeping up to six accumulators in registers. The
//   epilogue needs two block-wide sums over channels and the argmax tie
//   count before any per-channel output, so the accumulators and reaches go
//   to a float64 scratch (F, n_acc + 1, K) buffer and each thread reads its
//   own channels back after the reductions.
// * Known weakness: a balancer solve launches only a few rows, so one block
//   per row leaves most of the 132 SMs idle; splitting K or T across blocks
//   is later work.
#include <cuda_runtime.h>
#include <math.h>

#include "family.cuh"

namespace fg {
// The accumulator type of every sum over channels or grid points: float64.
// Building with -DFG_ACC=float gives the reference's float32 sums, which
// chip_smoke.py times against this build.
#ifndef FG_ACC
#define FG_ACC double
#endif
using acc_t = FG_ACC;


constexpr int MAX_THREADS = 512;
constexpr int MAX_NPT = 8;  // grid points per thread: T <= 8 * blockDim

__device__ __forceinline__ acc_t warp_sum(acc_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// Fixed-order block reductions; every thread gets the result. blockDim.x
// is a multiple of 32.
__device__ acc_t block_sum(acc_t v, acc_t* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    acc_t x = lane < nw ? red[lane] : 0.0;
    x = warp_sum(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const acc_t out = red[32];
  __syncthreads();
  return out;
}

__device__ float block_max(float v, acc_t* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float x = lane < nw ? (float)red[lane] : -INFINITY;
    x = warp_max(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const float out = (float)red[32];
  __syncthreads();
  return out;
}

struct Args {
  const float* W;
  const float* mus;
  const float* sgs;
  const float* ex;
  int per_row, F, K, T;
  float z;
};

// Maximum over channels of reach_k for row f (every thread gets it). With
// reach_out, each thread also stores the reaches of its own channels k =
// tid, tid + blockDim, ...: the argmax tie test then compares the very
// values the maximum was taken over.
template <int FAM>
__device__ float row_amax(const Args& a, int f, acc_t* red,
                          acc_t* reach_out) {
  float m = -INFINITY;
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    const float rk = reach<FAM>(
        load_raw<FAM>(a.W, a.mus, a.sgs, a.ex, f, k, a.F, a.K, a.per_row),
        a.z);
    if (reach_out != nullptr) reach_out[k] = rk;
    m = fmaxf(m, rk);
  }
  return block_max(m, red);
}

// Grid points of this thread: t_j = tmax * (j / (T - 1)) and log t_j.
template <int FAM>
__device__ void grid_points(const Args& a, float tmax, float* t, float* lt) {
  const int nth = blockDim.x, tid = threadIdx.x;
  const float denom = (float)(a.T - 1);
#pragma unroll
  for (int i = 0; i < MAX_NPT; ++i) {
    const float frac = (float)(tid + i * nth) / denom;
    t[i] = tmax * frac;
    lt[i] = (FAM == LOGNORMAL) ? logf(fmaxf(t[i], TINY)) : 0.0f;
  }
}

// Pass 1: logF(t_j) = sum_k log clamp(C_k(t_j)) in float64 for this
// thread's grid points, channels streamed through a shared tile of
// blockDim entries.
template <int FAM>
__device__ void log_joint_cdf(const Args& a, int f, Chan<FAM>* tile,
                              const float* t, const float* lt,
                              acc_t* logF) {
  const int nth = blockDim.x, tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < MAX_NPT; ++i) logF[i] = 0.0;
  for (int k0 = 0; k0 < a.K; k0 += nth) {
    const int k = k0 + tid;
    if (k < a.K)
      tile[tid] = make_chan<FAM>(
          load_raw<FAM>(a.W, a.mus, a.sgs, a.ex, f, k, a.F, a.K, a.per_row));
    __syncthreads();
    const int n = min(nth, a.K - k0);
    for (int c = 0; c < n; ++c) {
      const Chan<FAM> ch = tile[c];
#pragma unroll
      for (int i = 0; i < MAX_NPT; ++i) {
        if (tid + i * nth < a.T) {
          const float cv = cdf<FAM>(ch, t[i], lt[i]);
          logF[i] += (acc_t)logf(fminf(fmaxf(cv, CDF_FLOOR), 1.0f));
        }
      }
    }
    __syncthreads();
  }
}

// The moments of row f from this thread's grid points: F_j = exp(logF_j)
// and the trapezoid sums of surv and t surv, all float64. Returns mu and
// m2 (every thread gets them) and leaves w_j F_j in Fw.
__device__ __forceinline__ void moments(const Args& a, float tmax,
                                        const float* t, const acc_t* logF,
                                        acc_t* Fw, acc_t* red, acc_t& mu,
                                        acc_t& m2) {
  const int nth = blockDim.x, tid = threadIdx.x;
  acc_t s1 = 0.0, s2 = 0.0;
#pragma unroll
  for (int i = 0; i < MAX_NPT; ++i) {
    const int j = tid + i * nth;
    Fw[i] = 0.0;
    if (j < a.T) {
      const acc_t wq = (j == 0 || j == a.T - 1) ? 0.5 : 1.0;
      const acc_t Fj = exp(logF[i]);
      const acc_t surv = 1.0 - Fj;
      Fw[i] = wq * Fj;
      s1 += wq * surv;
      s2 += wq * (acc_t)t[i] * surv;
    }
  }
  const acc_t dt = (acc_t)tmax / (acc_t)(a.T - 1);
  mu = block_sum(s1, red) * dt;
  m2 = 2.0 * block_sum(s2, red) * dt;
}

template <int FAM>
__global__ void __launch_bounds__(MAX_THREADS)
frontier_fwd_kernel(Args a, float* __restrict__ mu_out,
                    float* __restrict__ var_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Chan<FAM>* tile = reinterpret_cast<Chan<FAM>*>(smem);
  __shared__ acc_t red[33];
  const int f = blockIdx.x;

  const float amax = row_amax<FAM>(a, f, red, nullptr);
  const float tmax = fmaxf(amax, 1e-12f);
  float t[MAX_NPT], lt[MAX_NPT];
  acc_t logF[MAX_NPT], Fw[MAX_NPT];
  grid_points<FAM>(a, tmax, t, lt);
  log_joint_cdf<FAM>(a, f, tile, t, lt, logF);
  acc_t mu, m2;
  moments(a, tmax, t, logF, Fw, red, mu, m2);
  if (threadIdx.x == 0) {
    mu_out[f] = (float)mu;
    var_out[f] = (float)fmax(m2 - mu * mu, (acc_t)0);
  }
}

struct GradOut {
  float* mu;
  float* var;
  float* d[8];  // dmu_dW, dvar_dW [, mus, sigmas, extra row 0 pairs]
  acc_t* scratch;
};

template <int FAM, bool P>
__global__ void __launch_bounds__(MAX_THREADS)
frontier_grad_kernel(Args a, GradOut o) {
  using Fe = Feat<FAM, P>;
  constexpr int NACC = 2 * ((int)Fe::u1 + (int)Fe::ut + (int)Fe::uz);
  constexpr int S0 = 0;
  constexpr int S1 = S0 + (Fe::u1 ? 2 : 0);
  constexpr int SZ = S1 + (Fe::ut ? 2 : 0);

  // shared: the grid (t, log t) for both passes, then a region holding the
  // channel tile in pass 1 and (t - mu, w F) in pass 2
  extern __shared__ __align__(16) unsigned char smem[];
  acc_t* s_tmu = reinterpret_cast<acc_t*>(smem);
  float* s_wF = reinterpret_cast<float*>(s_tmu + a.T);
  float* s_t = s_wF + a.T;
  float* s_lt = s_t + a.T;
  Chan<FAM>* tile = reinterpret_cast<Chan<FAM>*>(smem);
  __shared__ acc_t red[33];
  const int f = blockIdx.x, nth = blockDim.x, tid = threadIdx.x;
  const int K = a.K, T = a.T;

  // ---- pass 1: the forward moments
  acc_t* acc_row = o.scratch + (long long)f * (NACC + 1) * K;
  acc_t* reach_row = acc_row + (long long)NACC * K;
  const float amax = row_amax<FAM>(a, f, red, reach_row);
  const float tmax = fmaxf(amax, 1e-12f);
  float t[MAX_NPT], lt[MAX_NPT];
  acc_t logF[MAX_NPT], Fw[MAX_NPT];
  grid_points<FAM>(a, tmax, t, lt);
  log_joint_cdf<FAM>(a, f, tile, t, lt, logF);
  acc_t mu, m2;
  moments(a, tmax, t, logF, Fw, red, mu, m2);
  const acc_t var_raw = m2 - mu * mu;
  if (tid == 0) {
    o.mu[f] = (float)mu;
    o.var[f] = (float)fmax(var_raw, (acc_t)0);
  }
  // the reductions in moments() ended on a barrier: the tile is free
#pragma unroll
  for (int i = 0; i < MAX_NPT; ++i) {
    const int j = tid + i * nth;
    if (j < T) {
      s_tmu[j] = (acc_t)t[i] - mu;
      s_wF[j] = (float)Fw[i];
      s_t[j] = t[i];
      s_lt[j] = lt[i];
    }
  }
  __syncthreads();

  // ---- pass 2: per-channel accumulators over the grid, in grid order
  acc_t part_mu = 0.0, part_var = 0.0, ties = 0.0;
  for (int k = tid; k < K; k += nth) {
    const Raw r = load_raw<FAM>(a.W, a.mus, a.sgs, a.ex, f, k, a.F, K,
                                a.per_row);
    const Chan<FAM> ch = make_chan<FAM>(r);
    acc_t P0 = 0.0, Pv0 = 0.0, P1 = 0.0, Pv1 = 0.0, Pz = 0.0, Pvz = 0.0;
    if (ch.ok != 0.0f) {
      for (int j = 0; j < T; ++j) {
        const float tj = s_t[j];
        const acc_t tmu = s_tmu[j];
        float craw, D, zj;
        adjoint_parts<FAM>(ch, tj, s_lt[j], craw, D, zj);
        const float Cc = fminf(fmaxf(craw, CDF_FLOOR), 1.0f);
        const float gate = (craw >= 1.0f ? 0.5f : 1.0f)
                           * (craw > CDF_FLOOR ? 1.0f : 0.0f);
        const acc_t av = (acc_t)(s_wF[j] * (gate * D / Cc));
        if (Fe::u1) { P0 += av; Pv0 += av * tmu; }
        if (Fe::ut) { const acc_t at = av * (acc_t)tj; P1 += at; Pv1 += at * tmu; }
        if (Fe::uz) { const acc_t az = av * (acc_t)zj; Pz += az; Pvz += az * tmu; }
      }
    }
    if (Fe::u1) { acc_row[(S0 + 0) * K + k] = P0; acc_row[(S0 + 1) * K + k] = Pv0; }
    if (Fe::ut) { acc_row[(S1 + 0) * K + k] = P1; acc_row[(S1 + 1) * K + k] = Pv1; }
    if (Fe::uz) { acc_row[(SZ + 0) * K + k] = Pz; acc_row[(SZ + 1) * K + k] = Pvz; }
    float al, be, g0, g1;
    coeffs<FAM>(r, al, be, g0, g1);
    part_mu += (acc_t)g0 * P0 + (acc_t)g1 * P1;
    part_var += (acc_t)g0 * Pv0 + (acc_t)g1 * Pv1;
    ties += reach_row[k] == (acc_t)amax ? 1.0 : 0.0;
  }
  const acc_t S_mu = block_sum(part_mu, red);
  const acc_t S_var = block_sum(part_var, red);
  const acc_t n_tie = block_sum(ties, red);

  // ---- epilogue: fixed-grid plus moving-grid (tmax) terms per channel
  const acc_t dt = (acc_t)tmax / (acc_t)(T - 1);
  const acc_t tmx = (acc_t)tmax;
  const acc_t b_mu = (mu - dt * S_mu) / tmx;
  const acc_t b_var = 2.0 * (var_raw - dt * S_var) / tmx;
  const acc_t live = amax > 1e-12f ? 1.0 : 0.0;
  const bool var_pos = var_raw > 0.0;
  for (int k = tid; k < K; k += nth) {
    const Raw r = load_raw<FAM>(a.W, a.mus, a.sgs, a.ex, f, k, a.F, K,
                                a.per_row);
    acc_t P0 = 0.0, Pv0 = 0.0, P1 = 0.0, Pv1 = 0.0, Pz = 0.0, Pvz = 0.0;
    if (Fe::u1) { P0 = acc_row[(S0 + 0) * K + k]; Pv0 = acc_row[(S0 + 1) * K + k]; }
    if (Fe::ut) { P1 = acc_row[(S1 + 0) * K + k]; Pv1 = acc_row[(S1 + 1) * K + k]; }
    if (Fe::uz) { Pz = acc_row[(SZ + 0) * K + k]; Pvz = acc_row[(SZ + 1) * K + k]; }
    const acc_t ind = reach_row[k] == (acc_t)amax ? 1.0 : 0.0;
    const acc_t tie = ind / n_tie * live;
    const long long fk = (long long)f * K + k;

    auto contract = [&](float c1, float ct, float cz, float dre, float* dmu,
                        float* dvar) {
      const acc_t gvec = (acc_t)dre * tie;
      const acc_t fix = (acc_t)c1 * P0 + (acc_t)ct * P1 + (acc_t)cz * Pz;
      const acc_t fixv =
          (acc_t)c1 * Pv0 + (acc_t)ct * Pv1 + (acc_t)cz * Pvz;
      dmu[fk] = (float)(-dt * fix + b_mu * gvec);
      dvar[fk] = var_pos ? (float)(-2.0 * dt * fixv + b_var * gvec) : 0.0f;
    };
    float al, be, g0, g1;
    coeffs<FAM>(r, al, be, g0, g1);
    contract(al, be, 0.0f, dreach_w<FAM>(r, a.z), o.d[0], o.d[1]);
    if (P) {
      float cm[3], cs[3], ce[3], dm, ds, de;
      param_coeffs<FAM>(r, cm, cs, ce);
      dreach_params<FAM>(r, a.z, dm, ds, de);
      contract(cm[0], cm[1], cm[2], dm, o.d[2], o.d[3]);
      contract(cs[0], cs[1], cs[2], ds, o.d[4], o.d[5]);
      if (FAM == DRIFT || FAM == DEFECTIVE) {
        contract(ce[0], ce[1], ce[2], de, o.d[6], o.d[7]);
      } else {
        o.d[6][fk] = 0.0f;
        o.d[7][fk] = 0.0f;
      }
    }
  }
}

template <int FAM>
size_t chan_bytes() { return sizeof(Chan<FAM>); }

size_t chan_bytes_of(int fam) {
  switch (fam) {
    case NORMAL: return chan_bytes<NORMAL>();
    case LOGNORMAL: return chan_bytes<LOGNORMAL>();
    case DRIFT: return chan_bytes<DRIFT>();
    case EMPIRICAL: return chan_bytes<EMPIRICAL>();
    default: return chan_bytes<DEFECTIVE>();
  }
}

// Dynamic shared memory of the fused kernel: the larger of the channel
// tile (pass 1) and the per-grid-point arrays (8 + 4 + 4 + 4 bytes).
size_t grad_smem(int fam, int threads, int T) {
  const size_t tile = (size_t)threads * chan_bytes_of(fam);
  const size_t pts = 20 * (size_t)T;
  return tile > pts ? tile : pts;
}

template <int FAM>
cudaError_t fwd_launch(Args a, int threads, float* mu_out, float* var_out,
                       cudaStream_t stream) {
  const size_t smem = (size_t)threads * sizeof(Chan<FAM>);
  cudaError_t err = cudaFuncSetAttribute(
      frontier_fwd_kernel<FAM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  frontier_fwd_kernel<FAM><<<a.F, threads, smem, stream>>>(a, mu_out, var_out);
  return cudaGetLastError();
}

template <int FAM, bool P>
cudaError_t grad_launch(Args a, int threads, GradOut o, cudaStream_t stream) {
  const size_t smem = grad_smem(FAM, threads, a.T);
  cudaError_t err = cudaFuncSetAttribute(
      frontier_grad_kernel<FAM, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  frontier_grad_kernel<FAM, P><<<a.F, threads, smem, stream>>>(a, o);
  return cudaGetLastError();
}

}  // namespace fg

using namespace fg;

extern "C" {

// Bytes of one accumulator (8, or 4 in a -DFG_ACC=float build): the caller
// sizes the fused kernel's scratch with it.
int fg_acc_bytes() { return (int)sizeof(acc_t); }

// Forward moments. Returns a cudaError_t value (0 on success).
int fg_forward(int fam, const float* W, const float* mus, const float* sgs,
               const float* ex, int per_row, int F, int K, int T, float z,
               int threads, float* mu_out, float* var_out, void* stream) {
  Args a{W, mus, sgs, ex, per_row, F, K, T, z};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fam) {
    case NORMAL: return fwd_launch<NORMAL>(a, threads, mu_out, var_out, s);
    case LOGNORMAL: return fwd_launch<LOGNORMAL>(a, threads, mu_out, var_out, s);
    case DRIFT: return fwd_launch<DRIFT>(a, threads, mu_out, var_out, s);
    case EMPIRICAL: return fwd_launch<EMPIRICAL>(a, threads, mu_out, var_out, s);
    case DEFECTIVE: return fwd_launch<DEFECTIVE>(a, threads, mu_out, var_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Fused moments and adjoints. outs holds 2 (param_grads == 0) or 8 (F, K)
// output pointers; scratch holds F * (n_acc + 1) * K doubles (the
// per-channel accumulators and reaches).
int fg_grad(int fam, int param_grads, const float* W, const float* mus,
            const float* sgs, const float* ex, int per_row, int F, int K,
            int T, float z, int threads, float* mu_out, float* var_out,
            float** outs, acc_t* scratch, void* stream) {
  Args a{W, mus, sgs, ex, per_row, F, K, T, z};
  GradOut o;
  o.mu = mu_out;
  o.var = var_out;
  for (int i = 0; i < 8; ++i) o.d[i] = (i < 2 || param_grads) ? outs[i] : nullptr;
  o.scratch = scratch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (param_grads) {
    switch (fam) {
      case NORMAL: return grad_launch<NORMAL, true>(a, threads, o, s);
      case LOGNORMAL: return grad_launch<LOGNORMAL, true>(a, threads, o, s);
      case DRIFT: return grad_launch<DRIFT, true>(a, threads, o, s);
      case EMPIRICAL: return grad_launch<EMPIRICAL, true>(a, threads, o, s);
      case DEFECTIVE: return grad_launch<DEFECTIVE, true>(a, threads, o, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (fam) {
    case NORMAL: return grad_launch<NORMAL, false>(a, threads, o, s);
    case LOGNORMAL: return grad_launch<LOGNORMAL, false>(a, threads, o, s);
    case DRIFT: return grad_launch<DRIFT, false>(a, threads, o, s);
    case EMPIRICAL: return grad_launch<EMPIRICAL, false>(a, threads, o, s);
    case DEFECTIVE: return grad_launch<DEFECTIVE, false>(a, threads, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
