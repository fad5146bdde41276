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
// Both kernels are split across the card: a balancer refresh launches them
// at F = 1 or 3 rows (its PGD steps and sensitivity at T = 1024, its
// finalists at T = 2048), so one block per row would leave 129 of 132 SMs
// idle. Each row is spread over many blocks, each launch's shape a function
// of (F, K, T, mode, family) alone (kernels/autotune.py pick_split aims at
// 132 blocks per launch), and a block's threads do not depend on T, which
// the tiles cover at any length.
//
// Forward moments, two launches from one call (fg_forward):
// * Pass 1 (frontier_fwd_pass1), blocks of (row, tile of `points` grid
//   points), the adjoint's pass 1 below without its argmax ties and w F:
//   the row's reach maximum reach_k = mean_k + z std_k (tile 0 stores it),
//   log F(t_j) = sum_k log clamp(C_k(t_j), 1e-37, 1) for the tile's points
//   and the tile's trapezoid sums of surv and t surv (weights 1/2 at the
//   ends).
// * Epilogue (frontier_fwd_epilogue), one warp per row: the tile sums in
//   tile order, mu and var = max(m2 - mu^2, 0).
//
// Fused adjoint, three launches from one call (fg_grad):
// * Pass 1, blocks of (row, tile of `points` grid points): every block takes
//   the row's reach maximum (exact, so the same in all of them; tile 0 also
//   counts the argmax ties), then sums log C_k(t_j) for its points with
//   blockDim / points channel slices per point, the slices added in order.
//   It writes w_j F(t_j) and the tile's trapezoid sums.
// * Pass 2, blocks of (row, chunk of grid points, chunk of channels): each
//   block sums the row's tile sums in tile order (the same mu in every
//   block: pass 2 needs mu final, as the Pv accumulators sum a (t - mu)),
//   stages its chunk's t_j, log t_j, w_j F(t_j) and t_j - mu in shared
//   memory, and each thread walks the chunk in grid order for its channel,
//   keeping up to six accumulators in registers. It writes them per chunk,
//   and the block's sums of g . P and g . Pv over its channels.
// * Epilogue, blocks of (row, chunk of channels): the row-wide S_mu and
//   S_var from pass 2's partials, each channel's accumulators summed over
//   the grid chunks in order, then the outputs.
// Nothing is added atomically and every sum has a fixed order (within a
// block, a fixed butterfly; across blocks, a scratch buffer read in index
// order), so two launches give the same bits, as the kill/restore contract
// needs; the split, carried by autotune.cache_state(), fixes that order.
// When F alone fills the card (the fleet tick, F = 4096) the split is one
// tile and one chunk per row.
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

// Maximum over channels of reach_k for row f (every thread gets it). A
// maximum is exact, so every block of a row gets the same value, and the
// argmax tie test, which recomputes reach_k, compares the very values the
// maximum was taken over.
template <int FAM>
__device__ float row_amax(const Args& a, int f, acc_t* red) {
  float m = -INFINITY;
  for (int k = threadIdx.x; k < a.K; k += blockDim.x)
    m = fmaxf(m, reach<FAM>(load_raw<FAM>(a.W, a.mus, a.sgs, a.ex, f, k, a.F,
                                          a.K, a.per_row), a.z));
  return block_max(m, red);
}

struct GradOut {
  float* mu;
  float* var;
  float* d[8];  // dmu_dW, dvar_dW [, mus, sigmas, extra row 0 pairs]
  acc_t* scratch;
};

// Launch shape of a split call, chosen by kernels/autotune.py (pick_split)
// from (F, K, T, mode, family) alone.
// The forward call reads `points` alone.
struct Split {
  int points;    // pass 1: grid points per block, a power of two dividing
                 // blockDim; blockDim / points channel slices per point
  int t_chunk;   // adjoint pass 2: grid points per block
  int k_chunk;   // adjoint pass 2: channels per block
  int ep_chunk;  // adjoint epilogue: channels per block
};

// Threads per block of pass 2 and of the epilogue: one per channel up to
// CHUNK_THREADS, each thread walking channels k, k + blockDim, ... of its
// block's chunk beyond that.
constexpr int CHUNK_THREADS = 256;

__host__ __device__ __forceinline__ int chunk_threads(int chunk) {
  return ((chunk < CHUNK_THREADS ? chunk : CHUNK_THREADS) + 31) / 32 * 32;
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

template <int FAM, bool P>
__host__ __device__ constexpr int n_acc() {
  return 2 * ((int)Feat<FAM, P>::u1 + (int)Feat<FAM, P>::ut
              + (int)Feat<FAM, P>::uz);
}

// Scratch of the split adjoint, in accumulators (acc_t), row-major:
//   row   (F, 4)                amax, argmax ties, mu, m2 - mu^2
//   tiles (F, n_tt, 2)          pass 1's trapezoid sums of surv and t surv
//   wF    (F, T)                w_j F(t_j)
//   part  (F, n_tc, n_kc, 2)    pass 2's sums of g . P and g . Pv
//   acc   (F, n_tc, n_acc, K)   pass 2's accumulators per grid chunk
// kernels/autotune.py (grad_scratch_elems) sizes it the same way.
struct Layout {
  int n_tt, n_tc, n_kc, n_ep;
  long long row, tiles, wF, part, acc, total;
  __host__ __device__ Layout(const Split& s, int F, int K, int T, int nacc) {
    n_tt = cdiv(T, s.points);
    n_tc = cdiv(T, s.t_chunk);
    n_kc = cdiv(K, s.k_chunk);
    n_ep = cdiv(K, s.ep_chunk);
    row = 0;
    tiles = row + 4LL * F;
    wF = tiles + 2LL * F * n_tt;
    part = wF + (long long)F * T;
    acc = part + 2LL * F * n_tc * n_kc;
    total = acc + (long long)F * n_tc * nacc * K;
  }
};

// Pass 1 of both calls for one block (row f, tile tt of s.points grid
// points): the row's reach maximum (stored by tile 0 at row[0]; with GRAD
// its argmax ties too, at row[1]), then log F(t_j) for the tile's points.
// Thread (p, q) sums log clamp(C_k(t_p)) over the channels k = q,
// q + slices, ... of each shared tile of channel constants; the slices'
// sums are added in slice order. Writes the tile's trapezoid sums of surv
// and t surv to tile[0..1] and, with GRAD, w_j F(t_j) to wF[j].
template <int FAM, bool GRAD>
__device__ void pass1_tile(const Args& a, const Split& s, int f, int tt,
                           acc_t* __restrict__ row, acc_t* __restrict__ tile2,
                           acc_t* __restrict__ wF) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nth = blockDim.x, tid = threadIdx.x;
  Chan<FAM>* tile = reinterpret_cast<Chan<FAM>*>(smem);
  acc_t* s_log = reinterpret_cast<acc_t*>(
      smem + align16((size_t)nth * sizeof(Chan<FAM>)));
  __shared__ acc_t red[33];
  const int K = a.K, T = a.T;

  const float amax = row_amax<FAM>(a, f, red);
  if (tt == 0) {
    if (GRAD) {
      acc_t ties = 0.0;
      for (int k = tid; k < K; k += nth)
        ties += reach<FAM>(load_raw<FAM>(a.W, a.mus, a.sgs, a.ex, f, k, a.F,
                                         K, a.per_row), a.z) == amax
                    ? 1.0 : 0.0;
      ties = block_sum(ties, red);
      if (tid == 0) row[1] = ties;
    }
    if (tid == 0) row[0] = (acc_t)amax;
  }
  const float tmax = fmaxf(amax, 1e-12f);
  const int slices = nth / s.points;
  const int p = tid % s.points, q = tid / s.points;
  const int j = tt * s.points + p;
  const float t = tmax * ((float)j / (float)(T - 1));
  const float lt = (FAM == LOGNORMAL) ? logf(fmaxf(t, TINY)) : 0.0f;
  acc_t logF = 0.0;
  for (int k0 = 0; k0 < K; k0 += nth) {
    const int k = k0 + tid;
    if (k < K)
      tile[tid] = make_chan<FAM>(
          load_raw<FAM>(a.W, a.mus, a.sgs, a.ex, f, k, a.F, K, a.per_row));
    __syncthreads();
    const int n = min(nth, K - k0);
    if (j < T) {
      for (int c = q; c < n; c += slices) {
        const float cv = cdf<FAM>(tile[c], t, lt);
        logF += (acc_t)logf(fminf(fmaxf(cv, CDF_FLOOR), 1.0f));
      }
    }
    __syncthreads();
  }
  s_log[tid] = logF;  // tid == q * points + p
  __syncthreads();
  acc_t s1 = 0.0, s2 = 0.0;
  if (q == 0 && j < T) {
    acc_t lf = 0.0;
    for (int i = 0; i < slices; ++i) lf += s_log[i * s.points + p];
    const acc_t wq = (j == 0 || j == T - 1) ? 0.5 : 1.0;
    const acc_t Fj = exp(lf);
    const acc_t surv = 1.0 - Fj;
    if (GRAD) wF[j] = wq * Fj;
    s1 = wq * surv;
    s2 = wq * (acc_t)t * surv;
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (tid == 0) {
    tile2[0] = s1;
    tile2[1] = s2;
  }
}

// Scratch of the forward call, in accumulators (acc_t), row-major:
//   row   (F)          the reach maximum
//   tiles (F, n_tt, 2) pass 1's trapezoid sums of surv and t surv
// kernels/autotune.py (fwd_scratch_elems) sizes it the same way.
struct FwdLayout {
  int n_tt;
  long long tiles, total;
  __host__ __device__ FwdLayout(const Split& s, int F, int T) {
    n_tt = cdiv(T, s.points);
    tiles = F;
    total = tiles + 2LL * F * n_tt;
  }
};

// Forward pass 1, one block per (row f, tile of s.points grid points).
template <int FAM>
__global__ void __launch_bounds__(MAX_THREADS)
frontier_fwd_pass1(Args a, Split s, acc_t* __restrict__ scratch) {
  const FwdLayout L(s, a.F, a.T);
  const int f = blockIdx.x / L.n_tt, tt = blockIdx.x % L.n_tt;
  pass1_tile<FAM, false>(a, s, f, tt, scratch + f,
                         scratch + L.tiles + 2LL * ((long long)f * L.n_tt + tt),
                         nullptr);
}

// Forward epilogue, one warp per row: the tile sums in tile order (lane
// strided, then a fixed butterfly), then mu and var.
__global__ void __launch_bounds__(32)
frontier_fwd_epilogue(Args a, Split s, const acc_t* __restrict__ scratch,
                      float* __restrict__ mu_out,
                      float* __restrict__ var_out) {
  const FwdLayout L(s, a.F, a.T);
  const int f = blockIdx.x, lane = threadIdx.x;
  const acc_t* tiles = scratch + L.tiles + 2LL * f * L.n_tt;
  acc_t s1 = 0.0, s2 = 0.0;
  for (int i = lane; i < L.n_tt; i += 32) {
    s1 += tiles[2 * i];
    s2 += tiles[2 * i + 1];
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    const float tmax = fmaxf((float)scratch[f], 1e-12f);
    const acc_t dt = (acc_t)tmax / (acc_t)(a.T - 1);
    const acc_t mu = s1 * dt;
    const acc_t m2 = 2.0 * s2 * dt;
    mu_out[f] = (float)mu;
    var_out[f] = (float)fmax(m2 - mu * mu, (acc_t)0);
  }
}

// Adjoint pass 1, one block per (row f, tile of s.points grid points).
template <int FAM>
__global__ void __launch_bounds__(MAX_THREADS)
frontier_grad_pass1(Args a, Split s, acc_t* __restrict__ scratch) {
  const Layout L(s, a.F, a.K, a.T, 0);
  const int f = blockIdx.x / L.n_tt, tt = blockIdx.x % L.n_tt;
  pass1_tile<FAM, true>(a, s, f, tt, scratch + L.row + 4LL * f,
                        scratch + L.tiles + 2LL * ((long long)f * L.n_tt + tt),
                        scratch + L.wF + (long long)f * a.T);
}

// Pass 2, one block per (row f, chunk of s.t_chunk grid points, chunk of
// s.k_chunk channels): the row's mu from pass 1's tile sums (in tile order,
// the same in every block), the chunk's grid to shared memory, then for
// each of the thread's channels its accumulators over the chunk in grid
// order. Writes the accumulators and the block's sums of g . P and g . Pv
// over its channels.
template <int FAM, bool P>
__global__ void __launch_bounds__(MAX_THREADS)
frontier_grad_pass2(Args a, Split s, GradOut o) {
  using Fe = Feat<FAM, P>;
  constexpr int NACC = n_acc<FAM, P>();
  constexpr int S0 = 0;
  constexpr int S1 = S0 + (Fe::u1 ? 2 : 0);
  constexpr int SZ = S1 + (Fe::ut ? 2 : 0);
  extern __shared__ __align__(16) unsigned char smem[];
  const int nth = blockDim.x, tid = threadIdx.x;
  const int K = a.K, T = a.T;
  const int cap = min(s.t_chunk, T);
  acc_t* s_tmu = reinterpret_cast<acc_t*>(smem);
  float* s_wF = reinterpret_cast<float*>(s_tmu + cap);
  float* s_t = s_wF + cap;
  float* s_lt = s_t + cap;
  __shared__ acc_t red[33];
  acc_t* scratch = o.scratch;
  const Layout L(s, a.F, K, T, NACC);
  const int per_row = L.n_tc * L.n_kc;
  const int f = blockIdx.x / per_row, r = blockIdx.x % per_row;
  const int tc = r / L.n_kc, kc = r % L.n_kc;

  // the row's moments
  const acc_t* tiles = scratch + L.tiles + 2LL * f * L.n_tt;
  acc_t s1 = 0.0, s2 = 0.0;
  for (int i = tid; i < L.n_tt; i += nth) {
    s1 += tiles[2 * i];
    s2 += tiles[2 * i + 1];
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  const float amax = (float)scratch[L.row + 4LL * f];
  const float tmax = fmaxf(amax, 1e-12f);
  const acc_t dt = (acc_t)tmax / (acc_t)(T - 1);
  const acc_t mu = s1 * dt;
  const acc_t m2 = 2.0 * s2 * dt;
  const acc_t var_raw = m2 - mu * mu;
  if (r == 0 && tid == 0) {
    o.mu[f] = (float)mu;
    o.var[f] = (float)fmax(var_raw, (acc_t)0);
    scratch[L.row + 4LL * f + 2] = mu;
    scratch[L.row + 4LL * f + 3] = var_raw;
  }

  // the chunk's grid: t_j, log t_j, w_j F(t_j) and t_j - mu
  const int j0 = tc * s.t_chunk;
  const int nj = min(s.t_chunk, T - j0);
  for (int i = tid; i < nj; i += nth) {
    const int j = j0 + i;
    const float t = tmax * ((float)j / (float)(T - 1));
    s_t[i] = t;
    s_lt[i] = (FAM == LOGNORMAL) ? logf(fmaxf(t, TINY)) : 0.0f;
    s_tmu[i] = (acc_t)t - mu;
    s_wF[i] = (float)scratch[L.wF + (long long)f * T + j];
  }
  __syncthreads();

  const int k_end = min(K, (kc + 1) * s.k_chunk);
  acc_t* acc = scratch + L.acc + ((long long)f * L.n_tc + tc) * NACC * K;
  acc_t g_mu = 0.0, g_var = 0.0;
  for (int k = kc * s.k_chunk + tid; k < k_end; k += nth) {
    const Raw rw = load_raw<FAM>(a.W, a.mus, a.sgs, a.ex, f, k, a.F, K,
                                 a.per_row);
    const Chan<FAM> ch = make_chan<FAM>(rw);
    acc_t P0 = 0.0, Pv0 = 0.0, P1 = 0.0, Pv1 = 0.0, Pz = 0.0, Pvz = 0.0;
    if (ch.ok != 0.0f) {
      for (int i = 0; i < nj; ++i) {
        const float tj = s_t[i];
        const acc_t tmu = s_tmu[i];
        float craw, D, zj;
        adjoint_parts<FAM>(ch, tj, s_lt[i], craw, D, zj);
        const float Cc = fminf(fmaxf(craw, CDF_FLOOR), 1.0f);
        const float gate = (craw >= 1.0f ? 0.5f : 1.0f)
                           * (craw > CDF_FLOOR ? 1.0f : 0.0f);
        const acc_t av = (acc_t)(s_wF[i] * (gate * D / Cc));
        if (Fe::u1) { P0 += av; Pv0 += av * tmu; }
        if (Fe::ut) { const acc_t at = av * (acc_t)tj; P1 += at; Pv1 += at * tmu; }
        if (Fe::uz) { const acc_t az = av * (acc_t)zj; Pz += az; Pvz += az * tmu; }
      }
    }
    if (Fe::u1) { acc[(S0 + 0) * K + k] = P0; acc[(S0 + 1) * K + k] = Pv0; }
    if (Fe::ut) { acc[(S1 + 0) * K + k] = P1; acc[(S1 + 1) * K + k] = Pv1; }
    if (Fe::uz) { acc[(SZ + 0) * K + k] = Pz; acc[(SZ + 1) * K + k] = Pvz; }
    float al, be, g0, g1;
    coeffs<FAM>(rw, al, be, g0, g1);
    g_mu += (acc_t)g0 * P0 + (acc_t)g1 * P1;
    g_var += (acc_t)g0 * Pv0 + (acc_t)g1 * Pv1;
  }
  g_mu = block_sum(g_mu, red);
  g_var = block_sum(g_var, red);
  if (tid == 0) {
    acc_t* part = scratch + L.part
                  + 2LL * (((long long)f * L.n_tc + tc) * L.n_kc + kc);
    part[0] = g_mu;
    part[1] = g_var;
  }
}

// The outputs of channel k of row f: its accumulators summed over the grid
// chunks in chunk order, then the fixed-grid plus moving-grid (tmax) terms.
template <int FAM, bool P>
__device__ void epilogue_channel(const Args& a, const GradOut& o,
                                 const Layout& L, int f, int k, float amax,
                                 acc_t n_tie, acc_t dt, acc_t b_mu,
                                 acc_t b_var, acc_t live, bool var_pos) {
  using Fe = Feat<FAM, P>;
  constexpr int NACC = n_acc<FAM, P>();
  constexpr int S0 = 0;
  constexpr int S1 = S0 + (Fe::u1 ? 2 : 0);
  constexpr int SZ = S1 + (Fe::ut ? 2 : 0);
  const int K = a.K;
  const Raw r = load_raw<FAM>(a.W, a.mus, a.sgs, a.ex, f, k, a.F, K,
                              a.per_row);
  acc_t P0 = 0.0, Pv0 = 0.0, P1 = 0.0, Pv1 = 0.0, Pz = 0.0, Pvz = 0.0;
  const acc_t* acc = o.scratch + L.acc + (long long)f * L.n_tc * NACC * K;
  for (int c = 0; c < L.n_tc; ++c, acc += (long long)NACC * K) {
    if (Fe::u1) { P0 += acc[(S0 + 0) * K + k]; Pv0 += acc[(S0 + 1) * K + k]; }
    if (Fe::ut) { P1 += acc[(S1 + 0) * K + k]; Pv1 += acc[(S1 + 1) * K + k]; }
    if (Fe::uz) { Pz += acc[(SZ + 0) * K + k]; Pvz += acc[(SZ + 1) * K + k]; }
  }
  const acc_t ind = reach<FAM>(r, a.z) == amax ? 1.0 : 0.0;
  const acc_t tie = ind / n_tie * live;
  const long long fk = (long long)f * K + k;

  auto contract = [&](float c1, float ct, float cz, float dre, float* dmu,
                      float* dvar) {
    const acc_t gvec = (acc_t)dre * tie;
    const acc_t fix = (acc_t)c1 * P0 + (acc_t)ct * P1 + (acc_t)cz * Pz;
    const acc_t fixv = (acc_t)c1 * Pv0 + (acc_t)ct * Pv1 + (acc_t)cz * Pvz;
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

// Epilogue, one block per (row f, chunk of s.ep_chunk channels): the
// row-wide sums S_mu and S_var from pass 2's partials (in a fixed order,
// the same in every block), then the outputs of each of the block's
// channels.
template <int FAM, bool P>
__global__ void __launch_bounds__(MAX_THREADS)
frontier_grad_epilogue(Args a, Split s, GradOut o) {
  __shared__ acc_t red[33];
  const int nth = blockDim.x, tid = threadIdx.x;
  const int K = a.K, T = a.T;
  const Layout L(s, a.F, K, T, n_acc<FAM, P>());
  const int f = blockIdx.x / L.n_ep, e = blockIdx.x % L.n_ep;

  const acc_t* part = o.scratch + L.part + 2LL * f * L.n_tc * L.n_kc;
  acc_t sm = 0.0, sv = 0.0;
  for (int i = tid; i < L.n_tc * L.n_kc; i += nth) {
    sm += part[2 * i];
    sv += part[2 * i + 1];
  }
  const acc_t S_mu = block_sum(sm, red);
  const acc_t S_var = block_sum(sv, red);
  const acc_t* row = o.scratch + L.row + 4LL * f;
  const float amax = (float)row[0];
  const acc_t n_tie = row[1], mu = row[2], var_raw = row[3];
  const float tmax = fmaxf(amax, 1e-12f);
  const acc_t dt = (acc_t)tmax / (acc_t)(T - 1);
  const acc_t tmx = (acc_t)tmax;
  const acc_t b_mu = (mu - dt * S_mu) / tmx;
  const acc_t b_var = 2.0 * (var_raw - dt * S_var) / tmx;
  const acc_t live = amax > 1e-12f ? 1.0 : 0.0;
  const bool var_pos = var_raw > 0.0;
  const int k_end = min(K, (e + 1) * s.ep_chunk);
  for (int k = e * s.ep_chunk + tid; k < k_end; k += nth)
    epilogue_channel<FAM, P>(a, o, L, f, k, amax, n_tie, dt, b_mu, b_var,
                             live, var_pos);
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename Kernel>
cudaError_t fit_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Pass 1's block shape: threads a multiple of 32 up to MAX_THREADS, tiles
// of a power of two of grid points dividing them.
__host__ bool pass1_ok(const Args& a, int threads, const Split& s) {
  return threads >= 32 && threads <= MAX_THREADS && threads % 32 == 0
         && s.points >= 1 && (s.points & (s.points - 1)) == 0
         && threads % s.points == 0 && a.T >= 2;
}

template <int FAM>
size_t pass1_smem(int threads) {
  return align16((size_t)threads * sizeof(Chan<FAM>))
         + (size_t)threads * sizeof(acc_t);
}

// The split forward moments: two launches on one stream (pass 1, then the
// epilogue reading its tile sums).
template <int FAM>
cudaError_t fwd_launch(Args a, int threads, Split s, float* mu_out,
                       float* var_out, acc_t* scratch,
                       long long scratch_elems, cudaStream_t stream) {
  if (!pass1_ok(a, threads, s)) return cudaErrorInvalidValue;
  const FwdLayout L(s, a.F, a.T);
  if (scratch_elems < L.total) return cudaErrorInvalidValue;
  const size_t smem1 = pass1_smem<FAM>(threads);
  cudaError_t err = fit_smem(frontier_fwd_pass1<FAM>, smem1);
  if (err != cudaSuccess) return err;
  frontier_fwd_pass1<FAM><<<a.F * L.n_tt, threads, smem1, stream>>>(
      a, s, scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  frontier_fwd_epilogue<<<a.F, 32, 0, stream>>>(a, s, scratch, mu_out,
                                                 var_out);
  return cudaGetLastError();
}

// The split adjoint: three launches on one stream (pass 1, pass 2,
// epilogue), each reading what the one before it wrote.
template <int FAM, bool P>
cudaError_t grad_launch(Args a, int threads, Split s, GradOut o,
                        long long scratch_elems, cudaStream_t stream) {
  if (!pass1_ok(a, threads, s) || s.t_chunk < 1 || s.k_chunk < 1
      || s.ep_chunk < 1)
    return cudaErrorInvalidValue;
  const Layout L(s, a.F, a.K, a.T, n_acc<FAM, P>());
  if (scratch_elems < L.total) return cudaErrorInvalidValue;
  const size_t smem1 = pass1_smem<FAM>(threads);
  const size_t smem2 =
      (size_t)min(s.t_chunk, a.T) * (sizeof(acc_t) + 3 * sizeof(float));
  cudaError_t err = fit_smem(frontier_grad_pass1<FAM>, smem1);
  if (err == cudaSuccess) err = fit_smem(frontier_grad_pass2<FAM, P>, smem2);
  if (err != cudaSuccess) return err;
  frontier_grad_pass1<FAM><<<a.F * L.n_tt, threads, smem1, stream>>>(
      a, s, o.scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  frontier_grad_pass2<FAM, P><<<a.F * L.n_tc * L.n_kc,
                                chunk_threads(s.k_chunk), smem2, stream>>>(
      a, s, o);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  frontier_grad_epilogue<FAM, P><<<a.F * L.n_ep, chunk_threads(s.ep_chunk),
                                   0, stream>>>(a, s, o);
  return cudaGetLastError();
}

}  // namespace fg

using namespace fg;

extern "C" {

// Bytes of one accumulator (8, or 4 in a -DFG_ACC=float build): the caller
// sizes the fused kernel's scratch with it.
int fg_acc_bytes() { return (int)sizeof(acc_t); }

// Forward moments in two launches. stats holds mu then var (2 F floats);
// pass 1 runs blocks of `threads` over tiles of `points` grid points;
// scratch holds scratch_elems accumulators, at least the split's FwdLayout
// (else cudaErrorInvalidValue). Returns a cudaError_t value (0 on
// success).
int fg_forward(int fam, const float* W, const float* mus, const float* sgs,
               const float* ex, int per_row, int F, int K, int T, float z,
               int threads, int points, float* stats, acc_t* scratch,
               long long scratch_elems, void* stream) {
  Args a{W, mus, sgs, ex, per_row, F, K, T, z};
  const Split sp{points, 0, 0, 0};
  float* mu = stats;
  float* var = stats + F;
  const long long n = scratch_elems;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fam) {
    case NORMAL: return fwd_launch<NORMAL>(a, threads, sp, mu, var, scratch, n, s);
    case LOGNORMAL: return fwd_launch<LOGNORMAL>(a, threads, sp, mu, var, scratch, n, s);
    case DRIFT: return fwd_launch<DRIFT>(a, threads, sp, mu, var, scratch, n, s);
    case EMPIRICAL: return fwd_launch<EMPIRICAL>(a, threads, sp, mu, var, scratch, n, s);
    case DEFECTIVE: return fwd_launch<DEFECTIVE>(a, threads, sp, mu, var, scratch, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Fused moments and adjoints in three launches. stats holds mu then var
// (2 F floats); outs the 2 (param_grads == 0) or 8 (F, K) adjoints one
// after the other; (points, t_chunk, k_chunk, ep_chunk) is the split and
// threads pass 1's block; scratch holds scratch_elems accumulators, at
// least the split's Layout (else cudaErrorInvalidValue).
int fg_grad(int fam, int param_grads, const float* W, const float* mus,
            const float* sgs, const float* ex, int per_row, int F, int K,
            int T, float z, int threads, int points, int t_chunk,
            int k_chunk, int ep_chunk, float* stats, float* outs,
            acc_t* scratch, long long scratch_elems, void* stream) {
  Args a{W, mus, sgs, ex, per_row, F, K, T, z};
  Split sp{points, t_chunk, k_chunk, ep_chunk};
  GradOut o;
  o.mu = stats;
  o.var = stats + F;
  for (int i = 0; i < 8; ++i)
    o.d[i] = (i < 2 || param_grads) ? outs + (long long)i * F * K : nullptr;
  o.scratch = scratch;
  const long long n = scratch_elems;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (param_grads) {
    switch (fam) {
      case NORMAL: return grad_launch<NORMAL, true>(a, threads, sp, o, n, s);
      case LOGNORMAL: return grad_launch<LOGNORMAL, true>(a, threads, sp, o, n, s);
      case DRIFT: return grad_launch<DRIFT, true>(a, threads, sp, o, n, s);
      case EMPIRICAL: return grad_launch<EMPIRICAL, true>(a, threads, sp, o, n, s);
      case DEFECTIVE: return grad_launch<DEFECTIVE, true>(a, threads, sp, o, n, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (fam) {
    case NORMAL: return grad_launch<NORMAL, false>(a, threads, sp, o, n, s);
    case LOGNORMAL: return grad_launch<LOGNORMAL, false>(a, threads, sp, o, n, s);
    case DRIFT: return grad_launch<DRIFT, false>(a, threads, sp, o, n, s);
    case EMPIRICAL: return grad_launch<EMPIRICAL, false>(a, threads, sp, o, n, s);
    case DEFECTIVE: return grad_launch<DEFECTIVE, false>(a, threads, sp, o, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
