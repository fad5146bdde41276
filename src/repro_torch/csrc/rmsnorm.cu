// RMSNorm over the last axis: y = (x * rsqrt(mean(x^2) + eps)) * w.
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` of the JAX package's
// src/repro/kernels/rmsnorm.py (`rmsnorm`). As there, the math is float32
// whatever the storage type, and y has x's dtype.
//
// What bounds it on the H100: bytes. Each element is read, squared and
// summed, then scaled and written: ~4 operations per element against 4
// bytes moved in bf16 (8 in float32), far below the card's ~20 FP32
// operations per byte of device memory. So the kernel reads x once from
// device memory, in 16-byte vectors (8 bf16 or 4 float32 a load), keeps the
// row in registers between the sum of squares and the scaling, reads w
// through the read-only path and writes y in 16-byte vectors. At the
// serving path's shapes (a few dozen to a few thousand rows) a call is one
// or two microseconds of device time, and launch latency, not bandwidth,
// sets it; at 32768 rows of 4096 it is bandwidth.
//
// Forms, chosen per call from D and the pointers (a shape rule, every one
// computing the same function):
// * rows of at most 32 vectors (D <= 256 in bf16, 128 in float32: the
//   per-head q/k norms): a group of G lanes per row, G the power of two
//   covering the row's vectors, several rows per warp (a 128-wide bf16 row
//   is 16 lanes of 16 bytes, two rows a warp);
// * longer rows, up to 4096 vectors (D = 32768 in bf16): one block per row
//   whose size fits D, each thread holding NV whole vectors (D = 2560, 4096,
//   5120 in bf16: 160, 256, 160 threads of 2, 2, 4 vectors);
// * a row whose length is not a whole number of vectors, a pointer not on
//   16 bytes (a view with a storage offset), or a longer row: the scalar
//   form, one element per thread per step with a second read of the row
//   from cache.
// Sums of squares are float32: a per-thread sum in element order, a
// fixed-order butterfly over the lanes of a row and, for a block, a
// fixed-order sum of the warps' partials, so two runs give the same bits.
//
// Split rows (a row whose columns lie on several ranks: Mamba2's gated norm
// over the rank's SSD heads under tensor parallelism). rmsnorm_stat_kernel
// writes each row's float32 partial, sum(x^2) of the rank's columns (or
// sum(x w dy) for the backward), one warp a row; the caller all-reduces it
// over the ranks; then every form above, instantiated with SPLIT, reads the
// row's total from that array instead of summing its own columns, and
// divides by the global width n: y = x rsqrt(ss / n + eps) w. The backward
// forms do the same with both totals, and each rank's dw is the sum over
// rows of its own columns, with no sum over the ranks.
#include "dtype.cuh"

namespace {

constexpr int GROUP_BLOCK = 256;        // threads of the lane-group form
constexpr int MAX_ROW_THREADS = 512;    // threads of the vector block form
constexpr int MAX_NV = 8;               // vectors per thread, block form
constexpr int WARP_ROWS_PER_BLOCK = 4;  // rows of the scalar one-warp form
constexpr int BLOCK_THREADS = 256;      // threads of the scalar block form

// 16 bytes of T, widened to float and back
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 store(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // the element at the lower address is the low half; widening is exact
  static __device__ __forceinline__ float2 pair(unsigned int u) {
    return make_float2(__uint_as_float(u << 16),
                       __uint_as_float(u & 0xffff0000u));
  }
  static __device__ __forceinline__ unsigned int pack(float a, float b) {
    return (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(a))
           | ((unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(b))
              << 16);
  }
  static __device__ __forceinline__ void load(const uint4& u, float* v) {
    const float2 a = pair(u.x), b = pair(u.y), c = pair(u.z), d = pair(u.w);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    v[4] = c.x; v[5] = c.y; v[6] = d.x; v[7] = d.y;
  }
  static __device__ __forceinline__ uint4 store(const float* v) {
    return make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
                      pack(v[6], v[7]));
  }
};

// y = (x * r) * w for one vector, rounded to T
template <typename T>
__device__ __forceinline__ uint4 scale(const float* v, float r,
                                       const uint4& wv) {
  constexpr int N = Vec<T>::N;
  float wf[N], o[N];
  Vec<T>::load(wv, wf);
#pragma unroll
  for (int e = 0; e < N; ++e) o[e] = (v[e] * r) * wf[e];
  return Vec<T>::store(o);
}

// Lane-group form: G lanes per row, one vector each (G covers nvec <= 32).
template <typename T, int G, bool SPLIT>
__global__ void __launch_bounds__(GROUP_BLOCK)
rmsnorm_group_kernel(const uint4* __restrict__ x, const uint4* __restrict__ w,
                     uint4* __restrict__ y, const float* __restrict__ stat,
                     long long rows, int nvec, float d, float eps) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x % G;
  const long long row = (long long)blockIdx.x * (GROUP_BLOCK / G)
                        + threadIdx.x / G;
  const bool live = row < rows && lane < nvec;
  float v[N];
  float ss = 0.f;
  if (live) {
    Vec<T>::load(x[row * nvec + lane], v);
    if (!SPLIT)
#pragma unroll
      for (int e = 0; e < N; ++e) ss += v[e] * v[e];
  }
  // butterfly within the group of G lanes (all lanes of the warp take part)
  if (!SPLIT)
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (!live) return;
  if (SPLIT) ss = stat[row];
  const float r = rsqrtf(ss / d + eps);
  y[row * nvec + lane] = scale<T>(v, r, __ldg(w + lane));
}

// Vector block form: one row per block, each thread NV whole vectors
// (vector i * blockDim + tid), masked past nvec.
template <typename T, int NV, bool SPLIT>
__global__ void __launch_bounds__(MAX_ROW_THREADS)
rmsnorm_row_kernel(const uint4* __restrict__ x, const uint4* __restrict__ w,
                   uint4* __restrict__ y, const float* __restrict__ stat,
                   int nvec, float d, float eps) {
  constexpr int N = Vec<T>::N;
  __shared__ float partial[MAX_ROW_THREADS / 32];
  __shared__ float total;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * nvec;
  float v[NV][N];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * nth + tid;
    if (c < nvec) {
      Vec<T>::load(x[base + c], v[i]);
      if (!SPLIT)
#pragma unroll
        for (int e = 0; e < N; ++e) ss += v[i][e] * v[i][e];
    }
  }
  if (!SPLIT) {
    ss = warp_sum(ss);
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    if (warp == 0) {
      float t = lane < (nth >> 5) ? partial[lane] : 0.f;
      t = warp_sum(t);
      if (lane == 0) total = t;
    }
    __syncthreads();
  }
  const float r = rsqrtf((SPLIT ? stat[blockIdx.x] : total) / d + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * nth + tid;
    if (c < nvec) y[base + c] = scale<T>(v[i], r, __ldg(w + c));
  }
}

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(32 * WARP_ROWS_PER_BLOCK)
rmsnorm_warp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, const float* __restrict__ stat,
                    long long rows, int D, float d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * WARP_ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * D;
  float ss = 0.f;
  if (SPLIT) {
    ss = stat[row];
  } else {
    for (int i = lane; i < D; i += 32) {
      const float v = to_f32(xr[i]);
      ss += v * v;
    }
    ss = warp_sum(ss);
  }
  const float r = rsqrtf(ss / d + eps);
  T* yr = y + row * D;
  for (int i = lane; i < D; i += 32)
    yr[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(w[i]));
}

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(BLOCK_THREADS)
rmsnorm_block_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, const float* __restrict__ stat, int D,
                     float d, float eps) {
  __shared__ float partial[BLOCK_THREADS / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  if (SPLIT) {
    if (threadIdx.x == 0) total = stat[row];
  } else {
    float ss = 0.f;
    for (int i = threadIdx.x; i < D; i += BLOCK_THREADS) {
      const float v = to_f32(xr[i]);
      ss += v * v;
    }
    ss = warp_sum(ss);
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    if (warp == 0) {
      float t = lane < BLOCK_THREADS / 32 ? partial[lane] : 0.f;
      t = warp_sum(t);
      if (lane == 0) total = t;
    }
  }
  __syncthreads();
  const float r = rsqrtf(total / d + eps);
  T* yr = y + row * D;
  for (int i = threadIdx.x; i < D; i += BLOCK_THREADS)
    yr[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(w[i]));
}

template <typename T, int G, bool SPLIT>
void launch_group(const uint4* x, const uint4* w, uint4* y,
                  const float* stat, long long rows, int nvec, float d,
                  float eps, cudaStream_t stream) {
  const long long blocks = (rows + GROUP_BLOCK / G - 1) / (GROUP_BLOCK / G);
  rmsnorm_group_kernel<T, G, SPLIT>
      <<<(unsigned)blocks, GROUP_BLOCK, 0, stream>>>(x, w, y, stat, rows,
                                                     nvec, d, eps);
}

template <typename T, int NV, bool SPLIT>
void launch_row(const uint4* x, const uint4* w, uint4* y, const float* stat,
                long long rows, int nvec, float d, float eps,
                cudaStream_t stream) {
  const int threads = ((nvec + NV - 1) / NV + 31) / 32 * 32;
  rmsnorm_row_kernel<T, NV, SPLIT><<<(unsigned)rows, threads, 0, stream>>>(
      x, w, y, stat, nvec, d, eps);
}

// Vectors per thread of the block form: the fewest that give a whole
// number of vectors per thread in whole warps of at most 256 threads, else
// of at most 512, else the fewest that cover the row in 512 threads.
int pick_nv(int nvec) {
  for (int cap = 256; cap <= MAX_ROW_THREADS; cap *= 2)
    for (int nv = 1; nv <= MAX_NV; nv *= 2)
      if (nvec % nv == 0 && (nvec / nv) % 32 == 0 && nvec / nv <= cap)
        return nv;
  for (int nv = 1; nv <= MAX_NV; nv *= 2)
    if (nvec <= nv * MAX_ROW_THREADS) return nv;
  return 0;
}

// SPLIT: the rows' sums of squares come in ``stat`` and n is the global
// width; otherwise stat is null and n is D
template <typename T, bool SPLIT>
int launch(const void* x, const void* w, void* y, const float* stat,
           long long rows, int D, float n, float eps, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const unsigned long long addr = reinterpret_cast<unsigned long long>(x)
                                  | reinterpret_cast<unsigned long long>(w)
                                  | reinterpret_cast<unsigned long long>(y);
  const int nvec = D / N;
  const int nv = (addr % 16 == 0 && D % N == 0) ? pick_nv(nvec) : 0;
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* wv = static_cast<const uint4*>(w);
  uint4* yv = static_cast<uint4*>(y);
  const float d = n;
#define RN_FWD_ARGS xv, wv, yv, stat, rows, nvec, d, eps, stream
  if (nv != 0 && nvec <= 32) {
    if (nvec <= 1) launch_group<T, 1, SPLIT>(RN_FWD_ARGS);
    else if (nvec <= 2) launch_group<T, 2, SPLIT>(RN_FWD_ARGS);
    else if (nvec <= 4) launch_group<T, 4, SPLIT>(RN_FWD_ARGS);
    else if (nvec <= 8) launch_group<T, 8, SPLIT>(RN_FWD_ARGS);
    else if (nvec <= 16) launch_group<T, 16, SPLIT>(RN_FWD_ARGS);
    else launch_group<T, 32, SPLIT>(RN_FWD_ARGS);
  } else if (nv == 1) {
    launch_row<T, 1, SPLIT>(RN_FWD_ARGS);
  } else if (nv == 2) {
    launch_row<T, 2, SPLIT>(RN_FWD_ARGS);
  } else if (nv == 4) {
    launch_row<T, 4, SPLIT>(RN_FWD_ARGS);
  } else if (nv == 8) {
    launch_row<T, 8, SPLIT>(RN_FWD_ARGS);
  } else {
    const T* xp = static_cast<const T*>(x);
    const T* wp = static_cast<const T*>(w);
    T* yp = static_cast<T*>(y);
    if (D <= 256) {
      const long long blocks =
          (rows + WARP_ROWS_PER_BLOCK - 1) / WARP_ROWS_PER_BLOCK;
      rmsnorm_warp_kernel<T, SPLIT>
          <<<(unsigned)blocks, 32 * WARP_ROWS_PER_BLOCK, 0, stream>>>(
              xp, wp, yp, stat, rows, D, d, eps);
    } else {
      rmsnorm_block_kernel<T, SPLIT>
          <<<(unsigned)rows, BLOCK_THREADS, 0, stream>>>(xp, wp, yp, stat, D,
                                                         d, eps);
    }
  }
#undef RN_FWD_ARGS
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- row sums
//
// One row's float32 partial over this rank's D columns: sum(x^2), or with
// DOT sum(x w dy). One warp a row, STAT_WARPS rows a block; 16-byte
// vectors (VEC) where D is a whole number of them and the pointers are on
// 16 bytes, else one element a lane a step. A lane sums its elements in
// order, then a fixed-order butterfly: two runs give the same bits.
constexpr int STAT_WARPS = 8;

template <typename T, bool VEC, bool DOT>
__global__ void __launch_bounds__(32 * STAT_WARPS)
rmsnorm_stat_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ dy, float* __restrict__ stat,
                    long long rows, int D) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * STAT_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  float s = 0.f;
  if (VEC) {
    constexpr int N = Vec<T>::N;
    const int nvec = D / N;
    const uint4* xv = reinterpret_cast<const uint4*>(x + row * D);
    const uint4* gv =
        DOT ? reinterpret_cast<const uint4*>(dy + row * D) : nullptr;
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    for (int c = lane; c < nvec; c += 32) {
      float a[N];
      Vec<T>::load(xv[c], a);
      if (DOT) {
        float g[N], ww[N];
        Vec<T>::load(gv[c], g);
        Vec<T>::load(__ldg(wv + c), ww);
#pragma unroll
        for (int e = 0; e < N; ++e) s += a[e] * ww[e] * g[e];
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) s += a[e] * a[e];
      }
    }
  } else {
    const T* xr = x + row * D;
    for (int i = lane; i < D; i += 32) {
      const float a = to_f32(xr[i]);
      s += DOT ? a * to_f32(w[i]) * to_f32(dy[row * D + i]) : a * a;
    }
  }
  s = warp_sum(s);
  if (lane == 0) stat[row] = s;
}

template <typename T>
int launch_stat(const void* x, const void* w, const void* dy, float* stat,
                long long rows, int D, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const bool dot = dy != nullptr;
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(x)
      | (dot ? reinterpret_cast<unsigned long long>(w)
                   | reinterpret_cast<unsigned long long>(dy)
             : 0ull);
  const bool vec = addr % 16 == 0 && D % N == 0;
  const unsigned blocks = (unsigned)((rows + STAT_WARPS - 1) / STAT_WARPS);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* gp = static_cast<const T*>(dy);
#define RN_STAT(V, DT)                                                  \
  rmsnorm_stat_kernel<T, V, DT><<<blocks, 32 * STAT_WARPS, 0, stream>>>( \
      xp, wp, gp, stat, rows, D)
  if (vec && dot) RN_STAT(true, true);
  else if (vec) RN_STAT(true, false);
  else if (dot) RN_STAT(false, true);
  else RN_STAT(false, false);
#undef RN_STAT
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// rmsnorm_bwd: the gradient of y = (x * r) * w, r = rsqrt(mean(x^2) + eps),
// that autograd takes through the JAX package's XLA rms_norm (which
// jax.grad differentiates there; its Pallas kernel has no backward):
//   dx = r (w dy) - x r^3 mean(x w dy),   dw = sum over rows of dy x r,
// float32 sums, dx in x's dtype and dw in w's. Bound by bytes like the
// forward (x and dy read, dx written, ~10 operations an element). Forms,
// chosen per call from D and the pointers as the forward's are:
// * rows of at most 32 vectors: lane groups of G lanes a row, one 16-byte
//   vector each, several rows a warp (rmsnorm_bwd_group_kernel);
// * rows of up to 2048 vectors: a row group of W warps a row (W = 1, 2, 4,
//   8 or 16, the fewest that give a thread at most BWD_NV vectors), 8 warps
//   a block, 16 for W = 16 (rmsnorm_bwd_rows_kernel);
// * a row that is not a whole number of vectors, a pointer off 16 bytes, or
//   a longer row: the scalar form, one row at a time a block, the block's
//   dw columns in shared memory (rmsnorm_bwd_scalar_kernel).
// In the vector forms each thread reads its vectors of x and dy once and
// keeps them in registers; the row's two sums (x^2 and x w dy) come from
// one fixed-order butterfly (for W > 1 then a fixed-order sum of the
// group's warps through shared memory, double-buffered, one named barrier
// a row); dx is written from the registers; w is read once; each thread
// keeps its columns' dw partial in registers across the rows it walks, and
// the block's row groups (and a warp's lane groups) add theirs in a fixed
// order into one partial row a block. The blocks, each a fixed run of rows,
// follow from the row count alone. rmsnorm_dw_kernel then sums the (blocks,
// D) float32 partials: each block 8 columns, 32 threads a column, each
// adding every 32nd partial row in order, then the 32 sums in order. No
// atomics: two runs give the same bits.

constexpr int BWD_BLOCKS = 264;   // 2 blocks for each of the H100's 132 SMs
constexpr int BWD_NV = 4;         // vectors per thread, row-group form
constexpr int BWD_THREADS = 256;  // threads of a backward block (W <= 8)

// x^2 and x w dy summed over one vector, and its slice of dx and dw
template <typename T>
__device__ __forceinline__ void bwd_sums(const uint4& xv, const uint4& gv,
                                         const uint4& wv, float& ss,
                                         float& dot) {
  constexpr int N = Vec<T>::N;
  float x[N], g[N], w[N];
  Vec<T>::load(xv, x);
  Vec<T>::load(gv, g);
  Vec<T>::load(wv, w);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    ss += x[e] * x[e];
    dot += x[e] * w[e] * g[e];
  }
}

template <typename T>
__device__ __forceinline__ uint4 bwd_dx(const uint4& xv, const uint4& gv,
                                        const uint4& wv, float r, float coef,
                                        float* dw) {
  constexpr int N = Vec<T>::N;
  float x[N], g[N], w[N], o[N];
  Vec<T>::load(xv, x);
  Vec<T>::load(gv, g);
  Vec<T>::load(wv, w);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    o[e] = r * (w[e] * g[e]) - x[e] * coef;
    dw[e] += g[e] * x[e] * r;
  }
  return Vec<T>::store(o);
}

// Lane-group form: G lanes a row (G covers nvec <= 32), BWD_THREADS / G
// rows in flight a block; every thread takes the same number of steps so
// that whole warps meet at each butterfly.
template <typename T, int G, bool SPLIT>
__global__ void __launch_bounds__(BWD_THREADS)
rmsnorm_bwd_group_kernel(const uint4* __restrict__ x,
                         const uint4* __restrict__ w,
                         const uint4* __restrict__ dy, uint4* __restrict__ dx,
                         float* __restrict__ dw_part,
                         const float* __restrict__ ss_in,
                         const float* __restrict__ dot_in, long long rows,
                         long long rows_per_block, int nvec, float d,
                         float eps) {
  constexpr int N = Vec<T>::N, SLOTS = BWD_THREADS / G;
  __shared__ float sdw[BWD_THREADS / 32][32 * 8];  // [warp][column]
  const int lane = threadIdx.x % G, slot = threadIdx.x / G;
  const int warp = threadIdx.x >> 5;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, rows);
  const bool col = lane < nvec;
  const uint4 wv = col ? __ldg(w + lane) : make_uint4(0, 0, 0, 0);
  float dwp[N];
#pragma unroll
  for (int e = 0; e < N; ++e) dwp[e] = 0.f;
  for (long long base = r0; base < r1; base += SLOTS) {
    const long long row = base + slot;
    const bool live = row < r1 && col;
    uint4 xv = make_uint4(0, 0, 0, 0), gv = xv;
    float ss = 0.f, dot = 0.f;
    if (live) {
      xv = x[row * nvec + lane];
      gv = dy[row * nvec + lane];
      if (!SPLIT) bwd_sums<T>(xv, gv, wv, ss, dot);
    }
    if (!SPLIT)
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
    if (live) {
      if (SPLIT) {
        ss = ss_in[row];
        dot = dot_in[row];
      }
      const float r = rsqrtf(ss / d + eps);
      dx[row * nvec + lane] =
          bwd_dx<T>(xv, gv, wv, r, r * r * r * (dot / d), dwp);
    }
  }
  // the warp's rows, then the block's warps, each in a fixed order
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < N; ++e)
      dwp[e] += __shfl_xor_sync(0xffffffffu, dwp[e], off);
  if ((threadIdx.x & 31) < G && col)
#pragma unroll
    for (int e = 0; e < N; ++e) sdw[warp][lane * N + e] = dwp[e];
  __syncthreads();
  const int D = nvec * N;
  for (int c = threadIdx.x; c < D; c += BWD_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < BWD_THREADS / 32; ++k) s += sdw[k][c];
    dw_part[(long long)blockIdx.x * D + c] = s;
  }
}

// Row-group form: W warps a row, each thread vectors i * 32 W + its index
// in the group (i < BWD_NV), R = 8 / W groups a block (1 for W = 16);
// group g walks rows r0 + g, r0 + g + R, ... of the block's run.
template <typename T, int W, bool SPLIT>
__global__ void __launch_bounds__(W == 16 ? 512 : BWD_THREADS,
                                  W == 16 ? 1 : 2)
rmsnorm_bwd_rows_kernel(const uint4* __restrict__ x,
                        const uint4* __restrict__ w,
                        const uint4* __restrict__ dy, uint4* __restrict__ dx,
                        float* __restrict__ dw_part,
                        const float* __restrict__ ss_in,
                        const float* __restrict__ dot_in, long long rows,
                        long long rows_per_block, int nvec, float d,
                        float eps) {
  constexpr int N = Vec<T>::N, R = W == 16 ? 1 : 8 / W, GT = 32 * W;
  extern __shared__ float sdw[];                 // R > 1: [group][D]
  __shared__ float2 red[2][R][W];                // W > 1: the warps' sums
  const int g = threadIdx.x / GT, t = threadIdx.x % GT;
  const int wig = t >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, rows);
  uint4 wv[BWD_NV];
  float dwp[BWD_NV][N];
#pragma unroll
  for (int i = 0; i < BWD_NV; ++i) {
    const int c = i * GT + t;
    wv[i] = c < nvec ? __ldg(w + c) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int e = 0; e < N; ++e) dwp[i][e] = 0.f;
  }
  int buf = 0;
  for (long long row = r0 + g; row < r1; row += R) {
    uint4 xv[BWD_NV], gv[BWD_NV];
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < BWD_NV; ++i) {
      const int c = i * GT + t;
      if (c < nvec) {
        xv[i] = x[row * nvec + c];
        gv[i] = dy[row * nvec + c];
      }
    }
    if (SPLIT) {
      ss = ss_in[row];
      dot = dot_in[row];
    } else {
#pragma unroll
      for (int i = 0; i < BWD_NV; ++i)
        if (i * GT + t < nvec) bwd_sums<T>(xv[i], gv[i], wv[i], ss, dot);
      ss = warp_sum(ss);
      dot = warp_sum(dot);
    }
    if (!SPLIT && W > 1) {
      if (lane == 0) red[buf][g][wig] = make_float2(ss, dot);
      // the group's warps; the other buffer takes the next row's sums, so
      // one barrier a row keeps a fast warp from overwriting these
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(GT) : "memory");
      ss = dot = 0.f;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float2 p = red[buf][g][k];
        ss += p.x;
        dot += p.y;
      }
      buf ^= 1;
    }
    const float r = rsqrtf(ss / d + eps);
    const float coef = r * r * r * (dot / d);
#pragma unroll
    for (int i = 0; i < BWD_NV; ++i) {
      const int c = i * GT + t;
      if (c < nvec)
        dx[row * nvec + c] = bwd_dx<T>(xv[i], gv[i], wv[i], r, coef, dwp[i]);
    }
  }
  const int D = nvec * N;
  float* out = dw_part + (long long)blockIdx.x * D;
  if (R == 1) {
#pragma unroll
    for (int i = 0; i < BWD_NV; ++i) {
      const int c = i * GT + t;
      if (c < nvec)
#pragma unroll
        for (int e = 0; e < N; ++e) out[c * N + e] = dwp[i][e];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < BWD_NV; ++i) {
    const int c = i * GT + t;
    if (c < nvec)
#pragma unroll
      for (int e = 0; e < N; ++e) sdw[g * D + c * N + e] = dwp[i][e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += R * GT) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) s += sdw[k * D + c];
    out[c] = s;
  }
}

// Scalar form: one row at a time a block, an element a thread a step; the
// block's dw columns in shared memory (a column belongs to one thread).
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(BWD_THREADS)
rmsnorm_bwd_scalar_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ dw_part,
                          const float* __restrict__ ss_in,
                          const float* __restrict__ dot_in, long long rows,
                          long long rows_per_block, int D, float d,
                          float eps) {
  extern __shared__ float sdw[];                 // D partial dw columns
  __shared__ float2 partial[BWD_THREADS / 32];
  __shared__ float2 total;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < D; c += nth) sdw[c] = 0.f;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, rows);
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * D;
    const T* gr = dy + row * D;
    float2 tot;
    if (SPLIT) {
      tot = make_float2(ss_in[row], dot_in[row]);
    } else {
      float ss = 0.f, dot = 0.f;
      for (int c = tid; c < D; c += nth) {
        const float xv = to_f32(xr[c]);
        ss += xv * xv;
        dot += xv * to_f32(w[c]) * to_f32(gr[c]);
      }
      ss = warp_sum(ss);
      dot = warp_sum(dot);
      if (lane == 0) partial[warp] = make_float2(ss, dot);
      __syncthreads();
      if (warp == 0) {
        const float2 p = lane < (nth >> 5) ? partial[lane]
                                           : make_float2(0.f, 0.f);
        const float a = warp_sum(p.x), b = warp_sum(p.y);
        if (lane == 0) total = make_float2(a, b);
      }
      __syncthreads();
      tot = total;
    }
    const float r = rsqrtf(tot.x / d + eps);
    const float coef = r * r * r * (tot.y / d);
    T* dxr = dx + row * D;
    for (int c = tid; c < D; c += nth) {
      const float xv = to_f32(xr[c]), gv = to_f32(gr[c]);
      dxr[c] = from_f32<T>(r * (to_f32(w[c]) * gv) - xv * coef);
      sdw[c] += gv * xv * r;
    }
    // `partial` and `total` are rewritten by the next row
    if (!SPLIT) __syncthreads();
  }
  for (int c = tid; c < D; c += nth)
    dw_part[(long long)blockIdx.x * D + c] = sdw[c];
}

// dw[c] = the sum of the blocks' partial rows: 8 columns a block, 32
// threads a column (thread k adds rows k, k + 32, ... in order), then the
// 32 sums in order
template <typename T>
__global__ void __launch_bounds__(256)
rmsnorm_dw_kernel(const float* __restrict__ dw_part, T* __restrict__ dw,
                  int blocks, int D) {
  __shared__ float sums[32][8];
  const int cl = threadIdx.x & 7, k = threadIdx.x >> 3;
  const int c = blockIdx.x * 8 + cl;
  float s = 0.f;
  if (c < D)
    for (int b = k; b < blocks; b += 32) s += dw_part[(long long)b * D + c];
  sums[k][cl] = s;
  __syncthreads();
  if (threadIdx.x < 8 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) t += sums[j][cl];
    dw[c] = from_f32<T>(t);
  }
}

// blocks of a backward call and the rows each walks: a shape rule on the
// row count alone
void bwd_grid(long long rows, long long& per, int& used) {
  const long long blocks = rows < BWD_BLOCKS ? rows : BWD_BLOCKS;
  per = (rows + blocks - 1) / blocks;
  used = (int)((rows + per - 1) / per);
}

template <typename T, int G, bool SPLIT>
void launch_bwd_group(const void* x, const void* w, const void* dy, void* dx,
                      float* part, const float* ss, const float* dot,
                      long long rows, long long per, int used, int nvec,
                      float d, float eps, cudaStream_t stream) {
  rmsnorm_bwd_group_kernel<T, G, SPLIT><<<used, BWD_THREADS, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(w),
      static_cast<const uint4*>(dy), static_cast<uint4*>(dx), part, ss, dot,
      rows, per, nvec, d, eps);
}

template <typename T, int W, bool SPLIT>
void launch_bwd_rows(const void* x, const void* w, const void* dy, void* dx,
                     float* part, const float* ss, const float* dot,
                     long long rows, long long per, int used, int nvec,
                     float d, float eps, cudaStream_t stream) {
  constexpr int R = W == 16 ? 1 : 8 / W;
  const int D = nvec * Vec<T>::N;
  const size_t smem = R > 1 ? sizeof(float) * (size_t)R * D : 0;
  rmsnorm_bwd_rows_kernel<T, W, SPLIT><<<used, 32 * W * R, smem, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(w),
      static_cast<const uint4*>(dy), static_cast<uint4*>(dx), part, ss, dot,
      rows, per, nvec, d, eps);
}

// SPLIT: the rows' two sums come in ss and dot and n is the global width;
// otherwise both are null and n is D
template <typename T, bool SPLIT>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx,
               void* dw, float* part, const float* ss, const float* dot,
               long long rows, int D, float n, float eps,
               cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  long long per;
  int used;
  bwd_grid(rows, per, used);
  const unsigned long long addr = reinterpret_cast<unsigned long long>(x)
                                  | reinterpret_cast<unsigned long long>(w)
                                  | reinterpret_cast<unsigned long long>(dy)
                                  | reinterpret_cast<unsigned long long>(dx);
  const int nvec = D / N;
  const bool vec = addr % 16 == 0 && D % N == 0;
  const float d = n;
#define RN_BWD_ARGS \
  x, w, dy, dx, part, ss, dot, rows, per, used, nvec, d, eps, stream
  if (vec && nvec <= 1) launch_bwd_group<T, 1, SPLIT>(RN_BWD_ARGS);
  else if (vec && nvec <= 2) launch_bwd_group<T, 2, SPLIT>(RN_BWD_ARGS);
  else if (vec && nvec <= 4) launch_bwd_group<T, 4, SPLIT>(RN_BWD_ARGS);
  else if (vec && nvec <= 8) launch_bwd_group<T, 8, SPLIT>(RN_BWD_ARGS);
  else if (vec && nvec <= 16) launch_bwd_group<T, 16, SPLIT>(RN_BWD_ARGS);
  else if (vec && nvec <= 32) launch_bwd_group<T, 32, SPLIT>(RN_BWD_ARGS);
  else if (vec && nvec <= 32 * BWD_NV)
    launch_bwd_rows<T, 1, SPLIT>(RN_BWD_ARGS);
  else if (vec && nvec <= 64 * BWD_NV)
    launch_bwd_rows<T, 2, SPLIT>(RN_BWD_ARGS);
  else if (vec && nvec <= 128 * BWD_NV)
    launch_bwd_rows<T, 4, SPLIT>(RN_BWD_ARGS);
  else if (vec && nvec <= 256 * BWD_NV)
    launch_bwd_rows<T, 8, SPLIT>(RN_BWD_ARGS);
  else if (vec && nvec <= 512 * BWD_NV)
    launch_bwd_rows<T, 16, SPLIT>(RN_BWD_ARGS);
  else {
    const size_t smem = sizeof(float) * (size_t)D;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          rmsnorm_bwd_scalar_kernel<T, SPLIT>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int threads = D < BWD_THREADS ? (D + 31) / 32 * 32 : BWD_THREADS;
    rmsnorm_bwd_scalar_kernel<T, SPLIT><<<used, threads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(dy), static_cast<T*>(dx), part, ss, dot, rows,
        per, D, d, eps);
  }
#undef RN_BWD_ARGS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rmsnorm_dw_kernel<T><<<(D + 7) / 8, 256, 0, stream>>>(
      part, static_cast<T*>(dw), used, D);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (rows, D) contiguous; w: (D,); all of one dtype (DT_F32 / DT_BF16).
// Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(int dtype, const void* x, const void* w,
                              void* y, long long rows, int D, float eps,
                              void* stream) {
  if (rows <= 0 || D <= 0 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float n = (float)D;
  if (dtype == DT_F32)
    return launch<float, false>(x, w, y, nullptr, rows, D, n, eps, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16, false>(x, w, y, nullptr, rows, D, n, eps, s);
  return (int)cudaErrorInvalidValue;
}

// The rows' float32 partials over this rank's D columns: sum(x^2) with dy
// null, else sum(x w dy). x, dy: (rows, D) contiguous; w: (D,); stat:
// (rows,) float32. One launch.
extern "C" int rmsnorm_stat_launch(int dtype, const void* x, const void* w,
                                   const void* dy, void* stat,
                                   long long rows, int D, void* stream) {
  if (rows <= 0 || D <= 0 || (dy != nullptr && w == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stat);
  if (dtype == DT_F32) return launch_stat<float>(x, w, dy, st, rows, D, s);
  if (dtype == DT_BF16)
    return launch_stat<__nv_bfloat16>(x, w, dy, st, rows, D, s);
  return (int)cudaErrorInvalidValue;
}

// The split-row forward: y = x rsqrt(ss / n + eps) w with ss (rows,) the
// all-reduced sums of squares and n the global width. One launch.
extern "C" int rmsnorm_split_launch(int dtype, const void* x, const void* w,
                                    void* y, const void* ss, long long rows,
                                    int D, float n, float eps, void* stream) {
  if (rows <= 0 || D <= 0 || rows > 0x7fffffffLL || ss == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(ss);
  if (dtype == DT_F32)
    return launch<float, true>(x, w, y, st, rows, D, n, eps, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16, true>(x, w, y, st, rows, D, n, eps, s);
  return (int)cudaErrorInvalidValue;
}

// Rows of the (blocks, D) float32 scratch that rmsnorm_bwd_launch needs.
extern "C" long long rmsnorm_bwd_blocks(long long rows) {
  if (rows <= 0) return 0;
  long long per;
  int used;
  bwd_grid(rows, per, used);
  return used;
}

// x, dy, dx: (rows, D) contiguous; w, dw: (D,); all of one dtype; part:
// rmsnorm_bwd_blocks(rows) x D floats of scratch. Two launches (dx and the
// partial dw, then dw). Returns cudaGetLastError() after the launches.
extern "C" int rmsnorm_bwd_launch(int dtype, const void* x, const void* w,
                                  const void* dy, void* dx, void* dw,
                                  void* part, long long rows, int D,
                                  float eps, void* stream) {
  if (rows <= 0 || D <= 0 || part == nullptr ||
      (size_t)D * sizeof(float) > 200 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const float n = (float)D;
  if (dtype == DT_F32)
    return launch_bwd<float, false>(x, w, dy, dx, dw, p, nullptr, nullptr,
                                    rows, D, n, eps, s);
  if (dtype == DT_BF16)
    return launch_bwd<__nv_bfloat16, false>(x, w, dy, dx, dw, p, nullptr,
                                            nullptr, rows, D, n, eps, s);
  return (int)cudaErrorInvalidValue;
}

// The split-row backward: dx = r (w dy) - x r^3 dot / n, r = rsqrt(ss / n
// + eps), with ss and dot (rows,) the all-reduced sums of x^2 and x w dy,
// and dw the sum over rows of dy x r over this rank's columns. Arguments
// as rmsnorm_bwd_launch's; two launches.
extern "C" int rmsnorm_split_bwd_launch(int dtype, const void* x,
                                        const void* w, const void* dy,
                                        void* dx, void* dw, void* part,
                                        const void* ss, const void* dot,
                                        long long rows, int D, float n,
                                        float eps, void* stream) {
  if (rows <= 0 || D <= 0 || part == nullptr || ss == nullptr ||
      dot == nullptr || (size_t)D * sizeof(float) > 200 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const float* a = static_cast<const float*>(ss);
  const float* b = static_cast<const float*>(dot);
  if (dtype == DT_F32)
    return launch_bwd<float, true>(x, w, dy, dx, dw, p, a, b, rows, D, n,
                                   eps, s);
  if (dtype == DT_BF16)
    return launch_bwd<__nv_bfloat16, true>(x, w, dy, dx, dw, p, a, b, rows,
                                           D, n, eps, s);
  return (int)cudaErrorInvalidValue;
}
