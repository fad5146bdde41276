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
template <typename T, int G>
__global__ void __launch_bounds__(GROUP_BLOCK)
rmsnorm_group_kernel(const uint4* __restrict__ x, const uint4* __restrict__ w,
                     uint4* __restrict__ y, long long rows, int nvec,
                     float d, float eps) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x % G;
  const long long row = (long long)blockIdx.x * (GROUP_BLOCK / G)
                        + threadIdx.x / G;
  const bool live = row < rows && lane < nvec;
  float v[N];
  float ss = 0.f;
  if (live) {
    Vec<T>::load(x[row * nvec + lane], v);
#pragma unroll
    for (int e = 0; e < N; ++e) ss += v[e] * v[e];
  }
  // butterfly within the group of G lanes (all lanes of the warp take part)
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (!live) return;
  const float r = rsqrtf(ss / d + eps);
  y[row * nvec + lane] = scale<T>(v, r, __ldg(w + lane));
}

// Vector block form: one row per block, each thread NV whole vectors
// (vector i * blockDim + tid), masked past nvec.
template <typename T, int NV>
__global__ void __launch_bounds__(MAX_ROW_THREADS)
rmsnorm_row_kernel(const uint4* __restrict__ x, const uint4* __restrict__ w,
                   uint4* __restrict__ y, int nvec, float d, float eps) {
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
#pragma unroll
      for (int e = 0; e < N; ++e) ss += v[i][e] * v[i][e];
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (nth >> 5) ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  const float r = rsqrtf(total / d + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * nth + tid;
    if (c < nvec) y[base + c] = scale<T>(v[i], r, __ldg(w + c));
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * WARP_ROWS_PER_BLOCK)
rmsnorm_warp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, long long rows, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * WARP_ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * D;
  float ss = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)D + eps);
  T* yr = y + row * D;
  for (int i = lane; i < D; i += 32)
    yr[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(w[i]));
}

template <typename T>
__global__ void __launch_bounds__(BLOCK_THREADS)
rmsnorm_block_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, int D, float eps) {
  __shared__ float partial[BLOCK_THREADS / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
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
  __syncthreads();
  const float r = rsqrtf(total / (float)D + eps);
  T* yr = y + row * D;
  for (int i = threadIdx.x; i < D; i += BLOCK_THREADS)
    yr[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(w[i]));
}

template <typename T, int G>
void launch_group(const uint4* x, const uint4* w, uint4* y, long long rows,
                  int nvec, float d, float eps, cudaStream_t stream) {
  const long long blocks = (rows + GROUP_BLOCK / G - 1) / (GROUP_BLOCK / G);
  rmsnorm_group_kernel<T, G><<<(unsigned)blocks, GROUP_BLOCK, 0, stream>>>(
      x, w, y, rows, nvec, d, eps);
}

template <typename T, int NV>
void launch_row(const uint4* x, const uint4* w, uint4* y, long long rows,
                int nvec, float d, float eps, cudaStream_t stream) {
  const int threads = ((nvec + NV - 1) / NV + 31) / 32 * 32;
  rmsnorm_row_kernel<T, NV><<<(unsigned)rows, threads, 0, stream>>>(
      x, w, y, nvec, d, eps);
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

template <typename T>
int launch(const void* x, const void* w, void* y, long long rows, int D,
           float eps, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const unsigned long long addr = reinterpret_cast<unsigned long long>(x)
                                  | reinterpret_cast<unsigned long long>(w)
                                  | reinterpret_cast<unsigned long long>(y);
  const int nvec = D / N;
  const int nv = (addr % 16 == 0 && D % N == 0) ? pick_nv(nvec) : 0;
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* wv = static_cast<const uint4*>(w);
  uint4* yv = static_cast<uint4*>(y);
  const float d = (float)D;
  if (nv != 0 && nvec <= 32) {
    if (nvec <= 1) launch_group<T, 1>(xv, wv, yv, rows, nvec, d, eps, stream);
    else if (nvec <= 2) launch_group<T, 2>(xv, wv, yv, rows, nvec, d, eps, stream);
    else if (nvec <= 4) launch_group<T, 4>(xv, wv, yv, rows, nvec, d, eps, stream);
    else if (nvec <= 8) launch_group<T, 8>(xv, wv, yv, rows, nvec, d, eps, stream);
    else if (nvec <= 16) launch_group<T, 16>(xv, wv, yv, rows, nvec, d, eps, stream);
    else launch_group<T, 32>(xv, wv, yv, rows, nvec, d, eps, stream);
  } else if (nv == 1) {
    launch_row<T, 1>(xv, wv, yv, rows, nvec, d, eps, stream);
  } else if (nv == 2) {
    launch_row<T, 2>(xv, wv, yv, rows, nvec, d, eps, stream);
  } else if (nv == 4) {
    launch_row<T, 4>(xv, wv, yv, rows, nvec, d, eps, stream);
  } else if (nv == 8) {
    launch_row<T, 8>(xv, wv, yv, rows, nvec, d, eps, stream);
  } else {
    const T* xp = static_cast<const T*>(x);
    const T* wp = static_cast<const T*>(w);
    T* yp = static_cast<T*>(y);
    if (D <= 256) {
      const long long blocks =
          (rows + WARP_ROWS_PER_BLOCK - 1) / WARP_ROWS_PER_BLOCK;
      rmsnorm_warp_kernel<T><<<(unsigned)blocks, 32 * WARP_ROWS_PER_BLOCK, 0,
                               stream>>>(xp, wp, yp, rows, D, eps);
    } else {
      rmsnorm_block_kernel<T><<<(unsigned)rows, BLOCK_THREADS, 0, stream>>>(
          xp, wp, yp, D, eps);
    }
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// rmsnorm_bwd: the gradient of y = (x * r) * w, r = rsqrt(mean(x^2) + eps),
// that autograd takes through the JAX package's XLA rms_norm (which
// jax.grad differentiates there; its Pallas kernel has no backward):
//   dx = r (w dy) - x r^3 mean(x w dy),   dw = sum over rows of dy x r,
// float32 sums, dx in x's dtype and dw in w's. Bound by bytes like the
// forward (x and dy read, dx written, ~10 operations an element), so one
// pass reads each row once per use from device memory (the second read of
// a row hits L1), with the row's two sums (x^2 and x w dy) reduced together
// in one fixed-order block sum. dw is two launches with no atomics: each
// block of rmsnorm_bwd_kernel walks a fixed run of rows and keeps its
// columns' partial dw in shared memory (a column belongs to one thread),
// then writes them as one row of a (blocks, D) float32 scratch; and
// rmsnorm_dw_kernel sums that scratch's rows in block order, one thread a
// column. The blocks and their runs of rows follow from (rows, D) alone.

constexpr int BWD_BLOCKS = 528;   // 4 blocks for each of the H100's 132 SMs
constexpr int BWD_MAX_THREADS = 256;

// threads of a backward block: D rounded up to whole warps, at most 256
int bwd_threads(int D) {
  const int t = (D + 31) / 32 * 32;
  return t < BWD_MAX_THREADS ? t : BWD_MAX_THREADS;
}

template <typename T>
__global__ void __launch_bounds__(BWD_MAX_THREADS)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ dw_part, long long rows,
                   long long rows_per_block, int D, float eps) {
  extern __shared__ float sdw[];                 // D partial dw columns
  __shared__ float2 partial[BWD_MAX_THREADS / 32];
  __shared__ float2 total;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < D; c += nth) sdw[c] = 0.f;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block
                                                   : rows;
  const float d = (float)D;
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * D;
    const T* gr = dy + row * D;
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
    const float r = rsqrtf(total.x / d + eps);
    const float coef = r * r * r * (total.y / d);
    T* dxr = dx + row * D;
    for (int c = tid; c < D; c += nth) {
      const float xv = to_f32(xr[c]), gv = to_f32(gr[c]);
      dxr[c] = from_f32<T>(r * (to_f32(w[c]) * gv) - xv * coef);
      sdw[c] += gv * xv * r;
    }
    // `partial` and `total` are rewritten by the next row
    __syncthreads();
  }
  for (int c = tid; c < D; c += nth)
    dw_part[(long long)blockIdx.x * D + c] = sdw[c];
}

// dw[c] = sum over the blocks' partials in block order
template <typename T>
__global__ void rmsnorm_dw_kernel(const float* __restrict__ dw_part,
                                  T* __restrict__ dw, int blocks, int D) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += dw_part[(long long)b * D + c];
  dw[c] = from_f32<T>(s);
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx,
               void* dw, float* part, long long rows, int D, float eps,
               cudaStream_t stream) {
  const long long blocks = rows < BWD_BLOCKS ? rows : BWD_BLOCKS;
  const long long per = (rows + blocks - 1) / blocks;
  const int used = (int)((rows + per - 1) / per);
  const int threads = bwd_threads(D);
  const size_t smem = sizeof(float) * (size_t)D;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rmsnorm_bwd_kernel<T><<<used, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, per, D,
      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rmsnorm_dw_kernel<T><<<(D + 255) / 256, 256, 0, stream>>>(
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
  if (dtype == DT_F32) return launch<float>(x, w, y, rows, D, eps, s);
  if (dtype == DT_BF16) return launch<__nv_bfloat16>(x, w, y, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}

// Rows of the (blocks, D) float32 scratch that rmsnorm_bwd_launch needs.
extern "C" long long rmsnorm_bwd_blocks(long long rows) {
  if (rows <= 0) return 0;
  const long long blocks = rows < BWD_BLOCKS ? rows : BWD_BLOCKS;
  const long long per = (rows + blocks - 1) / blocks;
  return (rows + per - 1) / per;
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
  if (dtype == DT_F32)
    return launch_bwd<float>(x, w, dy, dx, dw, p, rows, D, eps, s);
  if (dtype == DT_BF16)
    return launch_bwd<__nv_bfloat16>(x, w, dy, dx, dw, p, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
