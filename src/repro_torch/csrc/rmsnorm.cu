// RMSNorm over the last axis: y = (x * rsqrt(mean(x^2) + eps)) * w.
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` of the JAX package's
// src/repro/kernels/rmsnorm.py (`rmsnorm`). As there, the math is float32
// whatever the storage type, and y has x's dtype.
//
// What bounds it on the H100: bytes. Each element is read, squared and
// summed, then read again, scaled and written: ~4 operations per element
// against 4 bytes moved in bf16 (8 in float32), far below the card's ~20
// FP32 operations per byte of device memory. So the kernel's job is to
// touch x once from device memory and w from cache. The design: one warp
// per row for D <= 256 (the per-head q/k norms, D = 128), one 256-thread
// block per row above that (the residual-stream norms, D = 4096); the
// second read of the row hits L1/L2. The sum of squares is a per-thread
// sum followed by a fixed-order butterfly (and, for a block, a fixed-order
// sum of the warps' partials), so two runs give the same bits. Loads are
// one element per thread per step, coalesced across the warp; vector loads
// are later work.
#include "dtype.cuh"

namespace {

constexpr int WARP_ROWS_PER_BLOCK = 4;  // rows of the one-warp-per-row form
constexpr int BLOCK_THREADS = 256;      // threads of the one-block-per-row form

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

template <typename T>
int launch(const void* x, const void* w, void* y, long long rows, int D,
           float eps, cudaStream_t stream) {
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
