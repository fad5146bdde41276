// Element types of the model kernels (rmsnorm.cu, attention.cu).
//
// Every kernel is a template on its storage type, float or __nv_bfloat16.
// Values are widened to float on load and every sum, max and exponential
// is taken in float; results are rounded to the storage type on store
// (round to nearest even, as torch's .to(torch.bfloat16)).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes of the C launchers' first argument
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Fixed-order butterfly reductions over a warp: every lane ends with the
// bitwise-same value, and two runs on one input give the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
