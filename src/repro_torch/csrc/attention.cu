// Flash attention (prefill) and flash decode, online softmax in float32.
//
// flash_attention_kernel replaces the Pallas TPU kernel `_attn_kernel` of
// the JAX package's src/repro/kernels/flash_attention.py
// (`flash_attention`); flash_decode_kernel replaces `_decode_kernel` of
// src/repro/kernels/flash_decode.py (`flash_decode`). Both keep the Pallas
// kernels' arithmetic: s = (q . k) * sm_scale (the scale after the dot),
// masked logits at NEG_INF = -1e30, a running max m, sum l and accumulator
// in float32, the dead-row guard (a row with no live key gives 0, never
// NaN), and o = acc / max(l, 1e-30). GQA: query head h reads kv head
// h / group.
//
// What bounds them on the H100.
// * flash_attention: operations at long S (4 B Hq Sq Sk D flops, halved
//   when causal, against the inputs' 2 B (Hq + 2 Hkv) S D bytes: ~S/2
//   flops per byte, above the card's ~295 bf16 flops per byte once S is in
//   the thousands); bytes and launch latency at the serving path's S = 16.
//   The design: one 128-thread block per (query tile of 64, q head, batch);
//   the block walks the key tiles of 64 itself, skipping the tiles that the
//   causal and window bounds exclude, and masks the ragged last tiles
//   itself, so any Sq and Sk work. Q, K and V tiles sit in shared memory in
//   their storage type (rows padded to an odd word stride, so the threads of
//   a warp hit distinct banks); each thread holds a 4 x 8 block of scores
//   and a 4 x D/8 block of the accumulator in registers. The products run
//   on CUDA cores in float32: this is the simple, right first kernel, and
//   it sits far from the tensor-core bound (wgmma/TMA tiles are later work).
// * flash_decode: bytes (the whole K/V cache is read once per step for
//   G = 4 query rows: ~1 flop per byte). The design: one block per (kv
//   head, batch); the G query rows of a group share every K/V tile of 64
//   slots that the block stages in shared memory. With B * Hkv blocks, a
//   small batch leaves SMs idle (B = 32, Hkv = 8 gives 256 blocks for 132
//   SMs); splitting S across blocks is later work.
//
// No atomics: every reduction is a fixed-order shuffle butterfly or a
// fixed-order loop, so two runs on one input give the same bits.
#include "dtype.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// flash_attention tiling
constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int FA_THREADS = 128;  // 16 row groups of 4 rows x 8 column groups
constexpr int MAX_D = 128;
constexpr int COLS = MAX_D / 8;  // accumulator columns per thread, at most

// flash_decode tiling
constexpr int DS = 64;           // cache slots per tile (two warps' lanes)
constexpr int FD_THREADS = 128;
constexpr int FD_OUT = 8;        // outputs per thread: G * D <= 1024

struct Strides {
  long long b, h, s;  // element strides of the batch, head and sequence axes
};

// Row stride, in elements, of a shared tile of D columns: an odd number of
// 32-bit words for D % 4 == 0.
template <typename T> __host__ __device__ constexpr int pad_ld(int D) {
  return sizeof(T) == 4 ? D + 1 : D + 2;
}

template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long long s_stride, int row0,
                                          int rows, int S, int D, int ld,
                                          int tid, int nthreads) {
  for (int idx = tid; idx < rows * D; idx += nthreads) {
    const int r = idx / D, c = idx - r * D;
    const int pos = row0 + r;
    dst[r * ld + c] = pos < S ? src[pos * s_stride + c] : from_f32<T>(0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int group, int Sq, int Sk, int D, Strides qs,
                       Strides ks, Strides vs, int causal, int window,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = pad_ld<T>(D);
  float* Ps = reinterpret_cast<float*>(smem);       // BQ x (BK + 1)
  T* Qs = reinterpret_cast<T*>(Ps + BQ * (BK + 1));  // BQ x ld
  T* Ks = Qs + BQ * ld;                               // BK x ld
  T* Vs = Ks + BK * ld;                               // BK x ld

  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;  // row group, column group
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  load_tile(Qs, qb, qs.s, q0, BQ, Sq, D, ld, tid, FA_THREADS);

  float m[4], l[4], acc[4][COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
  }

  // key range that can hold a live key for some row of this tile
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_last + 1);
  if (window >= 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BK) * BK;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, kb, ks.s, kt, BK, Sk, D, ld, tid, FA_THREADS);
    load_tile(Vs, vb, vs.s, kt, BK, Sk, D, ld, tid, FA_THREADS);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = to_f32(Qs[(rg * 4 + i) * ld + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = to_f32(Ks[(cg + 8 * j) * ld + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i;
      bool ok[8];
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = kt + cg + 8 * j;
        bool live = kpos < Sk;
        if (causal) live = live && qpos >= kpos;
        if (window >= 0) live = live && (qpos - kpos) < window;
        ok[j] = live;
        s[i][j] = live ? s[i][j] * scale : NEG_INF;
        mc = fmaxf(mc, s[i][j]);
      }
      // the 8 column groups of a row are lanes cg = 0..7 of one warp
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[i], mc);
      const bool dead = m_new <= NEG_INF * 0.5f;
      const float sub = dead ? 0.f : m_new;
      const float alpha = m[i] <= NEG_INF * 0.5f ? 0.f : expf(m[i] - sub);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ok[j] ? expf(s[i][j] - sub) : 0.f;
        Ps[(rg * 4 + i) * (BK + 1) + cg + 8 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(rg * 4 + i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int col = cg + 8 * c;
        if (col < D) {
          const float vv = to_f32(Vs[j * ld + col]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
        }
      }
    }
  }

  T* ob = o + ((long long)b * Hq + h) * (long long)Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = cg + 8 * c;
      if (col < D) ob[(long long)row * D + col] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(FD_THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const unsigned char* __restrict__ valid,
                    T* __restrict__ o, int Hkv, int G, int S, int D,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = pad_ld<T>(D);
  float* Qs = reinterpret_cast<float*>(smem);  // G x D
  float* Ps = Qs + G * D;                       // G x DS
  float* Ms = Ps + G * DS;                      // running max, per row
  float* Ls = Ms + G;                           // running sum
  float* As = Ls + G;                           // this tile's rescale
  int* okS = reinterpret_cast<int*>(As + G);    // DS
  T* Ks = reinterpret_cast<T*>(okS + DS);       // DS x ld
  T* Vs = Ks + DS * ld;                         // DS x ld

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long bh = (long long)b * Hkv + h;
  const T* qb = q + bh * G * D;
  const T* kb = k + bh * (long long)S * D;
  const T* vb = v + bh * (long long)S * D;

  for (int idx = tid; idx < G * D; idx += FD_THREADS) Qs[idx] = to_f32(qb[idx]);
  for (int g = tid; g < G; g += FD_THREADS) {
    Ms[g] = NEG_INF;
    Ls[g] = 0.f;
  }
  float acc[FD_OUT];
#pragma unroll
  for (int a = 0; a < FD_OUT; ++a) acc[a] = 0.f;

  for (int st = 0; st < S; st += DS) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, kb, (long long)D, st, DS, S, D, ld, tid, FD_THREADS);
    load_tile(Vs, vb, (long long)D, st, DS, S, D, ld, tid, FD_THREADS);
    for (int j = tid; j < DS; j += FD_THREADS)
      okS[j] = (st + j < S) && valid[st + j];
    __syncthreads();

    // scores: thread t takes slot t % DS for rows t / DS, + 2, + 4, ...
    {
      const int j = tid % DS;
      for (int g = tid / DS; g < G; g += FD_THREADS / DS) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += Qs[g * D + d] * to_f32(Ks[j * ld + d]);
        Ps[g * DS + j] = okS[j] ? dot * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows w, w + 4, ...; lane holds slots
    // lane and lane + 32
    for (int g = warp; g < G; g += FD_THREADS / 32) {
      const float s0 = Ps[g * DS + lane], s1 = Ps[g * DS + lane + 32];
      const float mc = warp_max(fmaxf(s0, s1));
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, mc);
      const bool dead = m_new <= NEG_INF * 0.5f;
      const float sub = dead ? 0.f : m_new;
      const float p0 = okS[lane] ? expf(s0 - sub) : 0.f;
      const float p1 = okS[lane + 32] ? expf(s1 - sub) : 0.f;
      const float alpha = m_prev <= NEG_INF * 0.5f ? 0.f : expf(m_prev - sub);
      const float rs = warp_sum(p0 + p1);
      Ps[g * DS + lane] = p0;
      Ps[g * DS + lane + 32] = p1;
      if (lane == 0) {
        Ls[g] = Ls[g] * alpha + rs;
        Ms[g] = m_new;
        As[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < FD_OUT; ++a) {
      const int idx = tid + FD_THREADS * a;
      if (idx < G * D) {
        const int g = idx / D, d = idx - g * D;
        float r = acc[a] * As[g];
        for (int j = 0; j < DS; ++j) r += Ps[g * DS + j] * to_f32(Vs[j * ld + d]);
        acc[a] = r;
      }
    }
  }
  __syncthreads();

  T* ob = o + bh * G * D;
#pragma unroll
  for (int a = 0; a < FD_OUT; ++a) {
    const int idx = tid + FD_THREADS * a;
    if (idx < G * D) {
      const int g = idx / D;
      ob[idx] = from_f32<T>(acc[a] / fmaxf(Ls[g], 1e-30f));
    }
  }
}

template <typename T>
int attention(const void* q, const void* k, const void* v, void* o, int B,
              int Hq, int Hkv, int Sq, int Sk, int D, Strides qs, Strides ks,
              Strides vs, int causal, int window, float scale,
              cudaStream_t stream) {
  const int ld = pad_ld<T>(D);
  const size_t smem = sizeof(float) * BQ * (BK + 1) +
                      sizeof(T) * (size_t)(BQ + 2 * BK) * ld;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<T><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hq / Hkv, Sq, Sk, D,
      qs, ks, vs, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int decode(const void* q, const void* k, const void* v, const void* valid,
           void* o, int B, int Hkv, int G, int S, int D, float scale,
           cudaStream_t stream) {
  const int ld = pad_ld<T>(D);
  const size_t smem = sizeof(float) * ((size_t)G * D + (size_t)G * DS +
                                       3 * (size_t)G) +
                      sizeof(int) * DS + sizeof(T) * 2 * (size_t)DS * ld;
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hkv, B);
  flash_decode_kernel<T><<<grid, FD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(valid),
      static_cast<T*>(o), Hkv, G, S, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Hq, Sq, D), k, v: (B, Hkv, Sk, D), each with unit stride on D and
// the given element strides on its other axes; o: (B, Hq, Sq, D)
// contiguous. window < 0 means no window. Returns cudaGetLastError().
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* o, int B,
    int Hq, int Hkv, int Sq, int Sk, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Sk <= 0 ||
      D <= 0 || D > MAX_D || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return attention<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, qs, ks, vs,
                            causal, window, scale, s);
  if (dtype == DT_BF16)
    return attention<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, qs,
                                    ks, vs, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// q: (B, Hkv, G, D), k, v: (B, Hkv, S, D), o: (B, Hkv, G, D), all
// contiguous; valid: (S,) bytes (torch.bool). Returns cudaGetLastError().
extern "C" int flash_decode_launch(int dtype, const void* q, const void* k,
                                   const void* v, const void* valid, void* o,
                                   int B, int Hkv, int G, int S, int D,
                                   float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || S <= 0 || D <= 0 ||
      G * D > FD_THREADS * FD_OUT || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return decode<float>(q, k, v, valid, o, B, Hkv, G, S, D, scale, s);
  if (dtype == DT_BF16)
    return decode<__nv_bfloat16>(q, k, v, valid, o, B, Hkv, G, S, D, scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}
