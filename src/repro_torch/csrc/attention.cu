// Flash attention (prefill) and flash decode, online softmax in float32.
//
// The prefill kernels replace the Pallas TPU kernel `_attn_kernel` of the
// JAX package's src/repro/kernels/flash_attention.py (`flash_attention`);
// the decode kernels replace `_decode_kernel` of
// src/repro/kernels/flash_decode.py (`flash_decode`). All keep the Pallas
// kernels' rules: s = (q . k) * sm_scale (the scale after the dot), masked
// logits at NEG_INF = -1e30, a running max m, sum l and accumulator in
// float32, the dead-row guard (a row with no live key gives 0, never NaN),
// and o = acc / max(l, 1e-30). GQA: query head h reads kv head h / group.
// No atomics anywhere: every reduction is a fixed-order shuffle butterfly
// or a fixed-order loop, so two runs on one input give the same bits.
//
// flash_attention, bf16 (fa_wgmma_kernel). Bound by operations at long S
// (4 B Hq Sq Sk D flops, halved when causal, against 2 B (Hq + 2 Hkv) S D
// bytes: ~S/2 flops per byte, far above the card's ~295 bf16 flops per
// byte), so both products run on the tensor cores with wgmma, in the shape
// of FlashAttention-3's forward pass:
//   * one block per (query tile of 128 rows, q head, batch): two consumer
//     warpgroups of 64 rows each and a producer warpgroup, which hands its
//     registers to the consumers (setmaxnreg: 24 and 240 a thread);
//   * one producer thread keeps the K and V tiles of BK keys in flight with
//     TMA loads (4-D tensor maps over the (B, H, S, D) views, so the
//     model's strided projections are read without a copy) into a
//     two-stage ring of 128-byte-swizzled panels, signalled by mbarriers;
//     the consumers release a stage after their P . V (measured on the
//     H100: overlapping a tile's softmax with the previous tile's P . V
//     was slower; a third stage, releasing K early, or ping-pong turns of
//     the two warpgroups on the tensor cores gained nothing);
//   * S = Q . K^T is wgmma with both operands in shared memory, O += P . V
//     wgmma with P in registers (rounded to bf16) and V read in its natural
//     row-major layout as an MN-major operand; O accumulates in float32;
//   * the online softmax runs on the accumulator fragment, with row
//     reductions as quad shuffles; only the tiles that straddle the causal
//     or window bound or the ragged end of Sk are masked; tiles that the
//     bounds exclude are skipped, and the heaviest causal query tiles
//     launch first;
//   * short prompts (Sq <= 64) pack the query heads that share one kv head
//     into a tile's rows (row r is head h0 + r / Sq at position r % Sq), so
//     the serving path's 16-token prompts fill a 64-row wgmma tile.
// Head dims up to 256 in steps of 8: the tile is DP = 64, 128, 192 or 256
// columns, and TMA fills the columns past D with zeros (D = 80 runs as 128),
// which add nothing to q . k and give columns of O that are not stored.
// V and O have a width of their own, DV (the value head dim Dv in its
// tile): DV = DP, or DP = 192 with DV = 128, the MLA prefill of
// DeepSeek-V2-Lite (q, k of 192, v of 128); the K and V stages of the
// ring are sized apart.
// Unlike the Pallas kernel (P in float32), P is rounded to bf16 before
// P . V, as the JAX model's own XLA path does, and l sums the rounded P.
//
// flash_attention, float32 (fa_f32_kernel): the CUDA-core kernel of the
// first port (TF32 would not meet the float32 tolerance): one 128-thread
// block per (query tile of 64, q head, batch), Q, K and V tiles in shared
// memory, a 4 x 8 block of scores and a 4 x Dv/8 block of the accumulator
// per thread (Dv, the value head dim, at run time).
//
// flash_decode (fd_split_kernel, fd_combine_kernel), float32 and bf16.
// Bound by bytes: the whole K/V cache is read once per step for G <= 16
// query rows (~1 flop per byte), so the design is about bytes in flight:
//   * the cache is split along S across blocks, grid (splits, Hkv, B); the
//     wrapper picks the splits so that B Hkv splits is about four times the
//     SM count with at least 256 slots each, and one split for short
//     caches, which then write the output directly;
//   * each block streams its K and V rows through a four-stage ring of
//     16-byte cp.async copies (16 KB a stage), with zero fill past the
//     split's end;
//   * lanes span D in 16-byte vectors; a group of lps lanes takes one slot
//     at a time and every one of the G query rows (held in registers) shares
//     each K row it reads; the dot products reduce over the group's lanes
//     with a fixed shuffle butterfly; each group keeps its own online
//     softmax state (m, l and its slice of the G x D accumulator), with the
//     logits and m in log2 units (sm_scale * log2 e after the dot, exp2);
//   * the groups of a block combine in a fixed order (shuffles, then the
//     four warps through shared memory); with several splits each block
//     writes its float32 partial (m, l, acc) and fd_combine_kernel merges
//     the splits in split order. A split with no valid slot has m = -1e30
//     and l = 0 and weighs 0; a row with no valid slot anywhere gives 0.
#include <cuda.h>

#include "dtype.cuh"
#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, h, s;  // element strides of the batch, head and sequence axes
};

// 2^x on the special function unit (relative error ~2^-22; subnormal
// results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------ flash_attention, float32
constexpr int BQ = 64;           // query rows per block
constexpr int BK32 = 64;         // keys per tile
constexpr int FA_THREADS = 128;  // 16 row groups of 4 rows x 8 column groups

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

// COLS: accumulator columns per thread (Dv <= 8 COLS)
template <typename T, int COLS>
__global__ void __launch_bounds__(FA_THREADS)
fa_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int Hq, int group,
              int Sq, int Sk, int D, int Dv, Strides qs, Strides ks,
              Strides vs, int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = pad_ld<T>(D), ldv = pad_ld<T>(Dv);
  float* Ps = reinterpret_cast<float*>(smem);        // BQ x (BK32 + 1)
  T* Qs = reinterpret_cast<T*>(Ps + BQ * (BK32 + 1));  // BQ x ld
  T* Ks = Qs + BQ * ld;                                 // BK32 x ld
  T* Vs = Ks + BK32 * ld;                               // BK32 x ldv

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
  k_begin = (k_begin / BK32) * BK32;

  for (int kt = k_begin; kt < k_end; kt += BK32) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, kb, ks.s, kt, BK32, Sk, D, ld, tid, FA_THREADS);
    load_tile(Vs, vb, vs.s, kt, BK32, Sk, Dv, ldv, tid, FA_THREADS);
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
        Ps[(rg * 4 + i) * (BK32 + 1) + cg + 8 * j] = p;
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

    for (int j = 0; j < BK32; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(rg * 4 + i) * (BK32 + 1) + j];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int col = cg + 8 * c;
        if (col < Dv) {
          const float vv = to_f32(Vs[j * ldv + col]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
        }
      }
    }
  }

  T* ob = o + ((long long)b * Hq + h) * (long long)Sq * Dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && cg == 0)
      lse[((long long)b * Hq + h) * Sq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : __int_as_float(0x7f800000);
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = cg + 8 * c;
      if (col < Dv)
        ob[(long long)row * Dv + col] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <int COLS>
int attention_f32(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                  int Dv,
                  Strides qs, Strides ks, Strides vs, int causal, int window,
                  float scale, cudaStream_t stream) {
  const int ld = pad_ld<float>(D), ldv = pad_ld<float>(Dv);
  const size_t smem = sizeof(float) * BQ * (BK32 + 1) +
                      sizeof(float) * ((size_t)(BQ + BK32) * ld + BK32 * ldv);
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32_kernel<float, COLS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  fa_f32_kernel<float, COLS><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Hq, Hq / Hkv,
      Sq,
      Sk, D, Dv, qs, ks, vs, causal, window, scale);
  return (int)cudaGetLastError();
}

// --------------------------------------------- flash_attention, bf16 wgmma
constexpr int NWG = 2;                         // consumer warpgroups
constexpr int BQW = 64 * NWG;                  // query rows per block
constexpr int FA3_THREADS = 128 * (NWG + 1);   // + the producer warpgroup
constexpr int STAGES = 2;                      // depth of the K/V ring
constexpr int PANEL_ROW = 128;                 // bytes: 64 bf16 columns

struct FaArgs {
  __nv_bfloat16* o;      // (B, Hq, Sq, Dv) contiguous
  float* lse;            // (B, Hq, Sq) natural-log LSE, or null (serving)
  int Hq, group, Sq, Sk, D, Dv;
  int causal, window;
  float scale_log2;      // sm_scale * log2(e): p = 2^(s' - m') = e^(s - m)
  int packed;            // rows are (head, position) pairs of one kv group
  int heads_per_block;   // packed: query heads per block (its TMA box)
  int blocks_per_kv;     // packed: blocks per kv head
};

// DP: the tile's padded q/k head dim; DV: that of v and o; BK: keys per
// tile
template <int DP, int DV = DP> struct FaTile {
  static constexpr int NP = DP / 64;   // 64-column panels of q and k
  static constexpr int NPV = DV / 64;  // of v
  static constexpr int BK = DP <= 128 ? 128 : 64;
  static constexpr int Q_BYTES = NP * BQW * PANEL_ROW;
  static constexpr int K_BYTES = NP * BK * PANEL_ROW;   // one stage of K
  static constexpr int V_BYTES = NPV * BK * PANEL_ROW;  // one stage of V
  static constexpr int BAR_OFF = Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  // + up to 1023 bytes to align the base, + the barriers
  static constexpr int SMEM = BAR_OFF + (1 + 3 * STAGES) * 8 + 1024;
};

// S = Q . K^T for one warpgroup's 64 query rows (panels at q, stride BQW
// rows) and a K tile (panels at k, stride BK rows), into sc; asynchronous:
// the caller commits and waits
template <int DP>
__device__ __forceinline__ void issue_qk(float (&sc)[FaTile<DP>::BK / 2],
                                         uint32_t q, uint32_t k) {
  constexpr int BK = FaTile<DP>::BK;
#pragma unroll
  for (int p = 0; p < FaTile<DP>::NP; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da =
          sw128_desc(q + p * BQW * PANEL_ROW + 32 * kk, 16, 1024);
      const uint64_t db =
          sw128_desc(k + p * BK * PANEL_ROW + 32 * kk, 16, 1024);
      wgmma_ss(sc, da, db, (p | kk) != 0);
    }
}

template <int DP, int DV>
__global__ void __launch_bounds__(FA3_THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, FaArgs a) {
  using Tile = FaTile<DP, DV>;
  constexpr int NP = Tile::NP, NPV = Tile::NPV, BK = Tile::BK;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled panels start on 1024-byte boundaries
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + Tile::Q_BYTES;            // STAGES x K_BYTES
  const uint32_t sV = sK + STAGES * Tile::K_BYTES;   // STAGES x V_BYTES
  const uint32_t bar = sQ + Tile::BAR_OFF;
  // barriers: Q full; K and V full [STAGES]; stage released [STAGES]
  const uint32_t barQ = bar;
  auto barK = [&](int s) { return bar + 8 * (1 + s); };
  auto barV = [&](int s) { return bar + 8 * (1 + STAGES + s); };
  auto barE = [&](int s) { return bar + 8 * (1 + 2 * STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  int h0, hk, nheads, q0;
  if (a.packed) {
    hk = blockIdx.y / a.blocks_per_kv;
    const int sub = blockIdx.y - hk * a.blocks_per_kv;
    h0 = hk * a.group + sub * a.heads_per_block;
    nheads = min(a.heads_per_block, a.group - sub * a.heads_per_block);
    q0 = 0;
  } else {
    h0 = blockIdx.y;
    hk = h0 / a.group;
    nheads = 1;
    q0 = (gridDim.x - 1 - blockIdx.x) * BQW;  // heaviest causal tiles first
  }
  // positions this block's rows hold, and the key tiles they can see
  const int pos_lo = q0;
  const int pos_hi = a.packed ? a.Sq - 1 : min(q0 + BQW, a.Sq) - 1;
  int k_begin = 0, k_end = a.Sk;
  if (a.causal) k_end = min(a.Sk, pos_hi + 1);
  if (a.window >= 0) k_begin = max(0, pos_lo - a.window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(barK(s), 1);
      mbar_init(barV(s), 1);
      mbar_init(barE(s), 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ---- producer: one lane issues every TMA load; the warpgroup hands
    // its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 4 * NWG && lane == 0) {
      const int q_rows = a.packed ? a.Sq * a.heads_per_block : BQW;
      mbar_expect_tx(barQ, NP * q_rows * PANEL_ROW);
      for (int p = 0; p < NP; ++p)
        tma_load_4d(sQ + p * BQW * PANEL_ROW, &qmap, barQ, 64 * p, q0, h0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int kt = k_begin + t * BK;
        if (t >= STAGES) mbar_wait(barE(s), ((t / STAGES) - 1) & 1);
        mbar_expect_tx(barK(s), Tile::K_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load_4d(sK + s * Tile::K_BYTES + p * BK * PANEL_ROW, &kmap,
                      barK(s), 64 * p, kt, hk, b);
        mbar_expect_tx(barV(s), Tile::V_BYTES);
        for (int p = 0; p < NPV; ++p)
          tma_load_4d(sV + s * Tile::V_BYTES + p * BK * PANEL_ROW, &vmap,
                      barV(s), 64 * p, kt, hk, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns block rows 64 wg .. 64 wg + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp >> 2;
  int head[2], pos[2];
  bool live[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = 64 * wg + 16 * (warp & 3) + (lane >> 2) + 8 * hh;
    if (a.packed) {
      head[hh] = h0 + row / a.Sq;
      pos[hh] = row % a.Sq;
      live[hh] = row < nheads * a.Sq;
    } else {
      head[hh] = h0;
      pos[hh] = q0 + row;
      live[hh] = pos[hh] < a.Sq;
    }
  }
  const bool wg_live = a.packed ? 64 * wg < nheads * a.Sq
                                : q0 + 64 * wg < a.Sq;
  const int wpos_lo = a.packed ? 0 : q0 + 64 * wg;
  const int wpos_hi = a.packed ? a.Sq - 1 : q0 + 64 * wg + 63;

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int col0 = 2 * (lane & 3);

  float sc[BK / 2];
  const uint32_t sQw = sQ + wg * 64 * PANEL_ROW;  // this warpgroup's rows

  mbar_wait(barQ, 0);
  if (!wg_live) {
    // a warpgroup without live rows keeps the barriers' counts
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES, phase = (t / STAGES) & 1;
      mbar_wait(barK(s), phase);
      mbar_wait(barV(s), phase);
      if (lane == 0) mbar_arrive(barE(s));
    }
    return;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES, phase = (t / STAGES) & 1;
    const int kt = k_begin + t * BK;
    // S = Q . K^T
    mbar_wait(barK(s), phase);
    wgmma_fence();
    issue_qk<DP>(sc, sQw, sK + s * Tile::K_BYTES);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax; only the tiles that straddle a bound or the end of Sk
    // are masked
    const bool edge = kt + BK > a.Sk || (a.causal && kt + BK - 1 > wpos_lo) ||
                      (a.window >= 0 && wpos_hi - kt >= a.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int hh = (i >> 1) & 1;
      float x = sc[i] * a.scale_log2;
      if (edge) {
        const int kpos = kt + 8 * (i >> 2) + col0 + (i & 1);
        bool ok = kpos < a.Sk;
        if (a.causal) ok = ok && pos[hh] >= kpos;
        if (a.window >= 0) ok = ok && pos[hh] - kpos < a.window;
        x = ok ? x : NEG_INF;
      }
      sc[i] = x;
      mx[hh] = fmaxf(mx[hh], x);
    }
    float alpha[2], sub[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      sub[hh] = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
      alpha[hh] = m[hh] <= NEG_INF * 0.5f ? 0.f : ex2(m[hh] - sub[hh]);
      m[hh] = m_new;
    }
    // P rounded to bf16, as the A fragments of P . V; l sums the rounded P
    // (a masked logit gives 2^(-1e30 - sub) = 0)
    uint32_t pa[BK / 4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int hh = i & 1;
      const __nv_bfloat162 pp = __floats2bfloat162_rn(
          ex2(sc[2 * i] - sub[hh]), ex2(sc[2 * i + 1] - sub[hh]));
      rs[hh] += __low2float(pp) + __high2float(pp);
      pa[i] = *reinterpret_cast<const uint32_t*>(&pp);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P . V; then the stage goes back to the producer
    mbar_wait(barV(s), phase);
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint32_t af[4] = {pa[4 * ks], pa[4 * ks + 1], pa[4 * ks + 2],
                              pa[4 * ks + 3]};
      const uint64_t db =
          sw128_desc(sV + s * Tile::V_BYTES + ks * 16 * PANEL_ROW,
                     BK * PANEL_ROW, 1024);
      wgmma_rs_tb(o, af, db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(barE(s));
  }

  // o = acc / max(l, 1e-30); l's four column quarters sum in a fixed order
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!live[hh]) continue;
    // the row's LSE where it is normalized: m is in log2 units
    if (a.lse != nullptr && (lane & 3) == 0)
      a.lse[((long long)b * a.Hq + head[hh]) * a.Sq + pos[hh]] =
          l[hh] > 0.f ? (m[hh] + log2f(l[hh])) * LN2
                      : __int_as_float(0x7f800000);  // +inf
    const float den = fmaxf(l[hh], 1e-30f);
    __nv_bfloat16* orow =
        a.o + (((long long)b * a.Hq + head[hh]) * a.Sq + pos[hh]) * a.Dv;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + col0;
      if (col < a.Dv)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o[4 * j + 2 * hh] / den, o[4 * j + 2 * hh + 1] / den);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &status);
#endif
    if (status == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)ptr;
  }
  return fn;
}

// a (B, H, S, D) bf16 view as a 4-D tensor map, innermost first, with boxes
// of 64 columns x rows x heads and the 128-byte swizzle
bool make_map(CUtensorMap* map, const void* base, int D, int S, int H, int B,
              Strides st, int box_rows, int box_heads) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, (cuuint32_t)box_heads,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int DV>
int attention_bf16(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                   int Dv,
                   Strides qs, Strides ks, Strides vs, int causal, int window,
                   float scale, cudaStream_t stream) {
  using Tile = FaTile<DP, DV>;
  FaArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = lse;
  a.Hq = Hq;
  a.group = Hq / Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.Dv = Dv;
  a.causal = causal;
  a.window = window;
  a.scale_log2 = scale * LOG2E;
  // short prompts: the heads of one kv group share a tile's rows
  a.packed = Sq <= BQW / 2 && a.group > 1;
  a.heads_per_block = a.packed ? min(a.group, BQW / Sq) : 1;
  a.blocks_per_kv =
      a.packed ? (a.group + a.heads_per_block - 1) / a.heads_per_block : 1;
  CUtensorMap qm, km, vm;
  const bool ok =
      make_map(&qm, q, D, Sq, Hq, B, qs, a.packed ? Sq : BQW,
               a.heads_per_block) &&
      make_map(&km, k, D, Sk, Hkv, B, ks, Tile::BK, 1) &&
      make_map(&vm, v, Dv, Sk, Hkv, B, vs, Tile::BK, 1);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fa_wgmma_kernel<DP, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.packed ? 1 : (Sq + BQW - 1) / BQW,
                  a.packed ? Hkv * a.blocks_per_kv : Hq, B);
  fa_wgmma_kernel<DP, DV><<<grid, FA3_THREADS, Tile::SMEM, stream>>>(
      qm, km, vm, a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- flash_decode
constexpr int FD_THREADS = 128;
constexpr int FD_WARPS = FD_THREADS / 32;
constexpr int FD_STAGES = 4;
constexpr int FD_SLOTS = 4;  // slots per lane group per tile

struct FdArgs {
  const unsigned char* valid;  // (S,)
  void* o;                     // (B, Hkv, G, D), splits == 1
  float* part_acc;             // (B, Hkv, splits, G, D), splits > 1
  float* part_ml;              // (B, Hkv, splits, G, 2): m, l
  int Hkv, G, S, D;
  int chunks;     // 16-byte chunks per row
  int lps;        // lanes per slot (a power of two, <= 32)
  int splits, split_len;
  float scale_log2;  // sm_scale * log2(e): m and the logits in log2 units
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the E = 16 / sizeof(T) values of a 16-byte chunk, widened to float
template <typename T>
__device__ __forceinline__ void widen(const uint4& c, float* out);
template <>
__device__ __forceinline__ void widen<float>(const uint4& c, float* out) {
  out[0] = __uint_as_float(c.x);
  out[1] = __uint_as_float(c.y);
  out[2] = __uint_as_float(c.z);
  out[3] = __uint_as_float(c.w);
}
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& c,
                                                     float* out) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The weight of an online-softmax state of max m (log2 units) in a merge
// whose max is M: 0 for a state that saw no valid slot.
__device__ __forceinline__ float state_weight(float m, float M) {
  return m <= NEG_INF * 0.5f ? 0.f : ex2(m - M);
}

// GMAX: the most query rows per group; NCH: 16-byte chunks per lane
template <typename T, int GMAX, int NCH>
__global__ void __launch_bounds__(FD_THREADS)
fd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, FdArgs a) {
  constexpr int E = 16 / sizeof(T);
  // slots a group scores before one online-softmax update
  constexpr int U = GMAX <= 4 ? 4 : (GMAX <= 8 ? 2 : 1);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * a.Hkv + h;
  const int C = a.chunks, lps = a.lps;
  const int groups = FD_THREADS / lps;           // lane groups per block
  const int ts = groups * FD_SLOTS;              // slots per tile
  const int gl = lane & (lps - 1);               // lane within its group
  const int grp = tid / lps;
  const int s_begin = sp * a.split_len;
  const int s_end = min(a.S, s_begin + a.split_len);
  const int n_tiles = (s_end - s_begin + ts - 1) / ts;
  const int stage_bytes = 2 * ts * C * 16;
  const uint32_t sbase = smem_u32(smem);

  const uint4* kc = reinterpret_cast<const uint4*>(k) + bh * a.S * C;
  const uint4* vc = reinterpret_cast<const uint4*>(v) + bh * a.S * C;
  // a tile's K (and V) rows are ts * C consecutive chunks of the cache
  auto load_tile = [&](int t) {
    const uint32_t dst = sbase + (t % FD_STAGES) * stage_bytes;
    const long long c0 = (long long)(s_begin + t * ts) * C;
    const long long c_end = (long long)s_end * C;
    const int n = ts * C;
    for (int idx = tid; idx < n; idx += FD_THREADS) {
      const long long ci = c0 + idx;
      const bool in = ci < c_end;
      cp_async16(dst + idx * 16, kc + (in ? ci : 0), in ? 16 : 0);
      cp_async16(dst + (n + idx) * 16, vc + (in ? ci : 0), in ? 16 : 0);
    }
  };

  // this lane's chunks of the G query rows: widened to float where they
  // fit in 64 registers, else kept raw and widened at each use
  constexpr bool QF = GMAX * NCH * E <= 64;
  uint4 qv[GMAX][NCH];
  float qw[QF ? GMAX : 1][NCH][E];
  const uint4* qc = reinterpret_cast<const uint4*>(q) + bh * a.G * C;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = gl + lps * i;
      qv[g][i] = (g < a.G && c < C) ? qc[g * C + c] : make_uint4(0, 0, 0, 0);
      if constexpr (QF) widen<T>(qv[g][i], qw[g][i]);
    }

  float m[GMAX], l[GMAX], acc[GMAX][NCH][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][i][e] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < FD_STAGES - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = s_begin + t * ts;
    // the validity of this lane's slots, read before the wait
    bool okv[FD_SLOTS];
#pragma unroll
    for (int j = 0; j < FD_SLOTS; ++j) {
      const int pos = t0 + j * groups + grp;
      okv[j] = pos < s_end && a.valid[pos];
    }
    cp_async_wait<FD_STAGES - 2>();
    __syncthreads();  // tile t landed; every reader of tile t - 1 is done
    if (t + FD_STAGES - 1 < n_tiles) load_tile(t + FD_STAGES - 1);
    cp_async_commit();

    const unsigned char* st = smem + (t % FD_STAGES) * stage_bytes;
    const uint4* ks_ = reinterpret_cast<const uint4*>(st);
    const uint4* vs_ = ks_ + ts * C;
#pragma unroll
    for (int r = 0; r < FD_SLOTS / U; ++r) {
      // partial dots of the U slots' K rows with the G query rows
      float s[U][GMAX];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = (r * U + u) * groups + grp;
        ok[u] = okv[r * U + u];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) s[u][g] = 0.f;
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int c = gl + lps * i;
          if (c < C) {
            float kf[E];
            widen<T>(ks_[slot * C + c], kf);
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
              float qf[E];
              if constexpr (QF) {
#pragma unroll
                for (int e = 0; e < E; ++e) qf[e] = qw[g][i][e];
              } else {
                widen<T>(qv[g][i], qf);
              }
#pragma unroll
              for (int e = 0; e < E; ++e) s[u][g] += qf[e] * kf[e];
            }
          }
        }
      }
      // sum over the group's lanes: a butterfly whose every level issues
      // its U x GMAX independent shuffles together
      for (int off = lps >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          s[u][g] = ok[u] ? s[u][g] * a.scale_log2 : NEG_INF;
      // one online-softmax update for the U slots
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float mc = s[0][g];
#pragma unroll
        for (int u = 1; u < U; ++u) mc = fmaxf(mc, s[u][g]);
        const float m_new = fmaxf(m[g], mc);
        const float sub = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
        const float alpha = m[g] <= NEG_INF * 0.5f ? 0.f : ex2(m[g] - sub);
        float p[U];
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u] = ok[u] ? ex2(s[u][g] - sub) : 0.f;
          ps += p[u];
        }
        l[g] = l[g] * alpha + ps;
        m[g] = m_new;
#pragma unroll
        for (int i = 0; i < NCH; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][i][e] *= alpha;
        s[0][g] = p[0];
#pragma unroll
        for (int u = 1; u < U; ++u) s[u][g] = p[u];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = (r * U + u) * groups + grp;
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int c = gl + lps * i;
          if (c < C) {
            float vf[E];
            widen<T>(vs_[slot * C + c], vf);
#pragma unroll
            for (int g = 0; g < GMAX; ++g)
#pragma unroll
              for (int e = 0; e < E; ++e) acc[g][i][e] += s[u][g] * vf[e];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' states below

  // the groups of a warp, pairwise in a fixed order
  for (int off = lps; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], mo);
      const float w0 = state_weight(m[g], M), w1 = state_weight(mo, M);
      l[g] = w0 * l[g] + w1 * lo;
      m[g] = M;
#pragma unroll
      for (int i = 0; i < NCH; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i][e], off);
          acc[g][i][e] = w0 * acc[g][i][e] + w1 * ao;
        }
    }
  }
  // the warps, through shared memory: per warp G x D accumulators, then
  // G (m, l) pairs
  float* red = reinterpret_cast<float*>(smem);
  float* redml = red + FD_WARPS * a.G * a.D;
  if (lane < lps) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= a.G) break;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int c = gl + lps * i;
        if (c < C)
#pragma unroll
          for (int e = 0; e < E; ++e)
            red[(warp * a.G + g) * a.D + c * E + e] = acc[g][i][e];
      }
      if (lane == 0) {
        redml[(warp * a.G + g) * 2] = m[g];
        redml[(warp * a.G + g) * 2 + 1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < a.G * a.D; idx += FD_THREADS) {
    const int g = idx / a.D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w)
      M = fmaxf(M, redml[(w * a.G + g) * 2]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) {
      const float wt = state_weight(redml[(w * a.G + g) * 2], M);
      L += wt * redml[(w * a.G + g) * 2 + 1];
      A += wt * red[w * a.G * a.D + idx];
    }
    if (a.splits == 1) {
      static_cast<T*>(a.o)[bh * a.G * a.D + idx] =
          from_f32<T>(A / fmaxf(L, 1e-30f));
    } else {
      const long long row = (bh * a.splits + sp) * a.G + g;
      a.part_acc[row * a.D + (idx - g * a.D)] = A;
      if (idx == g * a.D) {
        a.part_ml[row * 2] = M;
        a.part_ml[row * 2 + 1] = L;
      }
    }
  }
}

// merges the splits of one (b, kv head) in split order
template <typename T>
__global__ void __launch_bounds__(FD_THREADS)
fd_combine_kernel(FdArgs a) {
  const long long bh = blockIdx.x;
  for (int idx = threadIdx.x; idx < a.G * a.D; idx += FD_THREADS) {
    const int g = idx / a.D, d = idx - g * a.D;
    float M = NEG_INF;
    for (int s = 0; s < a.splits; ++s)
      M = fmaxf(M, a.part_ml[((bh * a.splits + s) * a.G + g) * 2]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < a.splits; ++s) {
      const long long row = (bh * a.splits + s) * a.G + g;
      const float wt = state_weight(a.part_ml[row * 2], M);
      L += wt * a.part_ml[row * 2 + 1];
      A += wt * a.part_acc[row * a.D + d];
    }
    static_cast<T*>(a.o)[bh * a.G * a.D + idx] =
        from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int GMAX, int NCH>
int decode_split(const void* q, const void* k, const void* v, FdArgs a,
                 int B, cudaStream_t stream) {
  const int ts = (FD_THREADS / a.lps) * FD_SLOTS;
  const size_t ring = (size_t)FD_STAGES * 2 * ts * a.chunks * 16;
  const size_t red = sizeof(float) * FD_WARPS * a.G * ((size_t)a.D + 2);
  const size_t smem = ring > red ? ring : red;
  cudaError_t err = cudaFuncSetAttribute(
      fd_split_kernel<T, GMAX, NCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.splits, a.Hkv, B);
  fd_split_kernel<T, GMAX, NCH><<<grid, FD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  fd_combine_kernel<T><<<B * a.Hkv, FD_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int decode(const void* q, const void* k, const void* v, FdArgs a, int B,
           cudaStream_t stream) {
  const int nch = a.chunks > 32 ? 2 : 1;
  const int per = (a.chunks + nch - 1) / nch;
  a.lps = 1;
  while (a.lps < per) a.lps <<= 1;
  const int gmax = a.G <= 4 ? 4 : (a.G <= 8 ? 8 : 16);
#define FD_CASE(GM, NC)                                          \
  if (gmax == GM && nch == NC)                                   \
    return decode_split<T, GM, NC>(q, k, v, a, B, stream);
  FD_CASE(4, 1) FD_CASE(8, 1) FD_CASE(16, 1)
  if constexpr (sizeof(T) == 4) {
    FD_CASE(4, 2) FD_CASE(8, 2) FD_CASE(16, 2)
  }
#undef FD_CASE
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------ flash_attention backward
//
// The gradient that jax.grad takes of the JAX package's XLA attention (its
// Pallas kernel has no backward), in the FlashAttention-2 shape: three
// launches, each a pure function of the shape, no atomics.
//   1. D_i = rowsum(dO . O) in float32 (bf16: fa_bwd_prep_kernel, which
//      also writes the LSE in log2 units into rows padded for the tiles).
//   2. dK and dV: one block per (key tile, kv head, batch) walks the G query
//      heads of its kv head and their query tiles in a fixed order, so the
//      GQA sum stays in the block's registers.
//   3. dQ: one block per (query tile, q head, batch) walks the key tiles.
// Each block recomputes S = scale Q K^T under the forward's masks (causal,
// window, the ragged ends of Sq and Sk) and P = exp(S - lse) from the
// forward's LSE (+inf on a dead row, whose P is 0: its gradients are 0, as
// its output is); then dV = P^T dO, dP = dO V^T, dS = P (dP - D_i),
// dQ = scale dS K and dK = scale dS^T Q, float32 sums, outputs in the
// input dtype, written through their strides. dQ is a second pass that
// recomputes S and dP: the price of writing dQ without atomics (writing dS
// out for a later pass would move more bytes than the two products cost).
// bf16 (fa_bwd_dkdv_kernel<DP, DV, PART>, fa_bwd_dq_kernel<DP, DV>): q/k
// tiles of DP = 64, 128 or 192 columns, v and dO tiles of DV = DP or MLA's
// (192, 128), each operand sized on its own; bound by operations
// (seven products of 2 Sq Sk D flops a head, halved when causal), so every
// product is wgmma, in the shape of fa_wgmma_kernel (FlashAttention-3):
//   * a producer warpgroup (one thread issuing TMA loads, registers handed
//     over with setmaxnreg) and two consumer warpgroups of 64 rows each;
//   * dK/dV: the block's 128 keys of K and V are loaded once; a two-stage
//     ring carries the (Q, dO) tiles of 64 queries with their LSE and D_i
//     rows (bulk copies). S^T = K Q^T and dP^T = V dO^T are wgmma with both
//     operands K-major in shared memory; P^T and dS^T stay in registers and
//     are the bf16 A operands of dV += P^T dO and dK += dS^T Q, which read
//     dO and Q MN-major through the transpose bit, so no operand is copied
//     transposed. dP^T runs while P^T is exponentiated, dV's products while
//     dS^T is formed;
//   * dQ: the block's 128 queries of Q and dO are loaded once; the ring
//     carries (K, V) tiles of BK keys (128 at DP = 64, 64 above, for
//     registers). S = Q K^T and dP = dO V^T are wgmma from shared memory,
//     dQ += dS K reads K MN-major;
//   * masks are evaluated only on tiles that cross the causal diagonal, a
//     window's edge or (dQ) the ragged end of Sk; tiles that the masks
//     exclude are skipped; TMA's zero fill covers rows past S and columns
//     past D (D <= 64 runs in DP = 64, 64 < D <= 128 in DP = 128, up to
//     192 in DP = 192), and
//     padded query rows have an LSE of +inf, so P = 0 there;
//   * at DP = 192 a dK/dV block cannot hold both accumulators (192
//     registers a thread beside S^T and dP^T, over setmaxnreg's 240), so
//     dK (BWD_DK) and dV (BWD_DV) are two launches over the same tiles,
//     each recomputing S^T: four launches a call in place of three;
//   * the heaviest causal tiles are launched first (key tile 0 for dK/dV,
//     the last query tile for dQ: the tile index is the grid's slowest
//     axis).
// P is rounded to bf16 for P^T dO, as the forward's P . V rounds it, and dS
// for its two products.
// float32 (fa_bwd_*_f32_kernel): CUDA-core FMAs (TF32 would miss the
// float32 tolerance), 32 x 32 tiles, 256 threads.

struct BwdArgs {
  const void *q, *k, *v, *o, *g;  // g: dO
  const float* lse;                // (B, Hq, Sq)
  float* delta;  // float32: D_i (B, Hq, Sq); bf16: the scratch of the
                 // LSE and D_i rows (flash_attention_bwd_scratch)
  void *dq, *dk, *dv;
  Strides qs, ks, vs, os, gs, dqs, dks, dvs;
  int B, Hq, Hkv, group, Sq, Sk, D, Dv, causal, window;
  float scale;
};

__device__ __forceinline__ bool bwd_live(const BwdArgs& a, int qpos,
                                         int kpos) {
  bool ok = qpos < a.Sq && kpos < a.Sk;
  if (a.causal) ok = ok && qpos >= kpos;
  if (a.window >= 0) ok = ok && (qpos - kpos) < a.window;
  return ok;
}

// the key tiles a query tile [q0, q0 + rows) can see: [begin, end)
__device__ __forceinline__ void bwd_key_range(const BwdArgs& a, int q0,
                                              int rows, int bk, int& begin,
                                              int& end) {
  const int q_last = min(q0 + rows, a.Sq) - 1;
  begin = 0;
  end = a.Sk;
  if (a.causal) end = min(a.Sk, q_last + 1);
  if (a.window >= 0) begin = max(0, q0 - a.window + 1);
  begin = (begin / bk) * bk;
}

// the query tiles that can see a key tile [k0, k0 + rows): [begin, end)
__device__ __forceinline__ void bwd_query_range(const BwdArgs& a, int k0,
                                                int rows, int bq,
                                                int& begin, int& end) {
  const int k_last = min(k0 + rows, a.Sk) - 1;
  begin = a.causal ? (k0 / bq) * bq : 0;
  end = a.Sq;
  if (a.window >= 0) end = min(a.Sq, k_last + a.window);
}

// float32: a warp a row
template <typename T>
__global__ void __launch_bounds__(256) fa_bwd_delta_kernel(BwdArgs a) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.Hq * a.Sq) return;
  const int s = (int)(row % a.Sq);
  const long long bh = row / a.Sq;
  const int h = (int)(bh % a.Hq), b = (int)(bh / a.Hq);
  const T* o = static_cast<const T*>(a.o) + b * a.os.b + h * a.os.h +
               s * a.os.s;
  const T* g = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h +
               s * a.gs.s;
  float acc = 0.f;
  for (int c = lane; c < a.Dv; c += 32) acc += to_f32(o[c]) * to_f32(g[c]);
  acc = warp_sum(acc);
  if (lane == 0) a.delta[row] = acc;
}

// ---- float32: CUDA cores
constexpr int BT32 = 32;           // keys and queries per tile
constexpr int BWD32_THREADS = 256;

// rows [r0, r0 + BT32) of a (B, H, S, D) view into a BT32 x ld tile, zero
// past S
__device__ __forceinline__ void bwd_load32(float* dst, const float* src,
                                           long long s_stride, int r0, int S,
                                           int D, int ld) {
  for (int idx = threadIdx.x; idx < BT32 * D; idx += BWD32_THREADS) {
    const int r = idx / D, c = idx - r * D;
    dst[r * ld + c] = r0 + r < S ? src[(r0 + r) * s_stride + c] : 0.f;
  }
}

// COLS: accumulator columns per thread (D, Dv <= 8 COLS)
template <int COLS>
__global__ void __launch_bounds__(BWD32_THREADS)
fa_bwd_dkdv_f32_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int ld = a.D + 1, ldv = a.Dv + 1, ldp = BT32 + 1;
  float* Ks = reinterpret_cast<float*>(smem_b);
  float* Vs = Ks + BT32 * ld;
  float* Qs = Vs + BT32 * ldv;
  float* Gs = Qs + BT32 * ld;
  float* Ps = Gs + BT32 * ldv;    // P^T [key][query]
  float* Ss = Ps + BT32 * ldp;    // dS^T [key][query]
  float* Ls = Ss + BT32 * ldp;    // lse
  float* Ds = Ls + BT32;          // D_i
  const int tid = threadIdx.x, kr = tid >> 3, cg = tid & 7;
  const int k0 = blockIdx.x * BT32, hk = blockIdx.y, b = blockIdx.z;
  bwd_load32(Ks, static_cast<const float*>(a.k) + b * a.ks.b + hk * a.ks.h,
             a.ks.s, k0, a.Sk, a.D, ld);
  bwd_load32(Vs, static_cast<const float*>(a.v) + b * a.vs.b + hk * a.vs.h,
             a.vs.s, k0, a.Sk, a.Dv, ldv);
  float dk[COLS], dv[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) dk[j] = dv[j] = 0.f;
  int q_begin, q_end;
  bwd_query_range(a, k0, BT32, BT32, q_begin, q_end);
  const int kpos = k0 + kr;
  for (int hh = 0; hh < a.group; ++hh) {
    const int h = hk * a.group + hh;
    const float* qb = static_cast<const float*>(a.q) + b * a.qs.b +
                      h * a.qs.h;
    const float* gb = static_cast<const float*>(a.g) + b * a.gs.b +
                      h * a.gs.h;
    const long long rowbase = ((long long)b * a.Hq + h) * a.Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += BT32) {
      __syncthreads();  // the previous tile's readers are done
      bwd_load32(Qs, qb, a.qs.s, q0, a.Sq, a.D, ld);
      bwd_load32(Gs, gb, a.gs.s, q0, a.Sq, a.Dv, ldv);
      if (tid < BT32) {
        const bool in = q0 + tid < a.Sq;
        Ls[tid] = in ? a.lse[rowbase + q0 + tid] : 0.f;
        Ds[tid] = in ? a.delta[rowbase + q0 + tid] : 0.f;
      }
      __syncthreads();
      float sc[4], dp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] = dp[i] = 0.f;
      for (int d = 0; d < a.D; ++d) {
        const float kv = Ks[kr * ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i] += kv * Qs[(cg + 8 * i) * ld + d];
      }
      for (int d = 0; d < a.Dv; ++d) {
        const float vv = Vs[kr * ldv + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) dp[i] += vv * Gs[(cg + 8 * i) * ldv + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = cg + 8 * i;
        const float p = bwd_live(a, q0 + qi, kpos)
                            ? expf(sc[i] * a.scale - Ls[qi]) : 0.f;
        Ps[kr * ldp + qi] = p;
        Ss[kr * ldp + qi] = p * (dp[i] - Ds[qi]);
      }
      __syncthreads();
      for (int qi = 0; qi < BT32; ++qi) {
        const float p = Ps[kr * ldp + qi], ds = Ss[kr * ldp + qi];
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const int c = cg + 8 * j;
          if (c < a.Dv) dv[j] += p * Gs[qi * ldv + c];
          if (c < a.D) dk[j] += ds * Qs[qi * ld + c];
        }
      }
    }
  }
  if (kpos >= a.Sk) return;
  float* dkr = static_cast<float*>(a.dk) + b * a.dks.b + hk * a.dks.h +
               kpos * a.dks.s;
  float* dvr = static_cast<float*>(a.dv) + b * a.dvs.b + hk * a.dvs.h +
               kpos * a.dvs.s;
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int c = cg + 8 * j;
    if (c < a.D) dkr[c] = dk[j] * a.scale;
    if (c < a.Dv) dvr[c] = dv[j];
  }
}

template <int COLS>
__global__ void __launch_bounds__(BWD32_THREADS)
fa_bwd_dq_f32_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int ld = a.D + 1, ldv = a.Dv + 1, ldp = BT32 + 1;
  float* Qs = reinterpret_cast<float*>(smem_b);
  float* Gs = Qs + BT32 * ld;
  float* Ks = Gs + BT32 * ldv;
  float* Vs = Ks + BT32 * ld;
  float* Ss = Vs + BT32 * ldv;   // dS [query][key]
  const int tid = threadIdx.x, qr = tid >> 3, cg = tid & 7;
  const int q0 = blockIdx.x * BT32, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  bwd_load32(Qs, static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h,
             a.qs.s, q0, a.Sq, a.D, ld);
  bwd_load32(Gs, static_cast<const float*>(a.g) + b * a.gs.b + h * a.gs.h,
             a.gs.s, q0, a.Sq, a.Dv, ldv);
  const int qpos = q0 + qr;
  const long long row = ((long long)b * a.Hq + h) * a.Sq + qpos;
  const float L = qpos < a.Sq ? a.lse[row] : 0.f;
  const float Di = qpos < a.Sq ? a.delta[row] : 0.f;
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b +
                    hk * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b +
                    hk * a.vs.h;
  float dq[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) dq[j] = 0.f;
  int k_begin, k_end;
  bwd_key_range(a, q0, BT32, BT32, k_begin, k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += BT32) {
    __syncthreads();
    bwd_load32(Ks, kb, a.ks.s, k0, a.Sk, a.D, ld);
    bwd_load32(Vs, vb, a.vs.s, k0, a.Sk, a.Dv, ldv);
    __syncthreads();
    float sc[4], dp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i] = dp[i] = 0.f;
    for (int d = 0; d < a.D; ++d) {
      const float qv = Qs[qr * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] += qv * Ks[(cg + 8 * i) * ld + d];
    }
    for (int d = 0; d < a.Dv; ++d) {
      const float gv = Gs[qr * ldv + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) dp[i] += gv * Vs[(cg + 8 * i) * ldv + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ki = cg + 8 * i;
      const float p = bwd_live(a, qpos, k0 + ki)
                          ? expf(sc[i] * a.scale - L) : 0.f;
      Ss[qr * ldp + ki] = p * (dp[i] - Di);
    }
    __syncthreads();
    for (int ki = 0; ki < BT32; ++ki) {
      const float ds = Ss[qr * ldp + ki];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = cg + 8 * j;
        if (c < a.D) dq[j] += ds * Ks[ki * ld + c];
      }
    }
  }
  if (qpos >= a.Sq) return;
  float* dqr = static_cast<float*>(a.dq) + b * a.dqs.b + h * a.dqs.h +
               qpos * a.dqs.s;
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int c = cg + 8 * j;
    if (c < a.D) dqr[c] = dq[j] * a.scale;
  }
}

// ---- bf16: wgmma and TMA
typedef __nv_bfloat16 bf16;
constexpr int BWD_BQ = 64;      // queries per dK/dV step (the wgmma N of S^T)
constexpr int BWD_BKV = BQW;    // keys per dK/dV block: 64 per consumer WG
constexpr int BWD_BQD = BQW;    // queries per dQ block: 64 per consumer WG
constexpr int BWD_STAGES = 2;   // depth of both kernels' rings
constexpr int BWD_PAD = BQW;    // the LSE and D_i rows are padded to this

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// D (64 x N) = A . B^T over DP columns: A (64 rows) and B (N rows) K-major
// panels whose panel strides are a_rows and b_rows rows; asynchronous
template <int DP, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint32_t a,
                                         int a_rows, uint32_t b, int b_rows) {
#pragma unroll
  for (int p = 0; p < DP / 64; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(d, sw128_desc(a + p * a_rows * PANEL_ROW + 32 * kk, 16, 1024),
               sw128_desc(b + p * b_rows * PANEL_ROW + 32 * kk, 16, 1024),
               (p | kk) != 0);
}

// D (64 x N) += A (64 x K: the bf16 A fragments a) . B (K x N), B read
// MN-major from panels of b_rows rows; asynchronous
template <int K, int N>
__device__ __forceinline__ void issue_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[K / 4],
                                         uint32_t b, int b_rows) {
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    const uint32_t af[4] = {a[4 * ks], a[4 * ks + 1], a[4 * ks + 2],
                            a[4 * ks + 3]};
    wgmma_rs_tb(d, af, sw128_desc(b + ks * 16 * PANEL_ROW,
                                  b_rows * PANEL_ROW, 1024));
  }
}

struct BwdWgArgs {
  const float* lse2;   // (B, Hq, Sq_pad): the LSE in log2 units, +inf past Sq
  const float* delta;  // (B, Hq, Sq_pad): D_i, 0 past Sq
  bf16 *dq, *dk, *dv;
  Strides dqs, dks, dvs;
  int Hq, group, Sq, Sk, Sq_pad, D, Dv, causal, window;
  float scale, scale_log2;
};

// the causal and window masks of a (query, key) pair
__device__ __forceinline__ bool bwd_pair_live(const BwdWgArgs& a, int qpos,
                                              int kpos) {
  return (!a.causal || qpos >= kpos) &&
         (a.window < 0 || qpos - kpos < a.window);
}

// The tiles of the bf16 backward: q/k tile DP and v tile DV (equal, or
// MLA's (192, 128)), each a run of 64-column panels; q, k in NP panels,
// v and dO in NPV
template <int DP, int DV> struct BwdTile {
  static constexpr int NP = DP / 64, NPV = DV / 64;
  // dK/dV: K and V of the block's keys, then the ring of (Q, dO) tiles,
  // then each stage's LSE and D_i rows
  static constexpr int K_BYTES = NP * BWD_BKV * PANEL_ROW;
  static constexpr int V_BYTES = NPV * BWD_BKV * PANEL_ROW;
  static constexpr int QT_BYTES = NP * BWD_BQ * PANEL_ROW;
  static constexpr int GT_BYTES = NPV * BWD_BQ * PANEL_ROW;
  static constexpr int DKDV_ROWS =
      K_BYTES + V_BYTES + BWD_STAGES * (QT_BYTES + GT_BYTES);
  static constexpr int DKDV_BAR = DKDV_ROWS + 2 * BWD_STAGES * BWD_BQ * 4;
  static constexpr int DKDV_SMEM = DKDV_BAR + (1 + 2 * BWD_STAGES) * 8 + 1024;
  // dQ: Q and dO of the block's queries, then the ring of (K, V) tiles of
  // BK keys
  static constexpr int BK = DP <= 64 ? 128 : 64;
  static constexpr int Q_BYTES = NP * BWD_BQD * PANEL_ROW;
  static constexpr int G_BYTES = NPV * BWD_BQD * PANEL_ROW;
  static constexpr int KT_BYTES = NP * BK * PANEL_ROW;
  static constexpr int VT_BYTES = NPV * BK * PANEL_ROW;
  static constexpr int DQ_BAR =
      Q_BYTES + G_BYTES + BWD_STAGES * (KT_BYTES + VT_BYTES);
  static constexpr int DQ_SMEM = DQ_BAR + (1 + 3 * BWD_STAGES) * 8 + 1024;
};

// What a dK/dV launch accumulates. Up to DP = 128 one pass holds both
// (dk[DP / 2] and dv[DV / 2] a consumer thread, 128 registers at DP 128);
// at DP = 192 the two would take 192 beside S^T and dP^T, over the 240 of
// setmaxnreg, so dK and dV take a pass each over the same tiles (S^T is
// computed twice): 96 accumulators a thread.
enum { BWD_BOTH = 0, BWD_DK = 1, BWD_DV = 2 };

// D_i = rowsum(dO . O) and the LSE in log2 units, into (B, Hq, Sq_pad) rows
// (0 and +inf past Sq): G lanes a row, one 16-byte vector of O and of dO
// each, a fixed-order butterfly over the G lanes
template <int G>
__global__ void __launch_bounds__(256)
fa_bwd_prep_kernel(BwdArgs a, int Sq_pad, float* lse2, float* delta) {
  const long long row = (long long)blockIdx.x * (256 / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const bool in = row < (long long)a.B * a.Hq * Sq_pad;
  const int s = (int)(row % Sq_pad);
  const long long bh = row / Sq_pad;
  const int h = (int)(bh % a.Hq), b = (int)(bh / a.Hq);
  const bool live = in && s < a.Sq;
  float acc = 0.f;
  if (live && lane < a.Dv / 8) {
    const bf16* o = static_cast<const bf16*>(a.o) + b * a.os.b + h * a.os.h +
                    s * a.os.s + 8 * lane;
    const bf16* g = static_cast<const bf16*>(a.g) + b * a.gs.b + h * a.gs.h +
                    s * a.gs.s + 8 * lane;
    float ov[8], gv[8];
    widen<bf16>(*reinterpret_cast<const uint4*>(o), ov);
    widen<bf16>(*reinterpret_cast<const uint4*>(g), gv);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += ov[e] * gv[e];
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && lane == 0) {
    delta[row] = live ? acc : 0.f;
    lse2[row] = live ? a.lse[bh * a.Sq + s] * LOG2E
                     : __int_as_float(0x7f800000);  // +inf: P = 0
  }
}

// dK and dV (PART: both, or one of them): one block per (kv head, batch,
// key tile of 128 keys; key tile 0, the heaviest under a causal mask,
// first). Consumer warpgroup wg owns keys k0 + 64 wg .. + 63; the producer
// streams the (Q, dO, LSE, D_i) tiles of the kv head's query heads, head by
// head, in query order.
template <int DP, int DV, int PART>
__global__ void __launch_bounds__(FA3_THREADS, 1)
fa_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap gmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, BwdWgArgs a) {
  using Tl = BwdTile<DP, DV>;
  constexpr int NP = Tl::NP, NPV = Tl::NPV;
  constexpr bool WANT_DK = PART != BWD_DV, WANT_DV = PART != BWD_DK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + Tl::K_BYTES;
  const uint32_t sQ = sV + Tl::V_BYTES;                  // [BWD_STAGES]
  const uint32_t sG = sQ + BWD_STAGES * Tl::QT_BYTES;   // [BWD_STAGES]
  float* sL = reinterpret_cast<float*>(smem + Tl::DKDV_ROWS);
  float* sD = sL + BWD_STAGES * BWD_BQ;
  const uint32_t bar = sK + Tl::DKDV_BAR;
  // barriers: K and V full; stage full [BWD_STAGES]; stage released
  const uint32_t barKV = bar;
  auto barF = [&](int s) { return bar + 8 * (1 + s); };
  auto barE = [&](int s) { return bar + 8 * (1 + BWD_STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BWD_BKV;
  // the query tiles that some key of the block sees
  const int k_last = min(k0 + BWD_BKV, a.Sk) - 1;
  const int q_begin = a.causal ? k0 : 0;
  const int q_end = a.window >= 0 ? min(a.Sq, k_last + a.window) : a.Sq;
  const int nq = q_end > q_begin ? (q_end - q_begin + BWD_BQ - 1) / BWD_BQ
                                 : 0;
  const int n_tiles = a.group * nq;

  if (threadIdx.x == 0) {
    mbar_init(barKV, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(barF(s), 1);
      mbar_init(barE(s), 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 4 * NWG && lane == 0) {
      mbar_expect_tx(barKV, Tl::K_BYTES + Tl::V_BYTES);
      for (int p = 0; p < NP; ++p)
        tma_load_4d(sK + p * BWD_BKV * PANEL_ROW, &kmap, barKV, 64 * p, k0,
                    hk, b);
      for (int p = 0; p < NPV; ++p)
        tma_load_4d(sV + p * BWD_BKV * PANEL_ROW, &vmap, barKV, 64 * p, k0,
                    hk, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % BWD_STAGES;
        const int h = hk * a.group + t / nq;
        const int q0 = q_begin + (t % nq) * BWD_BQ;
        if (t >= BWD_STAGES) mbar_wait(barE(s), ((t / BWD_STAGES) - 1) & 1);
        mbar_expect_tx(barF(s),
                       Tl::QT_BYTES + Tl::GT_BYTES + 2 * BWD_BQ * 4);
        for (int p = 0; p < NP; ++p)
          tma_load_4d(sQ + s * Tl::QT_BYTES + p * BWD_BQ * PANEL_ROW, &qmap,
                      barF(s), 64 * p, q0, h, b);
        for (int p = 0; p < NPV; ++p)
          tma_load_4d(sG + s * Tl::GT_BYTES + p * BWD_BQ * PANEL_ROW, &gmap,
                      barF(s), 64 * p, q0, h, b);
        const long long row = ((long long)b * a.Hq + h) * a.Sq_pad + q0;
        bulk_load(smem_u32(sL + s * BWD_BQ), a.lse2 + row, BWD_BQ * 4,
                  barF(s));
        bulk_load(smem_u32(sD + s * BWD_BQ), a.delta + row, BWD_BQ * 4,
                  barF(s));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp >> 2, t4 = lane & 3;
  const int kw = k0 + 64 * wg;  // this warpgroup's first key
  const int krow = kw + 16 * (warp & 3) + (lane >> 2);  // and krow + 8
  const uint32_t sKw = sK + wg * 64 * PANEL_ROW;
  const uint32_t sVw = sV + wg * 64 * PANEL_ROW;
  // the accumulators of the pass (one word where the pass has none)
  float dk[WANT_DK ? DP / 2 : 1], dv[WANT_DV ? DV / 2 : 1];
#pragma unroll
  for (int i = 0; i < (WANT_DK ? DP / 2 : 1); ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (WANT_DV ? DV / 2 : 1); ++i) dv[i] = 0.f;
  mbar_wait(barKV, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % BWD_STAGES, phase = (t / BWD_STAGES) & 1;
    const int q0 = q_begin + (t % nq) * BWD_BQ;
    // the tile's queries [q0, q0 + 63] against this warpgroup's keys
    // [kw, kw + 63]: skipped where every pair is masked, masked only where
    // the tile crosses the causal diagonal or the window's edge (queries
    // past Sq have P = 0 from their +inf LSE; keys past Sk are not stored)
    const bool skip = kw >= a.Sk || (a.causal && q0 + 63 < kw) ||
                      (a.window >= 0 && q0 - (kw + 63) >= a.window);
    const bool edge = (a.causal && q0 < kw + 63) ||
                      (a.window >= 0 && q0 + 63 - kw >= a.window);
    mbar_wait(barF(s), phase);
    if (!skip) {
      const uint32_t sQs = sQ + s * Tl::QT_BYTES;
      const uint32_t sGs = sG + s * Tl::GT_BYTES;
      const float* Ls = sL + s * BWD_BQ;
      const float* Ds = sD + s * BWD_BQ;
      // S^T = K Q^T and dP^T = V dO^T: two groups, S^T's first (no dP^T
      // in a dV pass)
      float st[BWD_BQ / 2], dpt[WANT_DK ? BWD_BQ / 2 : 1];
      wgmma_fence();
      issue_ss<DP, BWD_BQ>(st, sKw, BWD_BKV, sQs, BWD_BQ);
      wgmma_commit();
      if constexpr (WANT_DK) {
        issue_ss<DV, BWD_BQ>(dpt, sVw, BWD_BKV, sGs, BWD_BQ);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(st);
      // P^T in place (float32), and rounded to bf16 as dV's A fragments
      uint32_t pa[WANT_DV ? BWD_BQ / 4 : 1];
#pragma unroll
      for (int i = 0; i < BWD_BQ / 2; i += 2) {
        const int col = 8 * (i >> 2) + 2 * t4;  // query offset of st[i]
        const float2 L = *reinterpret_cast<const float2*>(Ls + col);
        float p0 = ex2(st[i] * a.scale_log2 - L.x);
        float p1 = ex2(st[i + 1] * a.scale_log2 - L.y);
        if (edge) {
          const int kp = krow + 8 * ((i >> 1) & 1), qp = q0 + col;
          p0 = bwd_pair_live(a, qp, kp) ? p0 : 0.f;
          p1 = bwd_pair_live(a, qp + 1, kp) ? p1 : 0.f;
        }
        st[i] = p0;
        st[i + 1] = p1;
        if constexpr (WANT_DV) pa[i >> 1] = pack2(p0, p1);
      }
      if constexpr (WANT_DV) {
        // dV += P^T dO, dO read MN-major
        wgmma_fence();
        issue_rs<BWD_BQ, DV>(dv, pa, sGs, BWD_BQ);
        wgmma_commit();
      }
      if constexpr (WANT_DK) {
        // dP^T is done; dV's products may still run
        if constexpr (WANT_DV) wgmma_wait<1>();
        else wgmma_wait<0>();
        fence_regs(dpt);
        // dS^T = P^T (dP^T - D_i), rounded to bf16 as dK's A fragments
        uint32_t da[BWD_BQ / 4];
#pragma unroll
        for (int i = 0; i < BWD_BQ / 2; i += 2) {
          const int col = 8 * (i >> 2) + 2 * t4;
          const float2 Di = *reinterpret_cast<const float2*>(Ds + col);
          da[i >> 1] = pack2(st[i] * (dpt[i] - Di.x),
                             st[i + 1] * (dpt[i + 1] - Di.y));
        }
        // dK += dS^T Q, Q read MN-major
        wgmma_fence();
        issue_rs<BWD_BQ, DP>(dk, da, sQs, BWD_BQ);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(da);  // the product reads da until here
        fence_regs(dk);
      } else {
        wgmma_wait<0>();
      }
      if constexpr (WANT_DV) {
        fence_regs(pa);  // the product reads pa until here
        fence_regs(dv);
      }
    }
    // the stage goes back to the producer
    if (lane == 0) mbar_arrive(barE(s));
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kp = krow + 8 * hf;
    if (kp >= a.Sk) continue;
    if constexpr (WANT_DK) {
      bf16* dkr = a.dk + b * a.dks.b + hk * a.dks.h + kp * a.dks.s;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col < a.D)
          *reinterpret_cast<__nv_bfloat162*>(dkr + col) =
              __floats2bfloat162_rn(dk[4 * j + 2 * hf] * a.scale,
                                    dk[4 * j + 2 * hf + 1] * a.scale);
      }
    }
    if constexpr (WANT_DV) {
      bf16* dvr = a.dv + b * a.dvs.b + hk * a.dvs.h + kp * a.dvs.s;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col < a.Dv)
          *reinterpret_cast<__nv_bfloat162*>(dvr + col) =
              __floats2bfloat162_rn(dv[4 * j + 2 * hf],
                                    dv[4 * j + 2 * hf + 1]);
      }
    }
  }
}

// dQ: one block per (q head, batch, query tile of 128 queries; the last
// query tile, the heaviest under a causal mask, first). Consumer warpgroup
// wg owns queries q0 + 64 wg .. + 63; the producer streams the (K, V)
// tiles of BK keys that the block's queries see.
template <int DP, int DV>
__global__ void __launch_bounds__(FA3_THREADS, 1)
fa_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap gmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, BwdWgArgs a) {
  using Tl = BwdTile<DP, DV>;
  constexpr int NP = Tl::NP, NPV = Tl::NPV, BK = Tl::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sG = sQ + Tl::Q_BYTES;
  const uint32_t sK = sG + Tl::G_BYTES;                  // [BWD_STAGES]
  const uint32_t sV = sK + BWD_STAGES * Tl::KT_BYTES;   // [BWD_STAGES]
  const uint32_t bar = sQ + Tl::DQ_BAR;
  // barriers: Q and dO full; K full, V full and stage released [BWD_STAGES]
  const uint32_t barQ = bar;
  auto barK = [&](int s) { return bar + 8 * (1 + s); };
  auto barV = [&](int s) { return bar + 8 * (1 + BWD_STAGES + s); };
  auto barE = [&](int s) { return bar + 8 * (1 + 2 * BWD_STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / a.group;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BWD_BQD;
  const int pos_hi = min(q0 + BWD_BQD, a.Sq) - 1;
  int k_begin = 0, k_end = a.Sk;
  if (a.causal) k_end = min(a.Sk, pos_hi + 1);
  if (a.window >= 0) k_begin = max(0, q0 - a.window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(barK(s), 1);
      mbar_init(barV(s), 1);
      mbar_init(barE(s), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 4 * NWG && lane == 0) {
      mbar_expect_tx(barQ, Tl::Q_BYTES + Tl::G_BYTES);
      for (int p = 0; p < NP; ++p)
        tma_load_4d(sQ + p * BWD_BQD * PANEL_ROW, &qmap, barQ, 64 * p, q0, h,
                    b);
      for (int p = 0; p < NPV; ++p)
        tma_load_4d(sG + p * BWD_BQD * PANEL_ROW, &gmap, barQ, 64 * p, q0, h,
                    b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % BWD_STAGES;
        const int kt = k_begin + t * BK;
        if (t >= BWD_STAGES) mbar_wait(barE(s), ((t / BWD_STAGES) - 1) & 1);
        mbar_expect_tx(barK(s), Tl::KT_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load_4d(sK + s * Tl::KT_BYTES + p * BK * PANEL_ROW, &kmap,
                      barK(s), 64 * p, kt, hk, b);
        mbar_expect_tx(barV(s), Tl::VT_BYTES);
        for (int p = 0; p < NPV; ++p)
          tma_load_4d(sV + s * Tl::VT_BYTES + p * BK * PANEL_ROW, &vmap,
                      barV(s), 64 * p, kt, hk, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp >> 2, t4 = lane & 3;
  const int wpos_lo = q0 + 64 * wg, wpos_hi = wpos_lo + 63;
  const int qrow = wpos_lo + 16 * (warp & 3) + (lane >> 2);  // and qrow + 8
  float L[2], Di[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long long row =
        ((long long)b * a.Hq + h) * a.Sq_pad + qrow + 8 * hf;
    L[hf] = a.lse2[row];
    Di[hf] = a.delta[row];
  }
  const uint32_t sQw = sQ + wg * 64 * PANEL_ROW;
  const uint32_t sGw = sG + wg * 64 * PANEL_ROW;
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  mbar_wait(barQ, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % BWD_STAGES, phase = (t / BWD_STAGES) & 1;
    const int kt = k_begin + t * BK;
    // skipped where every pair is masked (or every query is past Sq),
    // masked only on tiles that cross a bound or the ragged end of Sk
    const bool skip = wpos_lo >= a.Sq || (a.causal && kt > wpos_hi) ||
                      (a.window >= 0 && wpos_lo - (kt + BK - 1) >= a.window);
    const bool edge = kt + BK > a.Sk || (a.causal && kt + BK - 1 > wpos_lo) ||
                      (a.window >= 0 && wpos_hi - kt >= a.window);
    mbar_wait(barK(s), phase);
    mbar_wait(barV(s), phase);
    if (!skip) {
      const uint32_t sKs = sK + s * Tl::KT_BYTES;
      const uint32_t sVs = sV + s * Tl::VT_BYTES;
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
      issue_ss<DP, BK>(sc, sQw, BWD_BQD, sKs, BK);
      wgmma_commit();
      issue_ss<DV, BK>(dp, sGw, BWD_BQD, sVs, BK);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      // P (float32) in place
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int hf = (i >> 1) & 1;
        float p = ex2(sc[i] * a.scale_log2 - L[hf]);
        if (edge) {
          const int kp = kt + 8 * (i >> 2) + 2 * t4 + (i & 1);
          p = kp < a.Sk && bwd_pair_live(a, qrow + 8 * hf, kp) ? p : 0.f;
        }
        sc[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P (dP - D_i), rounded to bf16 as the A fragments of dQ += dS K
      uint32_t da[BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        const int hf = i & 1;
        da[i] = pack2(sc[2 * i] * (dp[2 * i] - Di[hf]),
                      sc[2 * i + 1] * (dp[2 * i + 1] - Di[hf]));
      }
      wgmma_fence();
      issue_rs<BK, DP>(dq, da, sKs, BK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(da);
      fence_regs(dq);
    }
    if (lane == 0) mbar_arrive(barE(s));
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = qrow + 8 * hf;
    if (qp >= a.Sq) continue;
    bf16* dqr = a.dq + b * a.dqs.b + h * a.dqs.h + qp * a.dqs.s;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < a.D)
        *reinterpret_cast<__nv_bfloat162*>(dqr + col) = __floats2bfloat162_rn(
            dq[4 * j + 2 * hf] * a.scale, dq[4 * j + 2 * hf + 1] * a.scale);
    }
  }
}


template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int COLS>
int backward_f32(const BwdArgs& a, cudaStream_t stream) {
  const int ld = a.D + 1, ldv = a.Dv + 1, ldp = BT32 + 1;
  const size_t kv = sizeof(float) * (size_t)BT32 * (2 * ld + 2 * ldv);
  const size_t dkdv = kv + sizeof(float) * (2 * BT32 * ldp + 2 * BT32);
  const size_t dq = kv + sizeof(float) * BT32 * ldp;
  int err = set_smem(fa_bwd_dkdv_f32_kernel<COLS>, dkdv);
  if (err == 0) err = set_smem(fa_bwd_dq_f32_kernel<COLS>, dq);
  if (err != 0) return err;
  fa_bwd_dkdv_f32_kernel<COLS>
      <<<dim3((a.Sk + BT32 - 1) / BT32, a.Hkv, a.B), BWD32_THREADS, dkdv,
         stream>>>(a);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  fa_bwd_dq_f32_kernel<COLS>
      <<<dim3((a.Sq + BT32 - 1) / BT32, a.Hq, a.B), BWD32_THREADS, dq,
         stream>>>(a);
  return (int)cudaGetLastError();
}

// rows of the LSE and D_i scratch of one (batch, q head): Sq rounded up to
// whole query tiles of both passes
int bwd_rows(int Sq) { return (Sq + BWD_PAD - 1) / BWD_PAD * BWD_PAD; }

template <int G>
void launch_prep(const BwdArgs& a, int Sq_pad, float* lse2, float* delta,
                 cudaStream_t stream) {
  const long long rows = (long long)a.B * a.Hq * Sq_pad;
  const long long blocks = (rows + 256 / G - 1) / (256 / G);
  fa_bwd_prep_kernel<G><<<(unsigned)blocks, 256, 0, stream>>>(a, Sq_pad,
                                                              lse2, delta);
}

template <int DP, int DV, int PART>
int launch_dkdv(const CUtensorMap& qt, const CUtensorMap& gt,
                const CUtensorMap& kb, const CUtensorMap& vb,
                const BwdWgArgs& w, int B, int Hkv, int Sk,
                cudaStream_t stream) {
  using Tl = BwdTile<DP, DV>;
  const int err = set_smem(fa_bwd_dkdv_kernel<DP, DV, PART>, Tl::DKDV_SMEM);
  if (err != 0) return err;
  fa_bwd_dkdv_kernel<DP, DV, PART>
      <<<dim3(Hkv, B, (Sk + BWD_BKV - 1) / BWD_BKV), FA3_THREADS,
         Tl::DKDV_SMEM, stream>>>(qt, gt, kb, vb, w);
  return (int)cudaGetLastError();
}

template <int DP, int DV>
int backward_bf16(const BwdArgs& a, float* scratch, cudaStream_t stream) {
  using Tl = BwdTile<DP, DV>;
  const int Sq_pad = bwd_rows(a.Sq);
  float* lse2 = scratch;
  float* delta = scratch + (long long)a.B * a.Hq * Sq_pad;
  const int nvec = a.Dv / 8;  // 16-byte vectors of a row of O and dO
  if (nvec <= 2) launch_prep<2>(a, Sq_pad, lse2, delta, stream);
  else if (nvec <= 4) launch_prep<4>(a, Sq_pad, lse2, delta, stream);
  else if (nvec <= 8) launch_prep<8>(a, Sq_pad, lse2, delta, stream);
  else if (nvec <= 16) launch_prep<16>(a, Sq_pad, lse2, delta, stream);
  else launch_prep<32>(a, Sq_pad, lse2, delta, stream);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  // q and dO by 64-row tiles (dK/dV) and 128-row tiles (dQ); k and v by
  // the dK/dV block's 128 keys and the dQ pass's BK
  CUtensorMap qt, gt, kb, vb, qb, gb, kt, vt;
  const bool ok =
      make_map(&qt, a.q, a.D, a.Sq, a.Hq, a.B, a.qs, BWD_BQ, 1) &&
      make_map(&gt, a.g, a.Dv, a.Sq, a.Hq, a.B, a.gs, BWD_BQ, 1) &&
      make_map(&kb, a.k, a.D, a.Sk, a.Hkv, a.B, a.ks, BWD_BKV, 1) &&
      make_map(&vb, a.v, a.Dv, a.Sk, a.Hkv, a.B, a.vs, BWD_BKV, 1) &&
      make_map(&qb, a.q, a.D, a.Sq, a.Hq, a.B, a.qs, BWD_BQD, 1) &&
      make_map(&gb, a.g, a.Dv, a.Sq, a.Hq, a.B, a.gs, BWD_BQD, 1) &&
      make_map(&kt, a.k, a.D, a.Sk, a.Hkv, a.B, a.ks, Tl::BK, 1) &&
      make_map(&vt, a.v, a.Dv, a.Sk, a.Hkv, a.B, a.vs, Tl::BK, 1);
  if (!ok) return (int)cudaErrorInvalidValue;
  BwdWgArgs w;
  w.lse2 = lse2;
  w.delta = delta;
  w.dq = static_cast<bf16*>(a.dq);
  w.dk = static_cast<bf16*>(a.dk);
  w.dv = static_cast<bf16*>(a.dv);
  w.dqs = a.dqs;
  w.dks = a.dks;
  w.dvs = a.dvs;
  w.Hq = a.Hq;
  w.group = a.group;
  w.Sq = a.Sq;
  w.Sk = a.Sk;
  w.Sq_pad = Sq_pad;
  w.D = a.D;
  w.Dv = a.Dv;
  w.causal = a.causal;
  w.window = a.window;
  w.scale = a.scale;
  w.scale_log2 = a.scale * LOG2E;
  if constexpr (DP <= 128) {
    err = launch_dkdv<DP, DV, BWD_BOTH>(qt, gt, kb, vb, w, a.B, a.Hkv, a.Sk,
                                        stream);
  } else {  // dK and dV a pass each (registers: see BWD_BOTH)
    err = launch_dkdv<DP, DV, BWD_DK>(qt, gt, kb, vb, w, a.B, a.Hkv, a.Sk,
                                      stream);
    if (err == 0)
      err = launch_dkdv<DP, DV, BWD_DV>(qt, gt, kb, vb, w, a.B, a.Hkv, a.Sk,
                                        stream);
  }
  if (err == 0) err = set_smem(fa_bwd_dq_kernel<DP, DV>, Tl::DQ_SMEM);
  if (err != 0) return err;
  fa_bwd_dq_kernel<DP, DV><<<dim3(a.Hq, a.B, Sq_pad / BWD_BQD), FA3_THREADS,
                             Tl::DQ_SMEM, stream>>>(qb, gb, kt, vt, w);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 tile of a head dim: 64, 128, 192 or 256 columns (a head dim
// between two runs in the wider tile with its columns past D zero, D = 80
// in the 128 tile).
int bf16_tile(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : d <= 192 ? 192 : 256;
}

// q, k: (B, Hq|Hkv, Sq|Sk, D), v: (B, Hkv, Sk, Dv), each with unit stride
// on its last axis and the given element strides on its other axes; o:
// (B, Hq, Sq, Dv) contiguous. window < 0 means no window. float32: D, Dv
// <= 256; bf16: D, Dv multiples of 8 up to 256 whose tiles are equal or
// (192, 128), 16-byte aligned bases and strides. lse_out: null, or a
// (B, Hq, Sq) float32 buffer that takes each row's natural-log sum of
// exponentials of the scaled logits (+inf for a row with no live key), which
// the backward pass reads. Returns cudaGetLastError() (cudaErrorInvalidValue
// for a shape it does not take).
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* o, int B,
    int Hq, int Hkv, int Sq, int Sk, int D, int Dv, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, int causal, int window,
    float scale, void* lse_out, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Sk <= 0 ||
      D <= 0 || D > 256 || Dv <= 0 || Dv > 256 || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
#define FA_ARGS q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, D, Dv, qs, ks, vs, causal, \
                window, scale, s
  if (dtype == DT_F32) {
    if (Dv <= 64) return attention_f32<8>(FA_ARGS);
    if (Dv <= 128) return attention_f32<16>(FA_ARGS);
    return attention_f32<32>(FA_ARGS);
  }
  if (dtype == DT_BF16 && D % 8 == 0 && Dv % 8 == 0) {
    const int dp = bf16_tile(D), dv = bf16_tile(Dv);
    if (dp == 64 && dv == 64) return attention_bf16<64, 64>(FA_ARGS);
    if (dp == 128 && dv == 128) return attention_bf16<128, 128>(FA_ARGS);
    if (dp == 192 && dv == 192) return attention_bf16<192, 192>(FA_ARGS);
    if (dp == 192 && dv == 128) return attention_bf16<192, 128>(FA_ARGS);
    if (dp == 256 && dv == 256) return attention_bf16<256, 256>(FA_ARGS);
  }
#undef FA_ARGS
  return (int)cudaErrorInvalidValue;
}

// q: (B, Hkv, G, D), k, v: (B, Hkv, S, D), o: (B, Hkv, G, D), all
// contiguous with 16-byte aligned bases and rows (D * element size a
// multiple of 16); valid: (S,) bytes (torch.bool); G <= 16, D <= 256.
// part: B * Hkv * splits * G * (D + 2) floats of scratch when splits > 1;
// split s covers slots [s * split_len, min(S, (s + 1) * split_len)).
// Returns cudaGetLastError().
extern "C" int flash_decode_launch(int dtype, const void* q, const void* k,
                                   const void* v, const void* valid, void* o,
                                   void* part, int B, int Hkv, int G, int S,
                                   int D, int splits, int split_len,
                                   float scale, void* stream) {
  const int esize = dtype == DT_F32 ? 4 : 2;
  if (B <= 0 || Hkv <= 0 || G <= 0 || G > 16 || S <= 0 || D <= 0 ||
      D > 256 || (D * esize) % 16 || B > 65535 || Hkv > 65535 ||
      splits <= 0 || split_len <= 0 ||
      (long long)splits * split_len < S || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  FdArgs a;
  a.valid = static_cast<const unsigned char*>(valid);
  a.o = o;
  const long long rows = (long long)B * Hkv * splits * G;
  a.part_acc = static_cast<float*>(part);
  a.part_ml = a.part_acc == nullptr ? nullptr : a.part_acc + rows * D;
  a.Hkv = Hkv;
  a.G = G;
  a.S = S;
  a.D = D;
  a.chunks = D * esize / 16;
  a.lps = 1;
  a.splits = splits;
  a.split_len = split_len;
  a.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return decode<float>(q, k, v, a, B, s);
  if (dtype == DT_BF16) return decode<__nv_bfloat16>(q, k, v, a, B, s);
  return (int)cudaErrorInvalidValue;
}

// Floats of the scratch that flash_attention_bwd_launch takes as `delta`:
// float32, D_i (B, Hq, Sq); bf16, the LSE in log2 units and D_i, each
// (B, Hq, Sq rounded up to 128), the rows both passes' tiles read.
extern "C" long long flash_attention_bwd_scratch(int dtype, int B, int Hq,
                                                 int Sq) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (dtype == DT_BF16) return 2LL * B * Hq * bwd_rows(Sq);
  return (long long)B * Hq * Sq;
}

// The backward of flash_attention_launch's call on (q, k, v) that wrote o
// and lse: dq, dk and dv in the input dtype. strides: 24 element strides,
// the (B, H, S) strides of q, k, v, o, dO, dq, dk, dv in that order, each
// with a unit stride on its last axis; delta: flash_attention_bwd_scratch
// floats. float32: D, Dv <= 192. bf16: D, Dv multiples of 8 up to 192 whose
// tiles are equal (64, 128, 192) or (192, 128); q, k, v and dO are read by
// TMA and o with 16-byte loads, so their bases and B, H and S strides must
// be multiples of 16 bytes. Three launches (four at the 192 tile: dK and dV
// a pass each); returns cudaGetLastError().
extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int D, int Dv,
    const long long* strides, int causal, int window, float scale,
    void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Sk <= 0 ||
      D <= 0 || D > 192 || Dv <= 0 || Dv > 192 || B > 65535 || Hq > 65535 ||
      strides == nullptr || Sq > 65535 * BWD_PAD || Sk > 65535 * BWD_BKV)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.g = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  Strides* st[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.gs, &a.dqs, &a.dks,
                    &a.dvs};
  for (int i = 0; i < 8; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.group = Hq / Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.Dv = Dv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    const long long rows = (long long)B * Hq * Sq;
    fa_bwd_delta_kernel<float><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(a);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const int cols = D > Dv ? D : Dv;
    if (cols <= 64) return backward_f32<8>(a, s);
    if (cols <= 128) return backward_f32<16>(a, s);
    return backward_f32<24>(a, s);
  }
  if (dtype == DT_BF16 && D % 8 == 0 && Dv % 8 == 0) {
    const int dp = bf16_tile(D), dv = bf16_tile(Dv);
    float* scratch = static_cast<float*>(delta);
    if (dp == 64 && dv == 64) return backward_bf16<64, 64>(a, scratch, s);
    if (dp == 128 && dv == 128) return backward_bf16<128, 128>(a, scratch, s);
    if (dp == 192 && dv == 192) return backward_bf16<192, 192>(a, scratch, s);
    if (dp == 192 && dv == 128) return backward_bf16<192, 128>(a, scratch, s);
  }
  return (int)cudaErrorInvalidValue;
}
