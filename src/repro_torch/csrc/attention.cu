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
// flash_attention, float32 (fa_f32_kernel). Bound by operations as the
// bf16 kernel is, so the products run on the tensor cores, in split TF32.
// One TF32 product keeps 11 bits of each operand: its relative error near
// 2^-11 per term passes into the logits and again into P . V, past the
// float32 tolerance (2e-4). So each operand is split once per load into
// hi = TF32(x) (cvt.rna's rounding) and lo = x - hi (the mma reads its
// high 19 bits), and every product is lo.hi + hi.lo + hi.hi in that order
// (lo.lo, under 2^-21, is dropped): about 21 bits, three mma.sync.m16n8k8
// for each float32 product (the route of the CUTLASS kernel behind SDPA's
// float32 backend). A NaN or an infinity in an operand makes its lo a
// NaN, so the products keep it. No TMA or wgmma: they take no split
// operand. Measured on the
// H100, the kernels are bound by the mma.sync issue rate and by the
// instructions around it, so the design keeps those few:
//   * one block of four warps per (query tile of 64, q head, batch), the
//     heaviest causal tiles first; a warp takes 16 query rows;
//   * q, k and v in a tile of DP = 64, 128, 192 or 256 columns (the larger
//     head dim's, zero past D and Dv), so that every stride and loop bound
//     is known at compile time and the k-steps unroll;
//   * K and V tiles of 64 keys (32 past DP = 64: shared memory) in two
//     stages of cp.async copies (16 bytes where the strides allow, 4
//     otherwise, zero past S and D), so the next tile flies while this
//     one is computed; rows are padded to 4 times an odd number of words,
//     so that the fragment reads of both layouts (a row's columns t, t + 4;
//     a column's rows 2t, 2t + 1) hit 32 banks;
//   * the online softmax runs on the accumulator fragment with quad
//     shuffles, masks only on tiles that cross a bound; P stays float32
//     (as the Pallas kernel keeps it) and is the A operand of P . V from
//     the registers it was formed in, its k index permuted (t -> 2t,
//     t + 4 -> 2t + 1) with V's rows to match; expf, not ex2.approx.
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
//   * the partial mode (flash_decode_partial_launch, a sequence shard's
//     part of a sharded decode) runs the same two kernels and writes the
//     merged float32 (m, l, acc) instead of acc / l: m in natural-log
//     units (-1e30 where no slot was valid), l and acc unnormalized.
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

// ------------------------------ float32 on the tensor cores: split TF32
// Shared by the float32 forward and backward kernels.

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Row stride, in floats, of a shared tile of d columns (d a multiple of
// 8; the columns past the operand's own width are zero): d + 4. A stride of 4 times an odd number
// puts the 32 words of both fragment reads on 32 banks: the row read of
// lanes (g, t) at (row g, column t) and the column read at (row 2t,
// column g).
__host__ __device__ constexpr int f32_ld(int d) { return (d + 7) / 8 * 8 + 4; }

// Rows [r0, r0 + rows) of an (S, D) matrix (row stride rs elements, unit
// column stride) into a shared tile of DP columns (D <= DP, a multiple of
// 8; row stride f32_ld(DP)) by cp.async: 16-byte copies where `vec`
// (D % 4 == 0, base and stride on 16 bytes), 4-byte ones otherwise; zero
// past D and past S.
__device__ __forceinline__ void f32_tile(float* dst, int DP,
                                         const float* src, long long rs,
                                         int r0, int rows, int S, int D,
                                         bool vec, int tid, int nthreads) {
  const int ld = f32_ld(DP);
  const uint32_t base = smem_u32(dst);
  // the thread's copies walk the tile in steps of nthreads chunks: row r,
  // chunk c, advanced by (dr, dc) without a division a copy
  const int w = vec ? 4 : 1, cpr = DP / w;
  int r = tid / cpr, c = tid - r * cpr;
  const int dr = nthreads / cpr, dc = nthreads - dr * cpr;
  for (; r < rows; r += dr) {
    const int col = c * w;
    const bool ok = r0 + r < S && col < D;
    const float* from = ok ? src + (long long)(r0 + r) * rs + col : src;
    if (vec)
      cp_async16(base + 4 * (r * ld + col), from, ok ? 16 : 0);
    else
      cp_async4(base + 4 * (r * ld + col), from, ok ? 4 : 0);
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

// `rows` floats of a row vector (the LSE, D_i) from src[r0 ...], zero past S
__device__ __forceinline__ void f32_row(float* dst, const float* src, int r0,
                                        int rows, int S, int tid,
                                        int nthreads) {
  const uint32_t base = smem_u32(dst);
  for (int r = tid; r < rows; r += nthreads) {
    const bool ok = r0 + r < S;
    cp_async4(base + 4 * r, ok ? src + r0 + r : src, ok ? 4 : 0);
  }
}

// The float32 products' terms: 3 (lo.hi + hi.lo + hi.hi, the kernels as
// built), or 1 (hi.hi alone: one TF32 product, a lower-precision control
// that chip_smoke.py --f32-terms 1 builds to show the holds fail it).
#ifndef FA_F32_TERMS
#define FA_F32_TERMS 3
#endif
static_assert(FA_F32_TERMS == 1 || FA_F32_TERMS == 3, "FA_F32_TERMS: 1 or 3");

// x = hi + lo: hi = TF32(x) rounded to nearest, ties away from zero (the
// bits of cvt.rna.tf32.f32 for every x but a NaN, as two integer
// operations: the conversion instruction made the kernels slower on the
// H100; ptxas drops the mask where an mma reads hi, as it ignores the 13
// low bits), and lo = x - hi in float32, exact, of which the mma reads the
// high 19 bits (truncation, as CUTLASS's fast float32 takes its small
// part): about 21 bits of x's 24. A NaN's hi may be any value (the carry
// out of its mantissa), but x - hi is then the card's canonical NaN, whose
// high bits are a NaN too, and so is lo for an infinite x; every product
// with such an x takes its lo and is a NaN (float32's is a NaN or, for an
// infinite x, an infinity).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// an m16n8k8 A fragment (a[0..3]: rows g, g + 8, g, g + 8; columns t, t,
// t + 4, t + 4) and B fragment (b[0..1]: rows t, t + 4; column g), each
// split in two
struct SplitA {
  uint32_t hi[4], lo[4];
};
struct SplitB {
  uint32_t hi[2], lo[2];
};

// d += a . b: one TF32 product with float32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of rows g, g + 8 and columns k0 + t, k0 + t + 4 of a
// shared tile (the row read): p = the tile + g ld + t.
__device__ __forceinline__ void load_a(SplitA& a, const float* p, int ld,
                                       int k0) {
  split_tf32(p[k0], a.hi[0], a.lo[0]);
  split_tf32(p[8 * ld + k0], a.hi[1], a.lo[1]);
  split_tf32(p[k0 + 4], a.hi[2], a.lo[2]);
  split_tf32(p[8 * ld + k0 + 4], a.hi[3], a.lo[3]);
}

// The A fragment of an accumulator block c (rows g, g + 8; columns 2t,
// 2t + 1): its k index taken as t -> 2t and t + 4 -> 2t + 1, so that
// P and dS feed the next product from the registers they were formed in.
__device__ __forceinline__ void a_of_c(SplitA& a, const float (&c)[4]) {
  split_tf32(c[0], a.hi[0], a.lo[0]);
  split_tf32(c[2], a.hi[1], a.lo[1]);
  split_tf32(c[1], a.hi[2], a.lo[2]);
  split_tf32(c[3], a.hi[3], a.lo[3]);
}

// c (16 x 8 NT) = A . B^T over K columns (a multiple of 64, known at
// compile time, as are the strides, so the k-steps unroll), A's rows and
// B's rows read from shared tiles (a = A's tile + g lda + t for the warp's
// 16 rows; b = B's tile + g ldb + t, n-tile j at rows 8 j + g). Each
// product is lo.hi + hi.lo + hi.hi in that order. With one or two n-tiles
// the three go to accumulators of their own, so that more chains of
// dependent products are in flight, added at the end as
// (lo.hi + hi.lo) + hi.hi.
template <int NT>
__device__ __forceinline__ void mm_rows(float (&c)[NT][4], const float* a,
                                        int lda, const float* b, int ldb,
                                        int K) {
  constexpr int TS = NT <= 2 ? 3 : 1, MID = TS > 1 ? 1 : 0;
  float acc[TS][NT][4];
#pragma unroll
  for (int u = 0; u < TS; ++u)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    SplitA fa;
    load_a(fa, a, lda, k0);
    SplitB fb[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* p = b + j * 8 * ldb + k0;
      split_tf32(p[0], fb[j].hi[0], fb[j].lo[0]);
      split_tf32(p[4], fb[j].hi[1], fb[j].lo[1]);
    }
    if (FA_F32_TERMS == 3) {
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[0][j], fa.lo, fb[j].hi);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[MID][j], fa.hi, fb[j].lo);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[TS - 1][j], fa.hi, fb[j].hi);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[j][e] = TS > 1 ? (acc[0][j][e] + acc[MID][j][e]) + acc[TS - 1][j][e]
                       : acc[0][j][e];
}

// c (16 x 8 NT) += A . B, A from KS accumulator blocks (a_of_c: its
// k-step kk is a[kk]), B read down the columns of a shared tile: b = B's
// tile + 2t ldb + g (k-step kk at rows 8 kk + 2t and 8 kk + 2t + 1,
// n-tile j at column 8 j + g). Eight n-tiles' fragments are loaded before
// their products.
template <int NT, int KS>
__device__ __forceinline__ void mm_cols(float (&c)[NT][4],
                                        const float (&a)[KS][4],
                                        const float* b, int ldb) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    SplitA fa;
    a_of_c(fa, a[kk]);
    const float* bk = b + kk * 8 * ldb;
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += 8) {
      SplitB fb[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* p = bk + (j0 + u) * 8;
        split_tf32(p[0], fb[u].hi[0], fb[u].lo[0]);
        split_tf32(p[ldb], fb[u].hi[1], fb[u].lo[1]);
      }
      if (FA_F32_TERMS == 3) {
#pragma unroll
        for (int u = 0; u < 8; ++u) mma_tf32(c[j0 + u], fa.lo, fb[u].hi);
#pragma unroll
        for (int u = 0; u < 8; ++u) mma_tf32(c[j0 + u], fa.hi, fb[u].lo);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) mma_tf32(c[j0 + u], fa.hi, fb[u].hi);
    }
  }
}

// --------------------------------------- flash_attention, float32 (TF32)
constexpr int F32_WARPS = 4;                  // 16 query rows a warp
constexpr int F32_THREADS = 32 * F32_WARPS;
constexpr int F32_BQ = 16 * F32_WARPS;        // query rows a block

struct F32Args {
  const float *q, *k, *v;
  float* o;       // (B, Hq, Sq, Dv) contiguous
  float* lse;     // (B, Hq, Sq) natural-log LSE, or null (serving)
  Strides qs, ks, vs;
  int Hq, group, Sq, Sk, D, Dv, causal, window;
  int vq, vk, vv;  // q, k, v take 16-byte copies
  float scale;
};

// The online softmax of a tile of scores s (the thread's rows r0 and
// r0 + 8, its keys kt + 8 j + e of n-tile j) against the state m, l, o of
// those rows: P written over s. MASK: evaluate the masks (a tile that
// crosses a bound for some row of the warp).
template <bool MASK, int NT, int NV>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4],
                                               float (&o)[NV][4],
                                               float (&m)[2], float (&l)[2],
                                               const F32Args& a, int r0,
                                               int kt) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r0 + 8 * r;
    float mc = NEG_INF;
    uint32_t live = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = kt + 8 * j + e;
        bool ok = true;
        if (MASK) {
          ok = kpos < a.Sk;
          if (a.causal) ok = ok && qpos >= kpos;
          if (a.window >= 0) ok = ok && (qpos - kpos) < a.window;
        }
        const float x = ok ? s[j][2 * r + e] * a.scale : NEG_INF;
        s[j][2 * r + e] = x;
        live |= (uint32_t)ok << (2 * j + e);
        mc = fmaxf(mc, x);
      }
    // a row's columns are the four lanes of a quad
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
    const float m_new = fmaxf(m[r], mc);
    const float sub = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
    const float alpha = m[r] <= NEG_INF * 0.5f ? 0.f : expf(m[r] - sub);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = !MASK || (live >> (2 * j + e)) & 1u
                            ? expf(s[j][2 * r + e] - sub) : 0.f;
        s[j][2 * r + e] = p;
        rs += p;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[r] = l[r] * alpha + rs;
    m[r] = m_new;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      o[j][2 * r] *= alpha;
      o[j][2 * r + 1] *= alpha;
    }
  }
}

// The float32 forward's tile: DP columns of q, k and v (D and Dv <=
// DP, zero past them), BKT keys a step: 64 at DP = 64, else 32 (shared
// memory).
template <int DP> struct F32Tile {
  static constexpr int LD = f32_ld(DP);
  static constexpr int BKT = DP <= 64 ? 64 : 32;
  static constexpr int SMEM = 4 * (F32_BQ + 4 * BKT) * LD;   // bytes
};

template <int DP>
__global__ void __launch_bounds__(F32_THREADS)
fa_f32_kernel(F32Args a) {
  constexpr int LD = F32Tile<DP>::LD, BKT = F32Tile<DP>::BKT;
  constexpr int NT = BKT / 8, NV = DP / 8;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                    // F32_BQ x LD
  float* Ks = Qs + F32_BQ * LD;       // two stages of BKT x LD
  float* Vs = Ks + 2 * BKT * LD;      // two stages of BKT x LD
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the heaviest causal tiles launch first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * F32_BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.group;
  const float* qb = a.q + b * a.qs.b + h * a.qs.h;
  const float* kb = a.k + b * a.ks.b + hk * a.ks.h;
  const float* vb = a.v + b * a.vs.b + hk * a.vs.h;

  // the key tiles that can hold a live key for some row of this tile
  const int q_last = min(q0 + F32_BQ, a.Sq) - 1;
  int k_begin = 0, k_end = a.Sk;
  if (a.causal) k_end = min(a.Sk, q_last + 1);
  if (a.window >= 0) k_begin = max(0, q0 - a.window + 1);
  k_begin = k_begin / BKT * BKT;
  const int n = k_end > k_begin ? (k_end - k_begin + BKT - 1) / BKT : 0;

  auto load_kv = [&](int k0, int st) {
    f32_tile(Ks + st * BKT * LD, DP, kb, a.ks.s, k0, BKT, a.Sk, a.D, a.vk,
             tid, F32_THREADS);
    f32_tile(Vs + st * BKT * LD, DP, vb, a.vs.s, k0, BKT, a.Sk, a.Dv, a.vv,
             tid, F32_THREADS);
  };
  if (n > 0) {
    f32_tile(Qs, DP, qb, a.qs.s, q0, F32_BQ, a.Sq, a.D, a.vq, tid,
             F32_THREADS);
    load_kv(k_begin, 0);
  }
  cp_async_commit();

  float o[NV][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const int w0 = q0 + 16 * warp;     // the warp's first row
  const int r0 = w0 + g;             // the thread's rows r0, r0 + 8
  const float* qw = Qs + (16 * warp + g) * LD + t;

  for (int i = 0; i < n; ++i) {
    const int k0 = k_begin + i * BKT, st = i & 1;
    if (i + 1 < n) {   // the next tile flies meanwhile
      load_kv(k0 + BKT, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[NT][4];
    mm_rows<NT>(s, qw, LD, Ks + st * BKT * LD + g * LD + t, LD, DP);
    // masks only where the tile crosses a bound for some row of the warp
    const bool whole = k0 + BKT <= a.Sk &&
                       (!a.causal || w0 >= k0 + BKT - 1) &&
                       (a.window < 0 || w0 + 15 - k0 < a.window);
    if (whole)
      online_softmax<false>(s, o, m, l, a, r0, k0 + 2 * t);
    else
      online_softmax<true>(s, o, m, l, a, r0, k0 + 2 * t);
    // O += P . V, P float32 from the registers it was formed in
    mm_cols<NV, NT>(o, s, Vs + st * BKT * LD + 2 * t * LD + g, LD);
    __syncthreads();   // the stage is refilled by the next iteration
  }

  float* ob = a.o + ((long long)b * a.Hq + h) * (long long)a.Sq * a.Dv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= a.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (a.lse != nullptr && t == 0)
      a.lse[((long long)b * a.Hq + h) * a.Sq + row] =
          l[r] > 0.f ? m[r] + logf(l[r]) : __int_as_float(0x7f800000);
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (col < a.Dv)
          ob[(long long)row * a.Dv + col] = o[j][2 * r + e] / denom;
      }
  }
}

// The float32 kernels' tile of head dims up to d: 64, 128, 192 or 256
// columns (D = 80 runs in the 128 tile, its columns past 80 zero).
int f32_tile_of(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : d <= 192 ? 192 : 256;
}

// whether a float32 (B, H, S, d) operand takes 16-byte copies
bool f32_vec(const void* p, const Strides& s, int d) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 &&
         s.h % 4 == 0 && s.s % 4 == 0 && d % 4 == 0;
}

template <int DP>
int attention_f32(const F32Args& a, int B, cudaStream_t stream) {
  constexpr int smem = F32Tile<DP>::SMEM;
  const int err = set_smem(fa_f32_kernel<DP>, smem);
  if (err != 0) return err;
  const dim3 grid((a.Sq + F32_BQ - 1) / F32_BQ, a.Hq, B);
  fa_f32_kernel<DP><<<grid, F32_THREADS, smem, stream>>>(a);
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
  void* o;                     // (B, Hkv, G, D), the normalized output
  float* out_acc;              // (B, Hkv, G, D), partial mode (o unused)
  float* out_ml;               // (B, Hkv, G, 2): m (natural log), l
  float* part_acc;             // (B, Hkv, splits, G, D), splits > 1
  float* part_ml;              // (B, Hkv, splits, G, 2): m, l
  int Hkv, G, S, D;
  int chunks;     // 16-byte chunks per row
  int lps;        // lanes per slot (a power of two, <= 32)
  int splits, split_len;
  float scale_log2;  // sm_scale * log2(e): m and the logits in log2 units
};

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

// element idx (row g = idx / D) of a (b, kv head)'s merged state (M in
// log2 units, L, A): acc / l, or in the partial mode (m, l, acc)
template <typename T>
__device__ __forceinline__ void fd_store(const FdArgs& a, long long bh,
                                         int idx, int g, float M, float L,
                                         float A) {
  if (a.out_acc == nullptr) {
    static_cast<T*>(a.o)[bh * a.G * a.D + idx] =
        from_f32<T>(A / fmaxf(L, 1e-30f));
    return;
  }
  a.out_acc[bh * a.G * a.D + idx] = A;
  if (idx == g * a.D) {
    const long long row = bh * a.G + g;
    a.out_ml[row * 2] = M <= NEG_INF * 0.5f ? NEG_INF : M * LN2;
    a.out_ml[row * 2 + 1] = L;
  }
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
      fd_store<T>(a, bh, idx, g, M, L, A);
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
    fd_store<T>(a, bh, idx, g, M, L, A);
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
// bf16 (fa_bwd_dkdv_kernel<DP, DV>, fa_bwd_dq_kernel<DP, DV>): q/k
// tiles of DP = 64, 128 or 192 columns, v and dO tiles of DV = DP or MLA's
// (192, 128), each operand sized on its own; bound by operations
// (seven products of 2 Sq Sk D flops a head, halved when causal), so every
// product is wgmma, in the shape of fa_wgmma_kernel (FlashAttention-3):
//   * a producer warpgroup (one thread issuing TMA loads, registers handed
//     over with setmaxnreg) and two consumer warpgroups of 64 rows each;
//   * dK/dV: the block's keys of K and V are loaded once; a two-stage
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
//   * at DP = 192 a warpgroup cannot hold both accumulators of its keys
//     (160-192 registers a thread beside S^T and dP^T, over setmaxnreg's
//     240), so a block takes 64 keys and its two consumer warpgroups one
//     accumulator each: S^T, P^T and dV in one, dP^T, dS^T and dK in the
//     other, P^T handed over through shared memory (BwdSplit); three
//     launches a call at every tile;
//   * the heaviest causal tiles are launched first (key tile 0 for dK/dV,
//     the last query tile for dQ: the tile index is the grid's slowest
//     axis).
// P is rounded to bf16 for P^T dO, as the forward's P . V rounds it, and dS
// for its two products.
// float32 (fa_bwd_delta_kernel, fa_bwd_dkdv_f32_kernel,
// fa_bwd_dq_f32_kernel): the forward's split TF32 for all five products
// (S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q; dQ += dS K),
// P^T and dS^T float32 on the fragments, tiles of DP = 64, 128 or 192
// columns, eight warps a block:
//   * dK/dV: a block takes 16 NS keys of a kv head (NS = 4, 2 or 1 strips
//     of 16: four while the grid then holds 132 blocks, fewer for the small
//     grids, so that the longest block's walk shrinks); its four pairs of
//     warps take a strip each, or with fewer strips a share of each step's
//     queries. A pair's first warp forms P^T and adds P^T dO into dV, the
//     second dP^T and dS^T and adds dS^T Q into dK: one accumulator a warp
//     (96 registers at 192 columns), P^T handed over in shared memory under
//     a named barrier of the pair;
//   * dQ: a block takes 16 NS queries (NS = 4 or 2), a warp a strip and a
//     share of each step's keys, and forms S, dP, dS and dQ on its own.
//     It reads nothing the dK/dV pass writes, so it is a programmatic
//     dependent launch: under a causal mask the dK/dV blocks of the last
//     keys end early, and dQ blocks take their SMs (at the small grids the
//     two passes then take about the time of the longer); each dQ block
//     waits for the dK/dV grid before it ends, so the work after the call
//     sees both;
//   * (Q, dO) and (K, V) tiles fly in two cp.async stages as in the
//     forward; the shares' partial sums are added in a fixed order at the
//     end.

struct BwdArgs {
  const void *q, *k, *v, *o, *g;  // g: dO
  const float* lse;                // (B, Hq, Sq)
  float* delta;  // float32: D_i (B, Hq, Sq); bf16: the scratch of the
                 // LSE and D_i rows (flash_attention_bwd_scratch)
  void *dq, *dk, *dv;
  Strides qs, ks, vs, os, gs, dqs, dks, dvs;
  int B, Hq, Hkv, group, Sq, Sk, D, Dv, causal, window;
  int vq, vk, vv, vg;  // float32: q, k, v, dO take 16-byte copies
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

// ---- float32: split TF32 on the tensor cores
constexpr int BWD32_THREADS = 256;   // 8 warps

// The float32 backward's tile: DP columns of q, k, v and dO (D and Dv <=
// DP, zero past them, f32_tile_of), NS strips of 16 keys (dK/dV) or
// queries (dQ) a block; the dK/dV pass's queries a step (BQ) and the dQ
// pass's keys a step (BK): 64, but 32 at DP = 192 for dQ and for a dK/dV
// block of more than one strip (shared memory). Shared bytes:
// dK/dV, the block's K and V rows, the P^T exchange and two stages of
// (Q, dO, LSE, D_i), which the splits' partial sums reuse after the walk;
// dQ, the block's Q and dO rows with their LSE and D_i, then two stages of
// (K, V), reused likewise.
template <int DP, int NS> struct Bwd32 {
  static constexpr int LD = f32_ld(DP), NA = DP / 8;
  static constexpr int BQ = DP <= 128 || NS == 1 ? 64 : 32;
  static constexpr int BK = DP <= 128 ? 64 : 32;
  static constexpr int NQ = BQ * NS / 32;   // a dK/dV split's query n-tiles
  static constexpr int NK = BK * NS / 64;   // a dQ split's key n-tiles
  static constexpr int KV_STAGES = 2 * BQ * (2 * LD + 2);
  static constexpr int KV_RED = (4 / NS - 1) * 2 * NS * NA * 128;
  static constexpr int DKDV_SMEM =
      4 * (32 * NS * LD + 4 * NQ * 128 +
           (KV_STAGES > KV_RED ? KV_STAGES : KV_RED));
  static constexpr int Q_STAGES = 4 * BK * LD;
  static constexpr int Q_RED = (8 / NS - 1) * NS * NA * 128;
  static constexpr int DQ_SMEM =
      4 * (16 * NS * (2 * LD + 2) + (Q_STAGES > Q_RED ? Q_STAGES : Q_RED));
};

// whether no (query, key) pair of queries [q_lo, q_lo + nq) and keys
// [k_lo, k_lo + nk) is live (dead), and whether all are (whole)
__device__ __forceinline__ void bwd_block_live(const BwdArgs& a, int q_lo,
                                               int nq, int k_lo, int nk,
                                               bool& dead, bool& whole) {
  const int q_hi = min(q_lo + nq, a.Sq) - 1, k_hi = min(k_lo + nk, a.Sk) - 1;
  dead = q_lo >= a.Sq || k_lo >= a.Sk || (a.causal && q_hi < k_lo) ||
         (a.window >= 0 && q_lo - k_hi >= a.window);
  whole = q_lo + nq <= a.Sq && k_lo + nk <= a.Sk &&
          (!a.causal || q_lo >= k_lo + nk - 1) &&
          (a.window < 0 || q_lo + nq - 1 - k_lo < a.window);
}

// P^T = exp(S^T scale - LSE) on a dK/dV warp's block of S^T (its keys
// key0 and key0 + 8, its queries q0 + 8 j + e of n-tile j; lse at the
// block's query q0), written over x and to the exchange px. MASK: evaluate
// the masks.
template <bool MASK, int NQ>
__device__ __forceinline__ void f32_p_tile(float (&x)[NQ][4],
                                           const BwdArgs& a,
                                           const float* lse, int q0,
                                           int key0, float* px) {
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = 8 * j + (e & 1);
      const bool ok = !MASK || bwd_live(a, q0 + qi, key0 + 8 * (e >> 1));
      x[j][e] = ok ? expf(x[j][e] * a.scale - lse[qi]) : 0.f;
      px[(4 * j + e) * 32] = x[j][e];
    }
}

// dS = P (dP - D_i) on a dQ warp's blocks of S and dP (its queries q0 and
// q0 + 8 with their LSE and D_i, its keys k0 + 8 j + e of n-tile j),
// written over s. MASK: evaluate the masks.
template <bool MASK, int NK>
__device__ __forceinline__ void f32_ds_tile(float (&s)[NK][4],
                                            const float (&dp)[NK][4],
                                            const BwdArgs& a,
                                            const float (&L)[2],
                                            const float (&Di)[2], int q0,
                                            int k0) {
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const bool ok = !MASK || bwd_live(a, q0 + 8 * r, k0 + 8 * j + (e & 1));
      const float p = ok ? expf(s[j][e] * a.scale - L[r]) : 0.f;
      s[j][e] = p * (dp[j][e] - Di[r]);
    }
}

// dK and dV of 16 NS keys of one kv head. Eight warps in four pairs: pair
// p takes key strip p % NS (16 keys) and, of each step's BQ queries, the
// split p / NS (BQ NS / 4 of them). Its first warp forms S^T = K Q^T and
// P^T, hands P^T to the second through shared memory and adds P^T dO into
// dV; the second forms dP^T = V dO^T and dS^T = P^T (dP^T - D_i) and adds
// dS^T Q into dK. The walk goes over the group's query heads and the query
// tiles that see the block's keys; the splits' partial sums are added in
// split order at the end.
template <int DP, int NS>
__global__ void __launch_bounds__(BWD32_THREADS)
fa_bwd_dkdv_f32_kernel(BwdArgs a) {
  using T = Bwd32<DP, NS>;
  constexpr int BQ = T::BQ, SPLITS = 4 / NS, NQ = T::NQ, NA = T::NA;
  constexpr int LD = T::LD, STAGE = BQ * (2 * LD + 2);
  extern __shared__ __align__(16) float bsm[];
  float* Ks = bsm;                        // 16 NS x LD
  float* Vs = Ks + 16 * NS * LD;          // 16 NS x LD
  float* Px = Vs + 16 * NS * LD;          // P^T: 4 pairs x NQ x 4 x 32
  float* St = Px + 4 * NQ * 128;          // the stages
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int role = warp >> 2, pair = warp & 3;
  const int strip = pair % NS, split = pair / NS;
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * 16 * NS;
  // the dQ pass reads nothing this pass writes: its blocks may take the
  // SMs that this pass's short (causal) blocks leave
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const float* q = static_cast<const float*>(a.q);
  const float* gr = static_cast<const float*>(a.g);
  f32_tile(Ks, DP, static_cast<const float*>(a.k) + b * a.ks.b + hk * a.ks.h,
           a.ks.s, k0, 16 * NS, a.Sk, a.D, a.vk, tid, BWD32_THREADS);
  f32_tile(Vs, DP,
           static_cast<const float*>(a.v) + b * a.vs.b + hk * a.vs.h, a.vs.s,
           k0, 16 * NS, a.Sk, a.Dv, a.vv, tid, BWD32_THREADS);
  int q_begin, q_end;
  bwd_query_range(a, k0, 16 * NS, BQ, q_begin, q_end);
  const int nqt = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int n = a.group * nqt;
  // step i: query head hk group + i / nqt, query tile i % nqt
  auto load = [&](int i) {
    float* s = St + (i & 1) * STAGE;
    const int hh = i / nqt, q0 = q_begin + (i - hh * nqt) * BQ;
    const int h = hk * a.group + hh;
    const long long row = ((long long)b * a.Hq + h) * a.Sq;
    f32_tile(s, DP, q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, BQ, a.Sq, a.D,
             a.vq, tid, BWD32_THREADS);
    f32_tile(s + BQ * LD, DP, gr + b * a.gs.b + h * a.gs.h, a.gs.s, q0, BQ,
             a.Sq, a.Dv, a.vg, tid, BWD32_THREADS);
    f32_row(s + 2 * BQ * LD, a.lse + row, q0, BQ, a.Sq, tid,
            BWD32_THREADS);
    f32_row(s + BQ * (2 * LD + 1), a.delta + row, q0, BQ, a.Sq, tid,
            BWD32_THREADS);
  };
  if (n > 0) load(0);
  cp_async_commit();

  // dV (role 0) or dK (role 1) of the strip's keys
  float acc[NA][4];
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int kw = k0 + 16 * strip;         // the strip's first key
  const int qw = split * NQ * 8;          // the split's first query of a tile
  float* px = Px + pair * NQ * 128 + lane;
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      load(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = St + (i & 1) * STAGE;
    const float* Gt = Qt + BQ * LD;
    const float* Lt = Gt + BQ * LD;
    const float* Dt = Lt + BQ;
    const int hh = i / nqt, q0 = q_begin + (i - hh * nqt) * BQ;
    bool dead, whole;
    bwd_block_live(a, q0 + qw, NQ * 8, kw, 16, dead, whole);
    float x[NQ][4];
    if (role == 0) {
      if (!dead) {
        mm_rows<NQ>(x, Ks + (16 * strip + g) * LD + t, LD,
                    Qt + (qw + g) * LD + t, LD, DP);
        if (whole)
          f32_p_tile<false>(x, a, Lt + qw + 2 * t, q0 + qw + 2 * t, kw + g,
                            px);
        else
          f32_p_tile<true>(x, a, Lt + qw + 2 * t, q0 + qw + 2 * t, kw + g,
                           px);
      }
      named_arrive(1 + pair, 64);
      if (!dead)
        mm_cols<NA, NQ>(acc, x, Gt + (qw + 2 * t) * LD + g, LD);
    } else {
      if (!dead)
        mm_rows<NQ>(x, Vs + (16 * strip + g) * LD + t, LD,
                    Gt + (qw + g) * LD + t, LD, DP);
      named_sync(1 + pair, 64);
      if (!dead) {
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qw + 8 * j + 2 * t + (e & 1);
            x[j][e] = px[(4 * j + e) * 32] * (x[j][e] - Dt[qi]);
          }
        mm_cols<NA, NQ>(acc, x, Qt + (qw + 2 * t) * LD + g, LD);
      }
    }
    __syncthreads();   // the stage is refilled by the next iteration
  }
  cp_async_wait<0>();
  if (SPLITS > 1) {   // the splits' partial sums, added in split order
    float* red = St;
    const int slot = (role * NS + strip) * NA * 128 + lane;
    if (split > 0) {
      float* w = red + (split - 1) * 2 * NS * NA * 128 + slot;
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[(4 * j + e) * 32] = acc[j][e];
    }
    __syncthreads();
    if (split > 0) return;
#pragma unroll
    for (int s = 1; s < SPLITS; ++s) {
      const float* r = red + (s - 1) * 2 * NS * NA * 128 + slot;
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] += r[(4 * j + e) * 32];
    }
  }
  float* dst = static_cast<float*>(role ? a.dk : a.dv);
  const Strides& ds = role ? a.dks : a.dvs;
  dst += b * ds.b + hk * ds.h;
  const int width = role ? a.D : a.Dv;
  const float mul = role ? a.scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= a.Sk) continue;
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (col < width) dst[key * ds.s + col] = acc[j][2 * r + e] * mul;
      }
  }
}

// dQ of 16 NS queries of one query head. Eight warps: warp w takes query
// strip w % NS (16 rows) and, of each step's BK keys, the split w / NS
// (BK NS / 8 of them): S = Q K^T, dP = dO V^T, dS = P (dP - D_i) and
// dQ += dS K. The splits' partial sums are added in split order at the
// end.
template <int DP, int NS>
__global__ void __launch_bounds__(BWD32_THREADS)
fa_bwd_dq_f32_kernel(BwdArgs a) {
  using T = Bwd32<DP, NS>;
  constexpr int BK = T::BK, SPLITS = 8 / NS, NK = T::NK, NA = T::NA;
  constexpr int LD = T::LD, STAGE = 2 * BK * LD;
  extern __shared__ __align__(16) float bsm[];
  float* Qs = bsm;                        // 16 NS x LD
  float* Gs = Qs + 16 * NS * LD;          // 16 NS x LD
  float* Ls = Gs + 16 * NS * LD;          // 16 NS
  float* Ds = Ls + 16 * NS;               // 16 NS
  float* St = Ds + 16 * NS;               // the stages
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int strip = warp % NS, split = warp / NS;
  // the heaviest causal tiles (the last) launch first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 16 * NS;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / a.group;
  const long long row = ((long long)b * a.Hq + h) * a.Sq;
  f32_tile(Qs, DP, static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h,
           a.qs.s, q0, 16 * NS, a.Sq, a.D, a.vq, tid, BWD32_THREADS);
  f32_tile(Gs, DP, static_cast<const float*>(a.g) + b * a.gs.b + h * a.gs.h,
           a.gs.s, q0, 16 * NS, a.Sq, a.Dv, a.vg, tid, BWD32_THREADS);
  f32_row(Ls, a.lse + row, q0, 16 * NS, a.Sq, tid, BWD32_THREADS);
  f32_row(Ds, a.delta + row, q0, 16 * NS, a.Sq, tid, BWD32_THREADS);
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b + hk * a.vs.h;
  int k_begin, k_end;
  bwd_key_range(a, q0, 16 * NS, BK, k_begin, k_end);
  const int n = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  auto load = [&](int i) {
    float* s = St + (i & 1) * STAGE;
    const int kt = k_begin + i * BK;
    f32_tile(s, DP, kb, a.ks.s, kt, BK, a.Sk, a.D, a.vk, tid,
             BWD32_THREADS);
    f32_tile(s + BK * LD, DP, vb, a.vs.s, kt, BK, a.Sk, a.Dv, a.vv, tid,
             BWD32_THREADS);
  };
  if (n > 0) load(0);
  cp_async_commit();

  float acc[NA][4];
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int qw = q0 + 16 * strip;         // the strip's first query
  const int kw = split * NK * 8;          // the split's first key of a tile
  float L[2] = {0.f, 0.f}, Di[2] = {0.f, 0.f};
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      load(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        L[r] = Ls[16 * strip + g + 8 * r];
        Di[r] = Ds[16 * strip + g + 8 * r];
      }
    const float* Kt = St + (i & 1) * STAGE;
    const float* Vt = Kt + BK * LD;
    const int kt = k_begin + i * BK;
    bool dead, whole;
    bwd_block_live(a, qw, 16, kt + kw, NK * 8, dead, whole);
    if (!dead) {
      float s[NK][4], dp[NK][4];
      mm_rows<NK>(s, Qs + (16 * strip + g) * LD + t, LD,
                  Kt + (kw + g) * LD + t, LD, DP);
      mm_rows<NK>(dp, Gs + (16 * strip + g) * LD + t, LD,
                  Vt + (kw + g) * LD + t, LD, DP);
      if (whole)
        f32_ds_tile<false>(s, dp, a, L, Di, qw + g, kt + kw + 2 * t);
      else
        f32_ds_tile<true>(s, dp, a, L, Di, qw + g, kt + kw + 2 * t);
      mm_cols<NA, NK>(acc, s, Kt + (kw + 2 * t) * LD + g, LD);
    }
    __syncthreads();   // the stage is refilled by the next iteration
  }
  cp_async_wait<0>();
  // launched beside the dK/dV pass (programmatic dependent launch): this
  // block ends after that grid, so the work after the call sees both
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (SPLITS > 1) {   // the splits' partial sums, added in split order
    float* red = St;
    const int slot = strip * NA * 128 + lane;
    if (split > 0) {
      float* w = red + (split - 1) * NS * NA * 128 + slot;
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[(4 * j + e) * 32] = acc[j][e];
    }
    __syncthreads();
    if (split > 0) return;
#pragma unroll
    for (int s = 1; s < SPLITS; ++s) {
      const float* r = red + (s - 1) * NS * NA * 128 + slot;
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] += r[(4 * j + e) * 32];
    }
  }
  float* dq = static_cast<float*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qw + g + 8 * r;
    if (qpos >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (col < a.D)
          dq[qpos * a.dqs.s + col] = acc[j][2 * r + e] * a.scale;
      }
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

// How a dK/dV block splits its work. Up to DP = 128 each consumer
// warpgroup holds both accumulators of its own 64 keys (dk[DP / 2] and
// dv[DV / 2] a thread, 128 registers at DP 128), 128 keys a block. At DP =
// 192 the two would take 160-192 beside S^T and dP^T, over setmaxnreg's
// 240, so the two warpgroups share one strip of 64 keys (a block), one for
// each accumulator (SPLIT): warpgroup 0 forms S^T and P^T and accumulates
// dV += P^T dO; warpgroup 1 forms dP^T, reads P^T through shared memory
// (two buffers handed over by named barriers) and accumulates dK += dS^T
// Q. S^T is computed once; each thread holds 96 + 32 accumulators.
template <int DP> struct BwdSplit {
  static constexpr bool SPLIT = DP > 128;
  static constexpr int BKV = SPLIT ? 64 : BWD_BKV;  // keys a dK/dV block
};

// The tiles of the bf16 backward: q/k tile DP and v tile DV (equal, or
// MLA's (192, 128)), each a run of 64-column panels; q, k in NP panels,
// v and dO in NPV
template <int DP, int DV> struct BwdTile {
  static constexpr int NP = DP / 64, NPV = DV / 64;
  static constexpr bool SPLIT = BwdSplit<DP>::SPLIT;
  static constexpr int BKV = BwdSplit<DP>::BKV;
  // dK/dV: K and V of the block's keys, then the ring of (Q, dO) tiles,
  // then each stage's LSE and D_i rows, then (SPLIT) the two P^T buffers
  // of 128 threads x 32 floats
  static constexpr int K_BYTES = NP * BKV * PANEL_ROW;
  static constexpr int V_BYTES = NPV * BKV * PANEL_ROW;
  static constexpr int QT_BYTES = NP * BWD_BQ * PANEL_ROW;
  static constexpr int GT_BYTES = NPV * BWD_BQ * PANEL_ROW;
  static constexpr int DKDV_ROWS =
      K_BYTES + V_BYTES + BWD_STAGES * (QT_BYTES + GT_BYTES);
  static constexpr int XCH_BYTES = SPLIT ? 2 * 128 * (BWD_BQ / 2) * 4 : 0;
  static constexpr int DKDV_XCH = DKDV_ROWS + 2 * BWD_STAGES * BWD_BQ * 4;
  static constexpr int DKDV_BAR = DKDV_XCH + XCH_BYTES;
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

// named barriers of a SPLIT block's P^T hand-over (0 is __syncthreads):
// buffer i full (warpgroup 0 arrives, 1 waits), empty (the other way)
constexpr int BAR_XFULL = 1, BAR_XEMPTY = 3;

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

// A consumer warpgroup's walk over a dK/dV block's (Q, dO) tiles:
// body(q0, edge, Q tile, dO tile, LSE row, D_i row, n) for each tile that
// some key of [kw, kw + 63] sees (n: such tiles before it), masked only
// where the tile crosses the causal diagonal or the window's edge (queries
// past Sq have P = 0 from their +inf LSE; keys past Sk are not stored);
// each stage is handed back to the producer. Returns the tiles it took.
template <int QT, int GT, typename Body>
__device__ __forceinline__ int bwd_walk_q(const BwdWgArgs& a, int kw,
                                          int q_begin, int nq, int n_tiles,
                                          uint32_t sQ, uint32_t sG,
                                          const float* sL, const float* sD,
                                          uint32_t bar, int lane, Body body) {
  int n = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % BWD_STAGES, phase = (t / BWD_STAGES) & 1;
    const int q0 = q_begin + (t % nq) * BWD_BQ;
    const bool skip = kw >= a.Sk || (a.causal && q0 + 63 < kw) ||
                      (a.window >= 0 && q0 - (kw + 63) >= a.window);
    const bool edge = (a.causal && q0 < kw + 63) ||
                      (a.window >= 0 && q0 + 63 - kw >= a.window);
    mbar_wait(bar + 8 * (1 + s), phase);
    if (!skip)
      body(q0, edge, sQ + s * QT, sG + s * GT, sL + s * BWD_BQ,
           sD + s * BWD_BQ, n++);
    if (lane == 0) mbar_arrive(bar + 8 * (1 + BWD_STAGES + s));
  }
  return n;
}

// P^T of a 64 x 64 tile in place (float32) from S^T, and rounded to bf16 as
// dV's A fragments; krow: this thread's first key
__device__ __forceinline__ void bwd_p_tile(float (&st)[BWD_BQ / 2],
                                           uint32_t (&pa)[BWD_BQ / 4],
                                           const BwdWgArgs& a, const float* Ls,
                                           int q0, int krow, bool edge,
                                           int t4) {
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
    pa[i >> 1] = pack2(p0, p1);
  }
}

// rows krow and krow + 8 of an accumulator of the block's keys (dK or dV,
// `cols` live columns of COLS), times `scale`, into (B, Hkv, Sk, cols) rows
template <int COLS>
__device__ __forceinline__ void bwd_store_rows(const float (&acc)[COLS / 2],
                                               bf16* base, Strides st, int b,
                                               int hk, int krow, int Sk,
                                               int cols, float scale, int t4) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kp = krow + 8 * hf;
    if (kp >= Sk) continue;
    bf16* r = base + b * st.b + hk * st.h + kp * st.s;
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < cols)
        *reinterpret_cast<__nv_bfloat162*>(r + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * hf] * scale, acc[4 * j + 2 * hf + 1] * scale);
    }
  }
}

// dK and dV: one block per (kv head, batch, key tile of BKV keys; key tile
// 0, the heaviest under a causal mask, first); the producer streams the
// (Q, dO, LSE, D_i) tiles of the kv head's query heads, head by head, in
// query order. Up to DP = 128 consumer warpgroup wg owns keys k0 + 64 wg
// .. + 63 and both their accumulators; SPLIT (BwdSplit), both own the
// block's 64 keys, warpgroup 0 dV and warpgroup 1 dK.
template <int DP, int DV>
__global__ void __launch_bounds__(FA3_THREADS, 1)
fa_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap gmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, BwdWgArgs a) {
  using Tl = BwdTile<DP, DV>;
  constexpr int NP = Tl::NP, NPV = Tl::NPV, BKV = Tl::BKV;
  constexpr bool SPLIT = Tl::SPLIT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + Tl::K_BYTES;
  const uint32_t sQ = sV + Tl::V_BYTES;                  // [BWD_STAGES]
  const uint32_t sG = sQ + BWD_STAGES * Tl::QT_BYTES;   // [BWD_STAGES]
  float* sL = reinterpret_cast<float*>(smem + Tl::DKDV_ROWS);
  float* sD = sL + BWD_STAGES * BWD_BQ;
  // SPLIT: P^T's two buffers, element i of thread j at i * 128 + j
  float* sX = reinterpret_cast<float*>(smem + Tl::DKDV_XCH);
  const uint32_t bar = sK + Tl::DKDV_BAR;
  // barriers: K and V full; stage full [BWD_STAGES]; stage released
  const uint32_t barKV = bar;
  auto barF = [&](int s) { return bar + 8 * (1 + s); };
  auto barE = [&](int s) { return bar + 8 * (1 + BWD_STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;
  // the query tiles that some key of the block sees
  const int k_last = min(k0 + BKV, a.Sk) - 1;
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
        tma_load_4d(sK + p * BKV * PANEL_ROW, &kmap, barKV, 64 * p, k0, hk,
                    b);
      for (int p = 0; p < NPV; ++p)
        tma_load_4d(sV + p * BKV * PANEL_ROW, &vmap, barKV, 64 * p, k0, hk,
                    b);
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
  const int kw = SPLIT ? k0 : k0 + 64 * wg;  // this warpgroup's first key
  const int krow = kw + 16 * (warp & 3) + (lane >> 2);  // and krow + 8
  const uint32_t sKw = sK + (SPLIT ? 0 : wg * 64 * PANEL_ROW);
  const uint32_t sVw = sV + (SPLIT ? 0 : wg * 64 * PANEL_ROW);
  auto walk = [&](auto body) {
    return bwd_walk_q<Tl::QT_BYTES, Tl::GT_BYTES>(
        a, kw, q_begin, nq, n_tiles, sQ, sG, sL, sD, bar, lane, body);
  };
  mbar_wait(barKV, 0);
  if constexpr (SPLIT) {
    const int tid = threadIdx.x & 127;  // the same fragment in both
    if (wg == 0) {
      // S^T, P^T (handed over), dV += P^T dO
      float dv[DV / 2];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
      const int taken = walk([&](int q0, bool edge, uint32_t sQs, uint32_t sGs,
                             const float* Ls, const float*, int n) {
        float st[BWD_BQ / 2];
        wgmma_fence();
        issue_ss<DP, BWD_BQ>(st, sKw, BKV, sQs, BWD_BQ);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        uint32_t pa[BWD_BQ / 4];
        bwd_p_tile(st, pa, a, Ls, q0, krow, edge, t4);
        wgmma_fence();
        issue_rs<BWD_BQ, DV>(dv, pa, sGs, BWD_BQ);
        wgmma_commit();
        // while dV's products run: P^T into buffer n & 1, once warpgroup 1
        // has read what tile n - 2 left there
        float* xb = sX + (n & 1) * (BWD_BQ / 2) * 128;
        if (n >= 2) named_sync(BAR_XEMPTY + (n & 1), 256);
#pragma unroll
        for (int i = 0; i < BWD_BQ / 2; ++i) xb[i * 128 + tid] = st[i];
        __threadfence_block();
        named_arrive(BAR_XFULL + (n & 1), 256);
        wgmma_wait<0>();
        fence_regs(pa);  // the product reads pa until here
        fence_regs(dv);
      });
      // the hand-backs of the last two tiles
      for (int i = taken < 2 ? 0 : taken - 2; i < taken; ++i)
        named_sync(BAR_XEMPTY + (i & 1), 256);
      bwd_store_rows<DV>(dv, a.dv, a.dvs, b, hk, krow, a.Sk, a.Dv, 1.f, t4);
    } else {
      // dP^T, dS^T from the handed P^T, dK += dS^T Q
      float dk[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dk[i] = 0.f;
      walk([&](int, bool, uint32_t sQs, uint32_t sGs, const float*,
               const float* Ds, int n) {
        float dpt[BWD_BQ / 2];
        wgmma_fence();
        issue_ss<DV, BWD_BQ>(dpt, sVw, BKV, sGs, BWD_BQ);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dpt);
        const float* xb = sX + (n & 1) * (BWD_BQ / 2) * 128;
        named_sync(BAR_XFULL + (n & 1), 256);
        uint32_t da[BWD_BQ / 4];
#pragma unroll
        for (int i = 0; i < BWD_BQ / 2; i += 2) {
          const int col = 8 * (i >> 2) + 2 * t4;
          const float2 Di = *reinterpret_cast<const float2*>(Ds + col);
          da[i >> 1] = pack2(xb[i * 128 + tid] * (dpt[i] - Di.x),
                             xb[(i + 1) * 128 + tid] * (dpt[i + 1] - Di.y));
        }
        named_arrive(BAR_XEMPTY + (n & 1), 256);
        wgmma_fence();
        issue_rs<BWD_BQ, DP>(dk, da, sQs, BWD_BQ);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(da);  // the product reads da until here
        fence_regs(dk);
      });
      bwd_store_rows<DP>(dk, a.dk, a.dks, b, hk, krow, a.Sk, a.D, a.scale,
                         t4);
    }
  } else {
    float dk[DP / 2], dv[DV / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
    walk([&](int q0, bool edge, uint32_t sQs, uint32_t sGs, const float* Ls,
             const float* Ds, int) {
      // S^T = K Q^T and dP^T = V dO^T: two groups, S^T's first
      float st[BWD_BQ / 2], dpt[BWD_BQ / 2];
      wgmma_fence();
      issue_ss<DP, BWD_BQ>(st, sKw, BKV, sQs, BWD_BQ);
      wgmma_commit();
      issue_ss<DV, BWD_BQ>(dpt, sVw, BKV, sGs, BWD_BQ);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);
      uint32_t pa[BWD_BQ / 4];
      bwd_p_tile(st, pa, a, Ls, q0, krow, edge, t4);
      // dV += P^T dO, dO read MN-major
      wgmma_fence();
      issue_rs<BWD_BQ, DV>(dv, pa, sGs, BWD_BQ);
      wgmma_commit();
      // dP^T is done; dV's products may still run
      wgmma_wait<1>();
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
      fence_regs(pa);
      fence_regs(dv);
    });
    bwd_store_rows<DP>(dk, a.dk, a.dks, b, hk, krow, a.Sk, a.D, a.scale, t4);
    bwd_store_rows<DV>(dv, a.dv, a.dvs, b, hk, krow, a.Sk, a.Dv, 1.f, t4);
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
  float L[2] = {0.f, 0.f}, Di[2] = {0.f, 0.f};
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



// Blocks that fill the card's SMs once: a float32 pass takes four strips
// (64 keys or queries) a block where the grid then has at least this many
// blocks, else fewer. A fixed count, not the card's: the choice, and with
// it each sum's order, follows from the shape alone.
constexpr long long F32_FILL = 132;

template <int DP, int NS>
int dkdv_f32(const BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = Bwd32<DP, NS>::DKDV_SMEM;
  const int tiles = (a.Sk + 16 * NS - 1) / (16 * NS);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const int err = set_smem(fa_bwd_dkdv_f32_kernel<DP, NS>, smem);
  if (err != 0) return err;
  fa_bwd_dkdv_f32_kernel<DP, NS>
      <<<dim3(a.Hkv, a.B, tiles), BWD32_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DP, int NS>
int dq_f32(const BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = Bwd32<DP, NS>::DQ_SMEM;
  const int tiles = (a.Sq + 16 * NS - 1) / (16 * NS);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const int err = set_smem(fa_bwd_dq_f32_kernel<DP, NS>, smem);
  if (err != 0) return err;
  // a programmatic dependent launch: its blocks may start on SMs the dK/dV
  // pass leaves before that pass ends
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hq, a.B, tiles);
  cfg.blockDim = dim3(BWD32_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, fa_bwd_dq_f32_kernel<DP, NS>, a);
}

// blocks of `rows` rows per head, `per` rows a block
long long f32_blocks(const BwdArgs& a, int rows, int heads, int per) {
  return (long long)a.B * heads * ((rows + per - 1) / per);
}

// The dK/dV pass takes four strips a block where the grid then holds
// F32_FILL blocks, else two, else one; the dQ pass four, else two.
template <int DP>
int backward_f32(const BwdArgs& a, cudaStream_t stream) {
  int err;
  if (f32_blocks(a, a.Sk, a.Hkv, 64) >= F32_FILL)
    err = dkdv_f32<DP, 4>(a, stream);
  else if (f32_blocks(a, a.Sk, a.Hkv, 32) >= F32_FILL)
    err = dkdv_f32<DP, 2>(a, stream);
  else
    err = dkdv_f32<DP, 1>(a, stream);
  if (err != 0) return err;
  if (f32_blocks(a, a.Sq, a.Hq, 64) >= F32_FILL) return dq_f32<DP, 4>(a, stream);
  return dq_f32<DP, 2>(a, stream);
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

template <int DP, int DV>
int launch_dkdv(const CUtensorMap& qt, const CUtensorMap& gt,
                const CUtensorMap& kb, const CUtensorMap& vb,
                const BwdWgArgs& w, int B, int Hkv, int Sk,
                cudaStream_t stream) {
  using Tl = BwdTile<DP, DV>;
  const int err = set_smem(fa_bwd_dkdv_kernel<DP, DV>, Tl::DKDV_SMEM);
  if (err != 0) return err;
  fa_bwd_dkdv_kernel<DP, DV>
      <<<dim3(Hkv, B, (Sk + Tl::BKV - 1) / Tl::BKV), FA3_THREADS,
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
  // the dK/dV block's BKV keys and the dQ pass's BK
  CUtensorMap qt, gt, kb, vb, qb, gb, kt, vt;
  const bool ok =
      make_map(&qt, a.q, a.D, a.Sq, a.Hq, a.B, a.qs, BWD_BQ, 1) &&
      make_map(&gt, a.g, a.Dv, a.Sq, a.Hq, a.B, a.gs, BWD_BQ, 1) &&
      make_map(&kb, a.k, a.D, a.Sk, a.Hkv, a.B, a.ks, Tl::BKV, 1) &&
      make_map(&vb, a.v, a.Dv, a.Sk, a.Hkv, a.B, a.vs, Tl::BKV, 1) &&
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
  err = launch_dkdv<DP, DV>(qt, gt, kb, vb, w, a.B, a.Hkv, a.Sk, stream);
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
    F32Args f;
    f.q = static_cast<const float*>(q);
    f.k = static_cast<const float*>(k);
    f.v = static_cast<const float*>(v);
    f.o = static_cast<float*>(o);
    f.lse = lse;
    f.qs = qs;
    f.ks = ks;
    f.vs = vs;
    f.Hq = Hq;
    f.group = Hq / Hkv;
    f.Sq = Sq;
    f.Sk = Sk;
    f.D = D;
    f.Dv = Dv;
    f.causal = causal;
    f.window = window;
    f.vq = f32_vec(q, qs, D);
    f.vk = f32_vec(k, ks, D);
    f.vv = f32_vec(v, vs, Dv);
    f.scale = scale;
    switch (f32_tile_of(D > Dv ? D : Dv)) {
      case 64: return attention_f32<64>(f, B, s);
      case 128: return attention_f32<128>(f, B, s);
      case 192: return attention_f32<192>(f, B, s);
      default: return attention_f32<256>(f, B, s);
    }
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

// q: (B, Hkv, G, D), k, v: (B, Hkv, S, D), all contiguous with 16-byte
// aligned bases and rows (D * element size a multiple of 16); valid: (S,)
// bytes (torch.bool); G <= 16, D <= 256. part: B * Hkv * splits * G *
// (D + 2) floats of scratch when splits > 1; split s covers slots
// [s * split_len, min(S, (s + 1) * split_len)). Writes o (B, Hkv, G, D) in
// the input dtype, or, with o null, out_acc (B, Hkv, G, D) and out_ml
// (B, Hkv, G, 2) float32 (the partial mode). Returns cudaGetLastError().
static int flash_decode_run(int dtype, const void* q, const void* k,
                            const void* v, const void* valid, void* o,
                            float* out_acc, float* out_ml, void* part, int B,
                            int Hkv, int G, int S, int D, int splits,
                            int split_len, float scale, void* stream) {
  const int esize = dtype == DT_F32 ? 4 : 2;
  if (B <= 0 || Hkv <= 0 || G <= 0 || G > 16 || S <= 0 || D <= 0 ||
      D > 256 || (D * esize) % 16 || B > 65535 || Hkv > 65535 ||
      splits <= 0 || split_len <= 0 ||
      (long long)splits * split_len < S || (splits > 1 && part == nullptr) ||
      (o == nullptr && (out_acc == nullptr || out_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  FdArgs a;
  a.valid = static_cast<const unsigned char*>(valid);
  a.o = o;
  a.out_acc = o == nullptr ? out_acc : nullptr;
  a.out_ml = o == nullptr ? out_ml : nullptr;
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

// flash_decode_run writing the normalized o.
extern "C" int flash_decode_launch(int dtype, const void* q, const void* k,
                                   const void* v, const void* valid, void* o,
                                   void* part, int B, int Hkv, int G, int S,
                                   int D, int splits, int split_len,
                                   float scale, void* stream) {
  return flash_decode_run(dtype, q, k, v, valid, o, nullptr, nullptr, part,
                          B, Hkv, G, S, D, splits, split_len, scale, stream);
}

// The partial mode of flash_decode_launch: the same kernels over the same
// arguments, writing out_acc (B, Hkv, G, D) and out_ml (B, Hkv, G, 2)
// float32 (m in natural-log units, -1e30 for a row with no valid slot; l;
// acc unnormalized) instead of o.
extern "C" int flash_decode_partial_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* valid, float* out_acc, float* out_ml, void* part, int B,
    int Hkv, int G, int S, int D, int splits, int split_len, float scale,
    void* stream) {
  return flash_decode_run(dtype, q, k, v, valid, nullptr, out_acc, out_ml,
                          part, B, Hkv, G, S, D, splits, split_len, scale,
                          stream);
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
// be multiples of 16 bytes. Three launches (D_i, dK/dV, dQ); returns
// cudaGetLastError().
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
    a.vq = f32_vec(q, a.qs, D);
    a.vk = f32_vec(k, a.ks, D);
    a.vv = f32_vec(v, a.vs, Dv);
    a.vg = f32_vec(dout, a.gs, Dv);
    const long long rows = (long long)B * Hq * Sq;
    fa_bwd_delta_kernel<float><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(a);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    switch (f32_tile_of(D > Dv ? D : Dv)) {
      case 64: return backward_f32<64>(a, s);
      case 128: return backward_f32<128>(a, s);
      default: return backward_f32<192>(a, s);
    }
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
