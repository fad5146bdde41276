// Mamba2 SSD (state-space duality) chunked scan, split across the card, with
// its products on the tensor cores.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of the JAX package's
// src/repro/kernels/ssd_scan.py (`ssd_scan`). For each (batch b, head h)
// the sequence is cut into chunks of L = min(chunk, S) rows; with `cum` the
// inclusive cumsum of a = dt * A_h within a chunk:
//
//   y_t    = exp(cum_t) C_t . state + sum_{s<=t} (C_t . B_s)
//            exp(min(cum_t - cum_s, 0)) dt_s x_s + D_h x_t
//   state' = exp(cum_L) state + sum_s exp(cum_L - cum_s) dt_s x_s (x) B_s
//
// Head h reads B/C group h / (H / G). y is stored in x's dtype. Unlike the
// Pallas kernel, this one writes the (B, H, P, N) float32 state after the
// last token when the caller passes a buffer for it, takes any S (rows of
// the ragged last chunk past S load as dt = x = B = C = 0, which leaves the
// state unchanged, and their y is not stored), and reads x, B and C through
// their batch, sequence and head/group strides (unit stride on the last
// axis), so the model's B and C, views of one projection, pass as they are.
//
// What bounds it on the H100: at the serving path's short prompts, bytes,
// most of them the final state (32 KB per (b, h) against ~4 KB of inputs);
// at long S, operations: per chunk and head about L^2 N / 2 + L^2 P / 2 +
// 2 L N P multiply-adds, which want the tensor cores. The design:
//
// * The chunk walk is split across the card. Each (b, h) sequence is cut
//   into groups of consecutive chunks (kernels/autotune.py ssd_groups, a
//   function of the shape alone, so the order of every float sum is too):
//     pass 1 (ssd_pass1_kernel): each group but the last walks its chunks
//       from a zero state, keeping only the state update, and writes its end
//       state and its total decay (the product of its chunks' exp(cum_L));
//     pass 2 (ssd_pass2_kernel): per state element, the incoming state of
//       each group, in group order: in_{g+1} = decay_g in_g + end_g;
//     pass 3 (ssd_pass3_kernel): each group walks its chunks again from its
//       incoming state, writing y, and the last group the final state.
//   With one group passes 1 and 2 are skipped. Scratch is groups x P x N
//   float32 per sequence, not a state per chunk.
// * The serving path (many sequences, each one chunk from a zero state)
//   takes its own kernel (ssd_one_kernel): 264 blocks, two an SM, each
//   walking ~B H / 264 sequences in turn, so that one sequence's state
//   stores (its bound: 32 KB against ~4 KB of inputs) overlap the next
//   one's loads and products; C and B are staged once for the heads of a
//   batch row that share them.
// * One block of 8 warps per (b, group, h), heads fastest, so the blocks of
//   one (b, group) read the same B and C rows from L2. A chunk's C, B, x and
//   dt are staged in shared memory as bf16 (rows padded by 16 bytes so the
//   ldmatrix loads hit distinct banks) by cp.async into two buffers: the
//   next chunk's copies fly while this one is computed. The (P, N) state
//   lives in the warps' registers as float32, one strip of 16 x 64 per
//   warp, with a bf16 copy in shared memory for the product that reads all
//   of it. At L = 128 shared memory holds one such block an SM, so pass 3
//   may use 255 registers a thread, and spills none.
// * Every product is an mma.sync.m16n8k16 with bf16 operands and float32
//   accumulation: C . B^T (the scores), the decayed scores times x, C .
//   state^T and (x o w)^T . B. An operand that is float32 is split into
//   bf16 planes, v = p0 + p1 (+ p2), each plane the bf16 of what the ones
//   before it left, and a product takes the plane pairs (i, j) with
//   i + j <= ORDER (ROADMAP section 3 item 12):
//     bf16 instance: x, B, C are bf16 (one plane); the decayed scores, the
//       state and x o w take two planes (about 16 bits, a relative error
//       near 2^-17, where one bf16 rounding, 2^-9, would break the 5e-4
//       tolerance of the final state), ORDER 1: p0.q0 + p0.q1;
//     float32 instance: every operand takes three planes (24 bits, as
//       float32), ORDER 2: six products (p2.q2, p1.q2, p2.q1 dropped, each
//       under 2^-24). Its three planes would not fit a block's shared memory
//       at L = 128: the wrapper walks float32 in chunks of at most 64 rows
//       (the same sums, rounded apart).
// * The scores are built 64 columns at a time in registers (16 in the
//   one-chunk kernel), decayed and masked there, and fed as the A operand
//   of the next product without a trip through shared memory; the causal
//   half is skipped tile by tile. The state update scales x's rows by w in
//   its A fragment, which all n-tiles of a k-step share. Each k-step loads
//   all its fragments before its products, so their latencies overlap.
// * The chunk's cumsum is a warp scan: each lane sums a run of rows in
//   order, a fixed shuffle scan adds the runs' totals, each term rounded on
//   its own (no fused multiply-add), so two runs give the same bits.
// * At the first chunk from a zero state (every chunk of the serving path)
//   no product with the state is taken and nothing is decayed; the
//   one-chunk kernel has no code for a carried state and no room for its
//   bf16 copy. The final state goes from registers to memory in 16-byte
//   stores (lane pairs swap halves so that each lane holds four
//   neighbouring columns).
//
// Repeatability: no atomics; every sum has a fixed order (the mma's own,
// the chunk order, the group order), so two runs give the same bits.
//
// The file also holds the scan's backward (ssd_bwd_kernel and its
// launcher, ssd_scan_bwd_launch, at the end), which reuses passes 1 and 2.
#include <cstdint>

#include "dtype.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PLANES = 3;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 8;  // bf16 elements of padding per shared tile row
// columns (s) of the causal scores a warp holds in registers at a time:
// 64 where a block walks chunks with a state to carry (one block an SM at
// L = 128: shared memory holds no more), 16 in the one-chunk kernel (the
// serving path), whose smaller registers let two blocks share an SM
constexpr int SB_LONG = 64, SB_SHORT = 16;
// blocks of the one-chunk kernel: two on each of 132 SMs (the H100's; a
// constant, though here it fixes no sum's order: each sequence is one
// block's alone)
constexpr int ONE_BLOCKS = 2 * 132;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;
  void* y;
  float* state_out;  // nullptr: the caller does not want the final state
  float* ends;       // (B, H, groups - 1, P, N): end states, then incoming
  float* decays;     // (B, H, groups - 1)
  int B, S, H, P, G, N, L;
  int per_group, groups;
  int vec;  // 16-byte loads of x, B and C are aligned
  long long xs_b, xs_s, xs_h;  // strides of x, in elements (P: 1)
  long long ds_b, ds_s;        // strides of dt (H: 1)
  long long bs_b, bs_s, bs_g;  // strides of Bm (N: 1)
  long long cs_b, cs_s, cs_g;  // strides of Cm (N: 1)
};

__host__ __device__ inline int up16(int n) { return (n + 15) / 16 * 16; }

// bf16 planes of the inputs and of the operands formed in the kernel
template <typename T> struct Prec {
  static constexpr int IN = sizeof(T) == 4 ? 3 : 1;
  static constexpr int CMP = sizeof(T) == 4 ? 3 : 2;
  static constexpr int ORDER = sizeof(T) == 4 ? 2 : 1;
};

// Shared memory of one block, in bytes: `nbuf` buffers of the chunk's
// tiles (the bf16 planes of C (pass 3), B and x, `in` planes each, and dt
// per row), the state's `cmp` planes (pass 3 with a state to carry), and
// cum and w per row.
__host__ __device__ inline long long smem_bytes(bool pass3, int in, int cmp,
                                                bool carry, int nbuf, int L,
                                                int P, int N) {
  const long long LP = up16(L), ldn = up16(N) + PAD, ldp = up16(P) + PAD;
  // B, x, and dt with A_h and D_h after it
  long long b = 2LL * in * LP * (ldn + ldp) + 4 * (LP + 4);
  if (pass3) b += 2LL * in * LP * ldn;                 // C
  b *= nbuf;
  if (pass3 && carry) b += 2LL * cmp * up16(P) * ldn;
  return b + 2 * 4 * LP;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// D (16 x 8, float32) += A (16 x 16, bf16, row) . B (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 (or 4) bytes from global to shared memory, asynchronously; the bytes
// past src_bytes (0 or the size) are zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest `N` groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
// (x0, x1) as NP bf16x2 planes, each the bf16 of what the ones before it
// left, low half first
template <int NP>
__device__ __forceinline__ void split(float x0, float x1,
                                      uint32_t (&out)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    out[i] = pack(h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

// d0 (n-tile 0) and d1 (n-tile 1) += A . B over the plane pairs (i, j) with
// i + j <= ORDER; b[j] holds plane j of both n-tiles (r[0], r[1] and r[2],
// r[3] of an x4 load)
template <int NA, int NB, int ORDER>
__device__ __forceinline__ void mma_planes(float (&d0)[4], float (&d1)[4],
                                           const uint32_t (&a)[NA][4],
                                           const uint32_t (&b)[NB][4]) {
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (i + j <= ORDER) {
        mma(d0, a[i], b[j][0], b[j][1]);
        mma(d1, a[i], b[j][2], b[j][3]);
      }
}

// Fragment addresses (shared, bytes) of a bf16 tile with rows of `ld`
// elements. A operand (16 x 16) of a row-major tile at (m0, k0):
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int ld, int m0,
                                           int k0, int lane) {
  return base + 2u * ((m0 + (lane & 15)) * ld + k0 + 8 * (lane >> 4));
}
// A operand (16 x 16) at (m0, k0) of a tile stored k-major (row k, m
// contiguous), read with .trans:
__device__ __forceinline__ uint32_t at_addr(uint32_t base, int ld, int m0,
                                            int k0, int lane) {
  const int mi = lane >> 3;
  return base + 2u * ((k0 + (lane & 7) + 8 * (mi >> 1)) * ld + m0 +
                      8 * (mi & 1));
}
// B operands of two n-tiles (n0 and n0 + 8, k 16) of a tile stored n-major
// (row n, k contiguous): r[0], r[1] for n0 and r[2], r[3] for n0 + 8
__device__ __forceinline__ uint32_t bn_addr(uint32_t base, int ld, int n0,
                                            int k0, int lane) {
  const int mi = lane >> 3;
  return base + 2u * ((n0 + (lane & 7) + 8 * (mi >> 1)) * ld + k0 +
                      8 * (mi & 1));
}
// the same from a tile stored k-major (row k, n contiguous), with .trans
__device__ __forceinline__ uint32_t bk_addr(uint32_t base, int ld, int n0,
                                            int k0, int lane) {
  const int mi = lane >> 3;
  return base + 2u * ((k0 + (lane & 7) + 8 * (mi & 1)) * ld + n0 +
                      8 * (mi >> 1));
}

// The bf16 planes of one staged tile, `ld` elements a row
struct Planes {
  __nv_bfloat16* p[MAX_PLANES];
  int ld;
  __device__ uint32_t at(int i) const { return smem_u32(p[i]); }
};

// The planes' sum at (r, c) and (r, c + 1) (c even)
template <int NP>
__device__ __forceinline__ float2 sum_at(const Planes& t, int r, int c) {
  float2 v = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float2 u = unpack(*reinterpret_cast<const uint32_t*>(
        t.p[i] + r * t.ld + c));
    v.x += u.x;
    v.y += u.y;
  }
  return v;
}

// Rows [0, LP) x columns [0, up16(cols)) of a (rows, cols) input with row
// stride `rs` into the NP planes of `t`, zero past `rows` and `cols`.
template <typename T, int NP>
__device__ void stage(const Planes& t, const T* __restrict__ g,
                      long long rs, int rows, int LP, int cols, bool vec) {
  const int c8 = up16(cols) / 8;  // 8-column groups
  for (int i = threadIdx.x; i < LP * c8; i += THREADS) {
    const int r = i / c8, c = 8 * (i - r * c8);
    float v[8];
    const T* src = g + r * rs + c;
    if (r < rows && vec && c + 8 <= cols) {
      if constexpr (sizeof(T) == 2) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack(w[e]);
          v[2 * e] = f.x;
          v[2 * e + 1] = f.y;
        }
      } else {
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 b = *reinterpret_cast<const float4*>(src + 4);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (r < rows && c + e < cols) ? to_f32(src[e]) : 0.f;
    }
    uint32_t pl[4][NP];
#pragma unroll
    for (int e = 0; e < 4; ++e) split<NP>(v[2 * e], v[2 * e + 1], pl[e]);
#pragma unroll
    for (int i2 = 0; i2 < NP; ++i2)
      *reinterpret_cast<uint4*>(t.p[i2] + r * t.ld + c) =
          make_uint4(pl[0][i2], pl[1][i2], pl[2][i2], pl[3][i2]);
  }
}

// Everything one block knows about its sequence.
template <typename T>
struct Seq {
  const T* x;
  const float* dt;
  const T* Bg;
  const T* Cg;
  int h;
};

template <typename T>
__device__ Seq<T> seq_of(const Args& a, int b, int h) {
  const int grp = h / (a.H / a.G);
  Seq<T> s;
  s.x = static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h;
  s.dt = a.dt + b * a.ds_b + h;
  s.Bg = static_cast<const T*>(a.Bm) + b * a.bs_b + grp * a.bs_g;
  s.Cg = static_cast<const T*>(a.Cm) + b * a.cs_b + grp * a.cs_g;
  s.h = h;
  return s;
}

// From the staged dt of the chunk's rows (0 past S): its inclusive cumsum
// of dt * A as a warp scan (warp 0), and w_s = exp(cum_L - cum_s) dt_s.
// Starts and ends synced.
__device__ void chunk_decay(int LP, float Ah, const float* s_dt,
                            float* s_cum, float* s_w) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int run = (LP + 31) / 32;  // rows of each lane, in order
    const int r0 = lane * run, r1 = min(LP, r0 + run);
    float tot = 0.f;
    for (int t = r0; t < r1; ++t) tot = __fadd_rn(tot, __fmul_rn(s_dt[t], Ah));
    // inclusive scan of the lanes' totals, a fixed shuffle ladder
    float inc = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc = __fadd_rn(inc, o);
    }
    // the runs before this lane's, then its own rows in order
    float acc = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) acc = 0.f;
    for (int t = r0; t < r1; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(s_dt[t], Ah));
      s_cum[t] = acc;
    }
  }
  __syncthreads();
  const float last = s_cum[LP - 1];
  for (int t = threadIdx.x; t < LP; t += THREADS)
    s_w[t] = expf(last - s_cum[t]) * s_dt[t];
  __syncthreads();
}

// The warp's strip of the state: rows p0 .. p0 + 15, columns n0 .. n0 + 63
// (8 tiles of 8), float32 accumulator fragments.
struct Strip {
  int p0, n0;
  bool own;  // this warp owns a strip
};

__device__ __forceinline__ Strip strip_of(int warp, int P, int N) {
  const int nb = (up16(N) + 63) / 64;
  Strip s;
  s.p0 = 16 * (warp / nb);
  s.n0 = 64 * (warp % nb);
  s.own = s.p0 < up16(P);
  return s;
}

// state (strip) = decay * state + (x o w)^T . B over the chunk's rows;
// `fresh`: the state is zero, nothing to decay. sX, sB: staged tiles. The
// rows of x are scaled by w (and split) in the A fragment, which every
// n-tile of the k-step shares; B stays as staged.
template <typename T>
__device__ void update_state(float (&st)[8][4], const Strip& sp, bool fresh,
                             float decay, const Planes& sX, const Planes& sB,
                             const float* s_w, int LP, int NP, int lane) {
  using Pr = Prec<T>;
  if (!sp.own) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = fresh ? 0.f : st[j][e] * decay;
  const int c = lane & 3;
  for (int k0 = 0; k0 < LP; k0 += 16) {
    // every fragment of this k-step first, then the products
    uint32_t ax[Pr::IN][4], r[4][Pr::IN][4];
#pragma unroll
    for (int i = 0; i < Pr::IN; ++i)
      ldsm4t(ax[i], at_addr(sX.at(i), sX.ld, sp.p0, k0, lane));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (sp.n0 + 16 * jj < NP)
#pragma unroll
        for (int i = 0; i < Pr::IN; ++i)
          ldsm4t(r[jj][i], bk_addr(sB.at(i), sB.ld, sp.n0 + 16 * jj, k0,
                                   lane));
    // A fragment rows p, columns k: a0, a1 at k0 + 2c, +1; a2, a3 at
    // k0 + 8 + 2c, +1
    const float w0 = s_w[k0 + 2 * c], w1 = s_w[k0 + 2 * c + 1];
    const float w8 = s_w[k0 + 8 + 2 * c], w9 = s_w[k0 + 9 + 2 * c];
    uint32_t a[Pr::CMP][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 v = make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < Pr::IN; ++i) {
        const float2 u = unpack(ax[i][e]);
        v.x += u.x;
        v.y += u.y;
      }
      uint32_t pl[Pr::CMP];
      split<Pr::CMP>(v.x * (e < 2 ? w0 : w8), v.y * (e < 2 ? w1 : w9), pl);
#pragma unroll
      for (int i = 0; i < Pr::CMP; ++i) a[i][e] = pl[i];
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (sp.n0 + 16 * jj < NP)
        mma_planes<Pr::CMP, Pr::IN, Pr::ORDER>(st[2 * jj], st[2 * jj + 1], a,
                                               r[jj]);
  }
}

// The strip to or from a dense (P, N) float32 array in 16-byte accesses:
// lane pairs swap halves so each lane holds four neighbouring columns of
// one row (the even lane of row g, the odd one of row g + 8).
template <bool STORE>
__device__ void strip_io(float (&st)[8][4], const Strip& sp,
                         float* __restrict__ g, int P, int N, int lane) {
  if (!sp.own) return;
  if (!STORE) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;  // columns past N stay 0
  }
  const int gr = lane >> 2, c = lane & 3;
  const bool odd = c & 1;
  const int row = sp.p0 + gr + (odd ? 8 : 0);
  const bool vec = (N & 3) == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = sp.n0 + 8 * j + 2 * (c & ~1);
    if (sp.n0 + 8 * j >= N) break;
    float q[4];
    if (STORE) {
      // even lanes send their row-g+8 pair, odd lanes their row-g pair
      const float s0 =
          __shfl_xor_sync(0xffffffffu, odd ? st[j][0] : st[j][2], 1);
      const float s1 =
          __shfl_xor_sync(0xffffffffu, odd ? st[j][1] : st[j][3], 1);
      q[0] = odd ? s0 : st[j][0];
      q[1] = odd ? s1 : st[j][1];
      q[2] = odd ? st[j][2] : s0;
      q[3] = odd ? st[j][3] : s1;
      if (row < P) {
        if (vec && col + 4 <= N) {
          *reinterpret_cast<float4*>(g + (long long)row * N + col) =
              make_float4(q[0], q[1], q[2], q[3]);
        } else {
          for (int e = 0; e < 4; ++e)
            if (col + e < N) g[(long long)row * N + col + e] = q[e];
        }
      }
    } else {
      for (int e = 0; e < 4; ++e) q[e] = 0.f;
      if (row < P) {
        if (vec && col + 4 <= N) {
          const float4 v =
              *reinterpret_cast<const float4*>(g + (long long)row * N + col);
          q[0] = v.x; q[1] = v.y; q[2] = v.z; q[3] = v.w;
        } else {
          for (int e = 0; e < 4; ++e)
            if (col + e < N) q[e] = g[(long long)row * N + col + e];
        }
      }
      // back to the fragment: the even lane keeps row g, the odd row g + 8
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? q[0] : q[2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? q[1] : q[3], 1);
      if (odd) {
        st[j][0] = s0; st[j][1] = s1; st[j][2] = q[2]; st[j][3] = q[3];
      } else {
        st[j][0] = q[0]; st[j][1] = q[1]; st[j][2] = s0; st[j][3] = s1;
      }
    }
  }
}

// The strip's bf16 planes for C . state^T (rows p, columns n).
template <int NP>
__device__ void strip_planes(const float (&st)[8][4], const Strip& sp,
                             const Planes& sS, int NPad, int lane) {
  if (!sp.own) return;
  const int gr = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (sp.n0 + 8 * j >= NPad) break;
    const int col = sp.n0 + 8 * j + 2 * c;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t pl[NP];
      split<NP>(st[j][2 * hh], st[j][2 * hh + 1], pl);
      const int r = sp.p0 + gr + 8 * hh;
#pragma unroll
      for (int i = 0; i < NP; ++i)
        *reinterpret_cast<uint32_t*>(sS.p[i] + r * sS.ld + col) = pl[i];
    }
  }
}

// y of one strip (rows t0 .. t0 + 15, columns p0 .. p0 + 8 PT - 1) of the
// chunk:
// C . state^T decayed by exp(cum_t) (carry), the causal scores SBW columns
// at a time, decayed, masked and split in registers, times x, and D x.
template <typename T, int SBW, int PT, bool CARRY>
__device__ void y_strip(const Args& a, T* __restrict__ yc, int nv, int t0,
                        int p0, bool carry, const Planes& sC,
                        const Planes& sB, const Planes& sX, const Planes& sS,
                        const float* s_dt, const float* s_cum, float Dh,
                        int LP, int PP, int NP, int lane) {
  using Pr = Prec<T>;
  const int gr = lane >> 2, c = lane & 3;
  float acc[PT][4];
#pragma unroll
  for (int j = 0; j < PT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float cum0 = s_cum[t0 + gr], cum8 = s_cum[t0 + gr + 8];

  if (CARRY && carry) {
    // C . state^T over k = n; each k-step's fragments first
    for (int k0 = 0; k0 < NP; k0 += 16) {
      uint32_t ca[Pr::IN][4], r[PT / 2][Pr::CMP][4];
#pragma unroll
      for (int i = 0; i < Pr::IN; ++i)
        ldsm4(ca[i], a_addr(sC.at(i), sC.ld, t0, k0, lane));
#pragma unroll
      for (int jj = 0; jj < PT / 2; ++jj)
        if (p0 + 16 * jj < PP)
#pragma unroll
          for (int i = 0; i < Pr::CMP; ++i)
            ldsm4(r[jj][i], bn_addr(sS.at(i), sS.ld, p0 + 16 * jj, k0, lane));
#pragma unroll
      for (int jj = 0; jj < PT / 2; ++jj)
        if (p0 + 16 * jj < PP)
          mma_planes<Pr::IN, Pr::CMP, Pr::ORDER>(acc[2 * jj],
                                                 acc[2 * jj + 1], ca, r[jj]);
    }
    const float e0 = expf(cum0), e8 = expf(cum8);
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      acc[j][0] *= e0;
      acc[j][1] *= e0;
      acc[j][2] *= e8;
      acc[j][3] *= e8;
    }
  }

  // the causal scores, SBW columns (s) at a time
  constexpr int NS = SBW / 8;
  for (int sb = 0; sb < t0 + 16; sb += SBW) {
    const int ns = min(NS, (t0 + 16 - sb) / 8);  // n-tiles, s <= t0 + 15
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    for (int k0 = 0; k0 < NP; k0 += 16) {
      uint32_t ca[Pr::IN][4], r[NS / 2][Pr::IN][4];
#pragma unroll
      for (int i = 0; i < Pr::IN; ++i)
        ldsm4(ca[i], a_addr(sC.at(i), sC.ld, t0, k0, lane));
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj)
        if (2 * jj < ns)
#pragma unroll
          for (int i = 0; i < Pr::IN; ++i)
            ldsm4(r[jj][i], bn_addr(sB.at(i), sB.ld, sb + 16 * jj, k0, lane));
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj)
        if (2 * jj < ns)
          mma_planes<Pr::IN, Pr::IN, Pr::ORDER>(sc[2 * jj], sc[2 * jj + 1],
                                                ca, r[jj]);
    }
    // g[t, s] = (C_t . B_s) exp(min(cum_t - cum_s, 0)) dt_s for s <= t,
    // split into A fragments; then y += g . x over k = s
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      if (2 * kk >= ns) break;
      const int k0 = sb + 16 * kk;
      // x's fragments first: their loads overlap the scores' decay
      uint32_t rx[PT / 2][Pr::IN][4];
#pragma unroll
      for (int jj = 0; jj < PT / 2; ++jj)
        if (p0 + 16 * jj < PP)
#pragma unroll
          for (int i = 0; i < Pr::IN; ++i)
            ldsm4t(rx[jj][i], bk_addr(sX.at(i), sX.ld, p0 + 16 * jj, k0,
                                      lane));
      uint32_t ga[Pr::CMP][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kk + half;
        const int s = sb + 8 * j + 2 * c;
        const float cs0 = s_cum[s], cs1 = s_cum[s + 1];
        const float d0 = s_dt[s], d1 = s_dt[s + 1];
        float g4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + gr + 8 * (e >> 1);
          const int ss = s + (e & 1);
          const float ct = (e >> 1) ? cum8 : cum0;
          const float cs = (e & 1) ? cs1 : cs0;
          const float dts = (e & 1) ? d1 : d0;
          g4[e] = ss <= t ? sc[j][e] * expf(fminf(ct - cs, 0.f)) * dts : 0.f;
        }
        // a0/a1: k 0-7 (n-tile 2kk), a2/a3: k 8-15 (n-tile 2kk + 1)
        uint32_t lo[Pr::CMP], hi[Pr::CMP];
        split<Pr::CMP>(g4[0], g4[1], lo);
        split<Pr::CMP>(g4[2], g4[3], hi);
#pragma unroll
        for (int i = 0; i < Pr::CMP; ++i) {
          ga[i][2 * half] = lo[i];
          ga[i][2 * half + 1] = hi[i];
        }
      }
#pragma unroll
      for (int jj = 0; jj < PT / 2; ++jj)
        if (p0 + 16 * jj < PP)
          mma_planes<Pr::CMP, Pr::IN, Pr::ORDER>(acc[2 * jj],
                                                 acc[2 * jj + 1], ga, rx[jj]);
    }
  }

  // + D x; store the rows inside S
  const long long y_row = (long long)a.H * a.P;
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const int p = p0 + 8 * j + 2 * c;
    if (p0 + 8 * j >= PP) break;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + gr + 8 * hh;
      if (t >= nv || p >= a.P) continue;
      const float2 xv = sum_at<Pr::IN>(sX, t, p);
      const float v0 = acc[j][2 * hh] + Dh * xv.x;
      const float v1 = acc[j][2 * hh + 1] + Dh * xv.y;
      T* out = yc + t * y_row + p;
      if ((a.P & 1) == 0) {
        if constexpr (sizeof(T) == 2) {
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        }
      } else {
        out[0] = from_f32<T>(v0);
        if (p + 1 < a.P) out[1] = from_f32<T>(v1);
      }
    }
  }
}

// One buffer of a chunk's staged tiles; dt[LP] and dt[LP + 1] hold the
// sequence's A_h and D_h.
struct Buf {
  Planes C, B, X;
  float* dt;
};

// The shared tiles of a block, carved from dynamic shared memory in the
// order of smem_bytes: `nbuf` buffers, the state's planes, cum and w.
struct Tiles {
  Buf buf[2];
  Planes S;
  float *cum, *w;
};

template <typename T>
__device__ Tiles carve(unsigned char* smem, bool pass3, bool carry, int nbuf,
                       int L, int P, int N) {
  using Pr = Prec<T>;
  const int LP = up16(L), ldn = up16(N) + PAD, ldp = up16(P) + PAD;
  unsigned char* p = smem;
  auto take = [&](bool on, int rows, int ld, int planes) {
    Planes t;
    t.ld = ld;
    for (int i = 0; i < MAX_PLANES; ++i) {
      t.p[i] = (on && i < planes) ? reinterpret_cast<__nv_bfloat16*>(p)
                                  : nullptr;
      if (on && i < planes) p += 2 * rows * ld;
    }
    return t;
  };
  Tiles t;
  for (int b = 0; b < 2; ++b) {
    const bool on = b < nbuf;
    t.buf[b].B = take(on, LP, ldn, Pr::IN);
    t.buf[b].X = take(on, LP, ldp, Pr::IN);
    t.buf[b].C = take(on && pass3, LP, ldn, Pr::IN);
    t.buf[b].dt = reinterpret_cast<float*>(p);
    if (on) p += 4 * (LP + 4);
  }
  t.S = take(pass3 && carry, up16(P), ldn, Pr::CMP);
  t.cum = reinterpret_cast<float*>(p);
  t.w = t.cum + LP;
  return t;
}

// Asynchronous copies of a (rows, cols) bf16 input with row stride `rs`
// into rows [0, LP) x columns [0, up16(cols)) of a one-plane tile, zero
// past `rows` and `cols` (cols a multiple of 8, 16-byte aligned rows).
__device__ void stage_async(const Planes& t, const __nv_bfloat16* g,
                            long long rs, int rows, int LP, int cols) {
  const int c8 = up16(cols) / 8;
  const uint32_t base = t.at(0);
  for (int i = threadIdx.x; i < LP * c8; i += THREADS) {
    const int r = i / c8, c = 8 * (i - r * c8);
    const bool in = r < rows && c < cols;
    cp_async16(base + 2u * (r * t.ld + c), in ? g + r * rs + c : g,
               in ? 16 : 0);
  }
}

// Stage rows t0 .. t0 + nv - 1 of a sequence into `bf` (C and B where
// asked: a buffer that holds them for the same batch row and group is not
// staged again), with dt, A_h and D_h: with `async` (bf16 inputs read in
// 16-byte vectors) as copies the caller commits and waits for, else now,
// split into planes.
template <typename T>
__device__ void stage_chunk(const Args& a, const Seq<T>& sq, const Buf& bf,
                            int t0, int nv, bool with_c, bool with_b,
                            bool async) {
  const int LP = up16(a.L);
  if constexpr (sizeof(T) == 2) {
    if (async) {
      if (with_c)
        stage_async(bf.C, sq.Cg + t0 * a.cs_s, a.cs_s, nv, LP, a.N);
      if (with_b)
        stage_async(bf.B, sq.Bg + t0 * a.bs_s, a.bs_s, nv, LP, a.N);
      stage_async(bf.X, sq.x + t0 * a.xs_s, a.xs_s, nv, LP, a.P);
      const uint32_t d = smem_u32(bf.dt);
      const float* dt = sq.dt + t0 * a.ds_s;
      for (int t = threadIdx.x; t < LP; t += THREADS)
        cp_async4(d + 4u * t, t < nv ? dt + t * a.ds_s : dt, t < nv ? 4 : 0);
      if (threadIdx.x == 0) {
        cp_async4(d + 4u * LP, a.A + sq.h, 4);
        cp_async4(d + 4u * (LP + 1), a.D + sq.h, 4);
      }
      return;
    }
  }
  constexpr int IN = Prec<T>::IN;
  if (with_c)
    stage<T, IN>(bf.C, sq.Cg + t0 * a.cs_s, a.cs_s, nv, LP, a.N, a.vec);
  if (with_b)
    stage<T, IN>(bf.B, sq.Bg + t0 * a.bs_s, a.bs_s, nv, LP, a.N, a.vec);
  stage<T, IN>(bf.X, sq.x + t0 * a.xs_s, a.xs_s, nv, LP, a.P, a.vec);
  for (int t = threadIdx.x; t < LP; t += THREADS)
    bf.dt[t] = t < nv ? sq.dt[(t0 + t) * a.ds_s] : 0.f;
  if (threadIdx.x == 0) {
    bf.dt[LP] = a.A[sq.h];
    bf.dt[LP + 1] = a.D[sq.h];
  }
}

// Buffers of a block: two (the next chunk's copies in flight while this
// one is computed) where the staging is asynchronous, else one.
template <typename T>
__host__ __device__ inline int n_bufs(bool vec) {
  return sizeof(T) == 2 && vec ? 2 : 1;
}

// The walk of a block over n items (chunks of one sequence, or one-chunk
// sequences): item i's tiles staged by stage(i, buffer, async) (the next
// item's copies issued first where there are two buffers), synced, then
// body(i, buffer), then synced again.
template <typename T, typename Stage, typename Body>
__device__ void walk(const Args& a, const Tiles& tl, int n, Stage stage,
                     Body body) {
  const bool async = n_bufs<T>(a.vec) == 2;
  if (async) {
    stage(0, tl.buf[0], true);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    // (a select, not an index, keeps the tiles' pointers in registers)
    const Buf bf = async && (i & 1) ? tl.buf[1] : tl.buf[0];
    if (async) {
      if (i + 1 < n) stage(i + 1, i & 1 ? tl.buf[0] : tl.buf[1], true);
      cp_async_commit();
      cp_async_wait<1>();  // item i's copies, not the next item's
    } else {
      stage(i, bf, false);
    }
    __syncthreads();
    body(i, bf);
    __syncthreads();  // every warp is done with the buffer and the planes
  }
}

// Pass 1, one block per (b, group g < groups - 1, h): the group's chunks
// from a zero state, the state update alone; its end state and its total
// decay to scratch.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) ssd_pass1_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ng1 = a.groups - 1;
  const int h = blockIdx.x % a.H;
  const int g = (blockIdx.x / a.H) % ng1;
  const int b = blockIdx.x / (a.H * ng1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Seq<T> sq = seq_of<T>(a, b, h);
  const Tiles tl = carve<T>(smem, false, false, n_bufs<T>(a.vec), a.L, a.P,
                            a.N);
  const int LP = up16(a.L), NP = up16(a.N);
  const Strip sp = strip_of(warp, a.P, a.N);
  float* const cum = tl.cum;
  float* const w = tl.w;
  float st[8][4];
  float decay = 1.f;
  const int c0 = g * a.per_group, c1 = c0 + a.per_group;  // all inside S
  auto stage = [&](int i, const Buf& bf, bool async) {
    const int t0 = (c0 + i) * a.L;
    stage_chunk<T>(a, sq, bf, t0, min(a.L, a.S - t0), false, true, async);
  };
  walk<T>(a, tl, c1 - c0, stage, [&](int i, const Buf& bf) {
    chunk_decay(LP, bf.dt[LP], bf.dt, cum, w);
    const float dc = expf(cum[LP - 1]);
    update_state<T>(st, sp, i == 0, dc, bf.X, bf.B, w, LP, NP, lane);
    decay = i == 0 ? dc : decay * dc;
  });
  const long long slot = ((long long)b * a.H + h) * ng1 + g;
  strip_io<true>(st, sp, a.ends + slot * a.P * a.N, a.P, a.N, lane);
  if (threadIdx.x == 0) a.decays[slot] = decay;
}

// Pass 2: the incoming state of groups 1 .. groups - 1, per element, in
// group order, over the end states in place (slot g becomes the incoming
// state of group g + 1).
__global__ void __launch_bounds__(THREADS) ssd_pass2_kernel(Args a) {
  const long long PN = (long long)a.P * a.N;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)a.B * a.H * PN) return;
  const long long bh = i / PN, e = i - bh * PN;
  const int ng1 = a.groups - 1;
  float* ends = a.ends + bh * ng1 * PN + e;
  const float* dec = a.decays + bh * ng1;
  float run = ends[0];
  for (int g = 1; g < ng1; ++g) {
    run = fmaf(dec[g], run, ends[g * PN]);
    ends[g * PN] = run;
  }
}

// Pass 3, one block per (b, group, h): the group's chunks from its incoming
// state (zero for group 0), y of every row, and after the last group's last
// chunk the final state. Its strips of y are 64 columns wide.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1) ssd_pass3_kernel(Args a) {
  using Pr = Prec<T>;
  constexpr int PT = 8;  // 8-column tiles of a y strip
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x % a.H;
  const int g = (blockIdx.x / a.H) % a.groups;
  const int b = blockIdx.x / (a.H * a.groups);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Seq<T> sq = seq_of<T>(a, b, h);
  const int nc = (a.S + a.L - 1) / a.L;
  const int c0 = g * a.per_group, c1 = min(nc, c0 + a.per_group);
  const bool last = g == a.groups - 1;
  // a state to carry: an incoming one, or more than one chunk
  const bool carry = g > 0 || c1 - c0 > 1;
  const Tiles tl = carve<T>(smem, true, carry, n_bufs<T>(a.vec), a.L, a.P,
                            a.N);
  const int LP = up16(a.L), PP = up16(a.P), NP = up16(a.N);
  const Strip sp = strip_of(warp, a.P, a.N);
  float* const cum = tl.cum;
  float* const w = tl.w;
  float st[8][4];
  bool zero = g == 0;  // the state is still zero
  if (!zero) {
    const int ng1 = a.groups - 1;
    const long long slot = ((long long)b * a.H + h) * ng1 + g - 1;
    strip_io<false>(st, sp, a.ends + slot * a.P * a.N, a.P, a.N, lane);
    strip_planes<Pr::CMP>(st, sp, tl.S, NP, lane);
  }
  T* yb = static_cast<T*>(a.y) + (long long)b * a.S * a.H * a.P +
          (long long)h * a.P;
  const int nyb = (PP + 8 * PT - 1) / (8 * PT);  // column blocks of y
  bool planes = false;  // the state's planes are to be written
  auto stage = [&](int i, const Buf& bf, bool async) {
    const int t0 = (c0 + i) * a.L;
    stage_chunk<T>(a, sq, bf, t0, min(a.L, a.S - t0), true, true, async);
  };
  walk<T>(a, tl, c1 - c0, stage, [&](int i, const Buf& bf) {
    const int c = c0 + i, nv = min(a.L, a.S - c * a.L);
    chunk_decay(LP, bf.dt[LP], bf.dt, cum, w);
    if (planes) {
      // the previous chunk's state, for this one's C . state^T (its
      // readers of the old planes passed the walk's last sync)
      strip_planes<Pr::CMP>(st, sp, tl.S, NP, lane);
      __syncthreads();
    }
    T* yc = yb + (long long)c * a.L * a.H * a.P;
    for (int s = warp; s < (LP / 16) * nyb; s += WARPS)
      y_strip<T, SB_LONG, PT, true>(a, yc, nv, 16 * (s / nyb),
                                    8 * PT * (s % nyb), !zero, bf.C, bf.B,
                                    bf.X, tl.S, bf.dt, cum, bf.dt[LP + 1],
                                    LP, PP, NP, lane);
    planes = c + 1 < c1;
    if (planes || (last && a.state_out != nullptr)) {
      update_state<T>(st, sp, zero, expf(cum[LP - 1]), bf.X, bf.B, w,
                      LP, NP, lane);
      zero = false;
    }
  });
  if (last && a.state_out != nullptr)
    strip_io<true>(st, sp, a.state_out + ((long long)b * a.H + h) * a.P * a.N,
                   a.P, a.N, lane);
}

// The serving path: every sequence one chunk from a zero state (one group).
// Each block walks `per_block` of the B H sequences in turn (heads
// fastest), the next one's copies in flight while this one is computed,
// its y and final state stored as it goes, so that the stores of one
// overlap the loads and products of the next. No state is carried, so the
// kernel has no code for it; its strips of y are 16 columns wide (PT = 2
// tiles): a short chunk's y spreads over four warps, each holding a
// quarter of the accumulator.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) ssd_one_kernel(Args a) {
  constexpr int PT = 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * a.per_group;
  const int n = min(a.B * a.H - q0, a.per_group);
  const Tiles tl = carve<T>(smem, true, false, n_bufs<T>(a.vec), a.L, a.P,
                            a.N);
  const int LP = up16(a.L), PP = up16(a.P), NP = up16(a.N);
  const Strip sp = strip_of(warp, a.P, a.N);
  float* const cum = tl.cum;
  float* const w = tl.w;
  const int nyb = PP / (8 * PT);  // column blocks of y
  // (batch row, group) whose C and B each buffer holds, -1 for none
  int held[2] = {-1, -1};
  auto stage = [&](int i, const Buf& bf, bool async) {
    const int q = q0 + i, b = q / a.H, h = q % a.H;
    const int key = b * a.G + h / (a.H / a.G);
    int& hk = async && (i & 1) ? held[1] : held[0];
    stage_chunk<T>(a, seq_of<T>(a, b, h), bf, 0, a.S, hk != key, hk != key,
                   async);
    hk = key;
  };
  walk<T>(a, tl, n, stage, [&](int i, const Buf& bf) {
    const int q = q0 + i, b = q / a.H, h = q % a.H;
    const float Dh = bf.dt[LP + 1];
    chunk_decay(LP, bf.dt[LP], bf.dt, cum, w);
    T* yc = static_cast<T*>(a.y) + (long long)b * a.S * a.H * a.P +
            (long long)h * a.P;
    for (int s = warp; s < (LP / 16) * nyb; s += WARPS)
      y_strip<T, SB_SHORT, PT, false>(a, yc, a.S, 16 * (s / nyb),
                                      8 * PT * (s % nyb), false, bf.C, bf.B,
                                      bf.X, tl.S, bf.dt, cum, Dh, LP, PP,
                                      NP, lane);
    if (a.state_out != nullptr) {
      float st[8][4];
      update_state<T>(st, sp, true, 1.f, bf.X, bf.B, w, LP, NP, lane);
      strip_io<true>(st, sp, a.state_out + (long long)q * a.P * a.N, a.P,
                     a.N, lane);
    }
  });
}

template <typename Kernel>
cudaError_t fit_smem(Kernel* kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  using Pr = Prec<T>;
  const int nc = (a.S + a.L - 1) / a.L;
  const bool carry = a.groups > 1 || nc > 1;
  cudaError_t err;
  if (a.groups > 1) {
    const long long s1 = smem_bytes(false, Pr::IN, Pr::CMP, false,
                                    n_bufs<T>(a.vec), a.L, a.P, a.N);
    if ((err = fit_smem(ssd_pass1_kernel<T>, s1)) != cudaSuccess)
      return (int)err;
    ssd_pass1_kernel<T><<<(unsigned)(a.B * (a.groups - 1) * a.H), THREADS,
                          s1, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const long long n = (long long)a.B * a.H * a.P * a.N;
    if (a.groups > 2) {
      ssd_pass2_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                         stream>>>(a);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  const long long s3 = smem_bytes(true, Pr::IN, Pr::CMP, carry,
                                  n_bufs<T>(a.vec), a.L, a.P, a.N);
  if (!carry) {
    // one chunk per sequence: ONE_BLOCKS blocks (two an SM), each walking
    // its share of the sequences
    Args o = a;
    o.per_group = (a.B * a.H + ONE_BLOCKS - 1) / ONE_BLOCKS;
    const unsigned blocks = (unsigned)((a.B * a.H + o.per_group - 1) /
                                       o.per_group);
    if ((err = fit_smem(ssd_one_kernel<T>, s3)) != cudaSuccess) return (int)err;
    ssd_one_kernel<T><<<blocks, THREADS, s3, stream>>>(o);
  } else {
    if ((err = fit_smem(ssd_pass3_kernel<T>, s3)) != cudaSuccess)
      return (int)err;
    ssd_pass3_kernel<T><<<(unsigned)(a.B * a.groups * a.H), THREADS, s3,
                          stream>>>(a);
  }
  return (int)cudaGetLastError();
}


// ---- Backward
//
// The gradient jax.grad takes of the JAX package's XLA scan
// (src/repro/kernels/ops.py:130 _ssd_xla_chunked; the reference trains
// through it, its Pallas kernel has no VJP) for a cotangent dy of y (the
// final state has none): dx, ddt, dA, dB, dC, dD. The sequence is cut into
// chunks of L rows (the wrapper's choice, at most 64: a chunk's tiles and
// two L x L score matrices live in shared memory as float32). With S_c the
// state entering chunk c, cum the inclusive cumsum of a = dt A_h in it,
// e_ts = exp(min(cum_t - cum_s, 0)) and w_s = exp(cum_L - cum_s) dt_s, the
// chunks are walked in reverse carrying dS, the cotangent of the state
// leaving the chunk (zero after the last):
//
//   dS_c  = exp(cum_L) dS + sum_t exp(cum_t) dy_t (x) C_t
//   dx_s  = D dy_s + dt_s sum_{t>=s} (C_t.B_s) e_ts dy_t + w_s dS B_s
//   dB_s  = sum_{t>=s} e_ts dt_s (dy_t.x_s) C_t + w_s dS^T x_s
//   dC_t  = exp(cum_t) S_c^T dy_t + sum_{s<=t} e_ts dt_s (dy_t.x_s) B_s
//   dcum  gathers exp(cum_t) C_t.(S_c^T dy_t) at t; +G_ts f_ts at t and
//         -G_ts f_ts at s, G_ts = (C_t.B_s) e_ts dt_s (dy_t.x_s) on t >= s,
//         f_ts the clamp's gradient: 1 below 0, 0.5 at a tie (JAX's
//         jnp.minimum; the diagonal cancels), 0 above; exp(cum_L) <dS, S_c>
//         + sum_s w_s q_s at L and -w_s q_s at s, q_s = B_s.(dS^T x_s)
//   da_t  = sum_{u>=t} dcum_u within the chunk;
//   ddt_t = da_t A + sum_{u>=t} (C_u.B_t) e_ut (dy_u.x_t)
//           + exp(cum_L - cum_t) q_t,  dA = sum da_t dt_t,  dD = sum dy.x
//
// The reference clamps within its own chunks of Lf rows (the forward's),
// and L may be shorter. A pair of one backward chunk that lies in two
// forward chunks reaches y through the reference's state: its f_ts is 1,
// tie or not. A tied pair of one forward chunk that lies in two backward
// chunks reaches dcum through the kernel's state, with 1 in place of the
// clamp's 0.5: step 4 takes the other half back.
//
// dB and dC sum the H / G heads of each group, dA and dD batch and
// sequence. Four steps:
//   1. every chunk's incoming state S_c into a float32 scratch of
//      (B, H, nc - 1, P, N): the forward's ssd_pass1_kernel and
//      ssd_pass2_kernel with groups of one chunk (the state is recomputed,
//      not saved by the forward: 64 Mamba2 layers would hold 5.4 GB);
//   2. ssd_bwd_kernel, one block per (b, h) walking its chunks in reverse
//      with dS in shared memory: dx and ddt of its head, and its head's
//      share of dB and dC (per row) and of dA and dD;
//   3. with Lf > L, ssd_bwd_tie_kernel: the ties across a backward chunk
//      boundary inside a forward chunk, one block per (b, h);
//   4. ssd_bwd_reduce_kernel: the heads of each group and the batch, in
//      a fixed order.
// Products: float32 FMAs on the CUDA cores, not the forward's split bf16
// planes: a simple kernel first, with float32 sums that hold the plain
// version at 2e-4 in float32 with no plane bookkeeping; what bounds it is
// operations (per chunk about L^2 (N + P) + 2 L N (L + P) + L P (L + N) +
// L P N multiply-adds, ~4 M at L = 64, P = 64, N = 128), each read from
// shared memory. Step 1's states follow the forward's planes (~2^-17
// relative in bf16, float32 in float32). No atomics: every sum has a fixed
// order, so two runs give the same bits.
constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_TI = 8;  // rows a thread holds in a product (one per warp)
constexpr int BWD_MAX_L = 64;  // the chunk, at most, where Lf > L

// float32 words of the backward block's shared memory (row strides padded
// by one word so that a warp walking rows hits distinct banks)
__host__ __device__ inline long long bwd_smem_floats(int L, int P, int N) {
  return 2LL * P * (N + 1) + 2LL * L * (P + 1) + 2LL * L * (N + 1) +
         2LL * L * (L + 1) + 10LL * L + BWD_WARPS;
}

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;
  const void* dy;       // (B, S, H, P) dense, x's dtype
  const float* states;  // (B, H, nc - 1, P, N): S_c at c - 1
  void* dx;             // (B, S, H, P) dense, x's dtype
  float* ddt;           // (B, S, H) dense
  float* dbp;           // (B, S, H, N): each head's share of dB
  float* dcp;           // (B, S, H, N): and of dC
  float* part;          // (B, H, 2): each sequence's share of dA and dD
  int B, S, H, P, G, N, L;
  int Lf;               // the forward's chunk, min(chunk, S)
  long long xs_b, xs_s, xs_h, ds_b, ds_s, bs_b, bs_s, bs_g, cs_b, cs_s, cs_g;
};

// one operand pair of a product in shared memory: a(i, k) = a[i ai + k ak]
// (times ks[k] where ks is set), b(k, j) = b[k bk + j bj], k < K
struct Op {
  const float* a;
  int ai, ak;
  const float* b;
  int bk, bj;
  const float* ks;
  int K;
};

// out(i, j) = sum_k a(i, k) b(k, j) of two operand pairs at once (K = 0
// for none), i < M, j < Nc, each sum in k order. Rows go to warps (i =
// i0 + warp + 8 ii, so a warp's lanes share the a values), columns to
// lanes (j = j0 + lane + 32 jj, neighbouring lanes on neighbouring or
// odd-strided words). epi(i, j, v0, v1) stores and returns a term of row
// i's dot; with rowdot set, each row's terms are summed over its lanes in
// a fixed butterfly and added to rowdot[i].
template <int TJ, typename Epi>
__device__ __forceinline__ void mm(int M, int Nc, const Op& o0,
                                   const Op& o1, float* rowdot, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < M; i0 += BWD_WARPS * BWD_TI)
    for (int j0 = 0; j0 < Nc; j0 += 32 * TJ) {
      int ir[BWD_TI], jc[TJ];
#pragma unroll
      for (int ii = 0; ii < BWD_TI; ++ii)
        ir[ii] = min(i0 + warp + BWD_WARPS * ii, M - 1);
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) jc[jj] = min(j0 + lane + 32 * jj, Nc - 1);
      float acc[2][BWD_TI][TJ];
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const Op& p = o == 0 ? o0 : o1;
#pragma unroll
        for (int ii = 0; ii < BWD_TI; ++ii)
#pragma unroll
          for (int jj = 0; jj < TJ; ++jj) acc[o][ii][jj] = 0.f;
        for (int k = 0; k < p.K; ++k) {
          const float sc = p.ks != nullptr ? p.ks[k] : 1.f;
          float av[BWD_TI], bv[TJ];
#pragma unroll
          for (int ii = 0; ii < BWD_TI; ++ii)
            av[ii] = p.a[ir[ii] * p.ai + k * p.ak] * sc;
#pragma unroll
          for (int jj = 0; jj < TJ; ++jj) bv[jj] = p.b[k * p.bk + jc[jj] * p.bj];
#pragma unroll
          for (int ii = 0; ii < BWD_TI; ++ii)
#pragma unroll
            for (int jj = 0; jj < TJ; ++jj)
              acc[o][ii][jj] = fmaf(av[ii], bv[jj], acc[o][ii][jj]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < BWD_TI; ++ii) {
        const int i = i0 + warp + BWD_WARPS * ii;
        float dot = 0.f;
#pragma unroll
        for (int jj = 0; jj < TJ; ++jj) {
          const int j = j0 + lane + 32 * jj;
          if (i < M && j < Nc) dot += epi(i, j, acc[0][ii][jj], acc[1][ii][jj]);
        }
        if (rowdot != nullptr) {
          dot = warp_sum(dot);
          if (lane == 0 && i < M) rowdot[i] += dot;
        }
      }
    }
}

// mm with the column tile fitted to Nc
template <typename Epi>
__device__ __forceinline__ void mm_fit(int M, int Nc, const Op& o0,
                                       const Op& o1, float* rowdot, Epi epi) {
  if (Nc <= 32) mm<1>(M, Nc, o0, o1, rowdot, epi);
  else if (Nc <= 64) mm<2>(M, Nc, o0, o1, rowdot, epi);
  else mm<4>(M, Nc, o0, o1, rowdot, epi);
}

// the clamp's gradient at d = cum_t - cum_s of rows t, s: jnp.minimum's
// (a tie halves) within one forward chunk, the state's 1 across two
__device__ __forceinline__ float clamp_grad(float d, int t, int s, int Lf) {
  if (t / Lf != s / Lf) return 1.f;
  return d < 0.f ? 1.f : (d == 0.f ? 0.5f : 0.f);
}

// One block per (b, h): the chunks in reverse order, dS carried in shared
// memory. Writes dx and ddt of the head, its share of dB and dC per row,
// and its share of dA and dD.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, 1) ssd_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, P = a.P, N = a.N;
  const int ldN = N + 1, ldP = P + 1, ldL = L + 1;
  float* sS = reinterpret_cast<float*>(smem);  // P x ldN: S_c
  float* sdS = sS + P * ldN;   // P x ldN: dS of the state leaving the chunk
  float* sx = sdS + P * ldN;   // L x ldP
  float* sdy = sx + L * ldP;   // L x ldP
  float* sB = sdy + L * ldP;   // L x ldN
  float* sC = sB + L * ldN;    // L x ldN
  float* sM1 = sC + L * ldN;   // L x ldL: C_t.B_s, then (C_t.B_s) e_ts
  float* sM2 = sM1 + L * ldL;  // L x ldL: dy_t.x_s, then e_ts dt_s dy_t.x_s
  float* vdt = sM2 + L * ldL;  // per row: dt
  float* vcum = vdt + L;       // cum
  float* vec = vcum + L;       // exp(cum)
  float* vw = vec + L;         // w = exp(cum_L - cum) dt
  float* vrow = vw + L;        // sum_s G_ts f_ts
  float* vcol = vrow + L;      // sum_t G_ts f_ts
  float* vdir = vcol + L;      // sum_t (C_t.B_s) e_ts dy_t.x_s
  float* vzc = vdir + L;       // C_t.(S_c^T dy_t)
  float* vq = vzc + L;         // B_s.(dS^T x_s)
  float* vdd = vq + L;         // dy_t.x_t
  float* red = vdd + L;        // [BWD_WARPS]: <dS, S_c> by warp

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x % a.H, b = blockIdx.x / a.H;
  const int grp = h / (a.H / a.G);
  const int nc = (a.S + L - 1) / L;
  const float Ah = a.A[h], Dh = a.D[h];
  const T* xb = static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h;
  const T* bb = static_cast<const T*>(a.Bm) + b * a.bs_b + grp * a.bs_g;
  const T* cb = static_cast<const T*>(a.Cm) + b * a.cs_b + grp * a.cs_g;
  const float* dtb = a.dt + b * a.ds_b + h;
  const long long row0 = (long long)b * a.S * a.H + h;  // (b, 0, h)
  const long long ps = (long long)a.H * P, ns = (long long)a.H * N;
  const T* dyb = static_cast<const T*>(a.dy) + row0 * P;
  T* dxb = static_cast<T*>(a.dx) + row0 * P;
  float* ddtb = a.ddt + row0;
  float* dbp = a.dbp + row0 * N;
  float* dcp = a.dcp + row0 * N;
  // the block's incoming states (none with one chunk)
  const float* st0 =
      nc > 1 ? a.states + ((long long)b * a.H + h) * (nc - 1) * P * N
             : nullptr;
  for (int i = tid; i < P * ldN; i += BWD_THREADS) sdS[i] = 0.f;
  float sumA = 0.f, sumD = 0.f;  // thread 0's, in reverse chunk order
  const Op none{nullptr, 0, 0, nullptr, 0, 0, nullptr, 0};

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L, nv = min(L, a.S - t0);
    // the chunk's rows (past S: zeros) and its incoming state
    for (int i = tid; i < L * P; i += BWD_THREADS) {
      const int r = i / P, col = i - r * P;
      const bool in = r < nv;
      sx[r * ldP + col] = in ? to_f32(xb[(t0 + r) * a.xs_s + col]) : 0.f;
      sdy[r * ldP + col] = in ? to_f32(dyb[(t0 + r) * ps + col]) : 0.f;
    }
    for (int i = tid; i < L * N; i += BWD_THREADS) {
      const int r = i / N, col = i - r * N;
      const bool in = r < nv;
      sB[r * ldN + col] = in ? to_f32(bb[(t0 + r) * a.bs_s + col]) : 0.f;
      sC[r * ldN + col] = in ? to_f32(cb[(t0 + r) * a.cs_s + col]) : 0.f;
    }
    if (c > 0) {
      const float* stc = st0 + (long long)(c - 1) * P * N;
      for (int i = tid; i < P * N; i += BWD_THREADS) {
        const int r = i / N, col = i - r * N;
        sS[r * ldN + col] = stc[i];
      }
    } else {
      for (int i = tid; i < P * ldN; i += BWD_THREADS) sS[i] = 0.f;
    }
    for (int i = tid; i < L; i += BWD_THREADS) {
      vdt[i] = i < nv ? dtb[(t0 + i) * a.ds_s] : 0.f;
      vzc[i] = vq[i] = 0.f;
    }
    __syncthreads();
    // the chunk's cumsum in row order, each product rounded on its own
    if (tid == 0) {
      float run = 0.f;
      for (int r = 0; r < L; ++r) {
        run = __fadd_rn(run, __fmul_rn(vdt[r], Ah));
        vcum[r] = run;
      }
    }
    // <dS, S_c>: each thread's words in order, then its warp, by warp
    float sd = 0.f;
    for (int i = tid; i < P * N; i += BWD_THREADS) {
      const int r = i / N, col = i - r * N;
      sd = fmaf(sdS[r * ldN + col], sS[r * ldN + col], sd);
    }
    sd = warp_sum(sd);
    if (lane == 0) red[warp] = sd;
    // the scores C_t.B_s and dy_t.x_s (rows t, columns s)
    mm_fit(L, L, Op{sC, ldN, 1, sB, 1, ldN, nullptr, N},
           Op{sdy, ldP, 1, sx, 1, ldP, nullptr, P}, nullptr,
           [&](int i, int j, float v0, float v1) {
             sM1[i * ldL + j] = v0;
             sM2[i * ldL + j] = v1;
             return 0.f;
           });
    __syncthreads();
    const float cumL = vcum[L - 1], eL = expf(cumL);
    for (int i = tid; i < L; i += BWD_THREADS) {
      vec[i] = expf(vcum[i]);
      vw[i] = expf(cumL - vcum[i]) * vdt[i];
    }
    // the clamp's cotangent G_ts f_ts, summed by row (warps over rows,
    // lanes over columns) and by column (warps over columns, lanes over
    // rows), and the direct dt term by column
    for (int t = warp; t < L; t += BWD_WARPS) {
      float rs = 0.f;
      for (int s = lane; s <= t; s += 32) {
        const float d = vcum[t] - vcum[s];
        const float e = expf(fminf(d, 0.f));
        rs += sM1[t * ldL + s] * e * vdt[s] * sM2[t * ldL + s] *
              clamp_grad(d, t0 + t, t0 + s, a.Lf);
      }
      rs = warp_sum(rs);
      if (lane == 0) {
        vrow[t] = rs;
        vdd[t] = sM2[t * ldL + t];
      }
    }
    for (int s = warp; s < L; s += BWD_WARPS) {
      float cs = 0.f, ds = 0.f;
      for (int t = s + lane; t < L; t += 32) {
        const float d = vcum[t] - vcum[s];
        const float e = expf(fminf(d, 0.f));
        const float m = sM1[t * ldL + s] * e, g = sM2[t * ldL + s];
        cs += m * vdt[s] * g * clamp_grad(d, t0 + t, t0 + s, a.Lf);
        ds += m * g;
      }
      cs = warp_sum(cs);
      ds = warp_sum(ds);
      if (lane == 0) {
        vcol[s] = cs;
        vdir[s] = ds;
      }
    }
    __syncthreads();
    // M1 = (C_t.B_s) e_ts and M2 = e_ts dt_s dy_t.x_s on t >= s, 0 above
    for (int i = tid; i < L * L; i += BWD_THREADS) {
      const int t = i / L, s = i - t * L;
      const float e = s <= t ? expf(fminf(vcum[t] - vcum[s], 0.f)) : 0.f;
      sM1[t * ldL + s] *= e;
      sM2[t * ldL + s] *= e * vdt[s];
    }
    __syncthreads();
    // dx (rows s, columns p): D dy_s + dt_s sum_t M1_ts dy_t + w_s dS B_s
    mm_fit(L, P, Op{sM1, 1, ldL, sdy, ldP, 1, nullptr, L},
           Op{sB, ldN, 1, sdS, 1, ldN, nullptr, N}, nullptr,
           [&](int i, int j, float v0, float v1) {
             if (i < nv)
               dxb[(t0 + i) * ps + j] = from_f32<T>(
                   Dh * sdy[i * ldP + j] + vdt[i] * v0 + vw[i] * v1);
             return 0.f;
           });
    // dC (rows t, columns n): sum_s M2_ts B_s + exp(cum_t) S_c^T dy_t, and
    // C_t.(S_c^T dy_t) by row
    mm_fit(L, N, Op{sM2, ldL, 1, sB, ldN, 1, nullptr, L},
           Op{sdy, ldP, 1, sS, ldN, 1, nullptr, P}, vzc,
           [&](int i, int j, float v0, float v1) {
             if (i < nv) dcp[(t0 + i) * ns + j] = v0 + vec[i] * v1;
             return sC[i * ldN + j] * v1;
           });
    // dB (rows s, columns n): sum_t M2_ts C_t + w_s dS^T x_s, and
    // q_s = B_s.(dS^T x_s) by row
    mm_fit(L, N, Op{sM2, 1, ldL, sC, ldN, 1, nullptr, L},
           Op{sx, ldP, 1, sdS, ldN, 1, nullptr, P}, vq,
           [&](int i, int j, float v0, float v1) {
             if (i < nv) dbp[(t0 + i) * ns + j] = v0 + vw[i] * v1;
             return sB[i * ldN + j] * v1;
           });
    __syncthreads();
    // dcum, da, ddt, and the chunk's dA and dD terms, in row order
    if (tid == 0) {
      float sdot = 0.f, wq = 0.f;
      for (int k = 0; k < BWD_WARPS; ++k) sdot += red[k];
      for (int s = 0; s < L; ++s) wq = fmaf(vw[s], vq[s], wq);
      float da = 0.f;
      for (int t = L - 1; t >= 0; --t) {
        float dcum = vec[t] * vzc[t] + vrow[t] - vcol[t] - vw[t] * vq[t];
        if (t == L - 1) dcum += eL * sdot + wq;
        da += dcum;
        if (t < nv)
          ddtb[(long long)(t0 + t) * a.H] =
              da * Ah + vdir[t] + expf(cumL - vcum[t]) * vq[t];
        sumA = fmaf(da, vdt[t], sumA);
        sumD += vdd[t];
      }
    }
    // dS of the state entering the chunk, in place: exp(cum_L) dS +
    // sum_t exp(cum_t) dy_t (x) C_t (rows p, columns n)
    mm_fit(P, N, Op{sdy, 1, ldP, sC, ldN, 1, vec, L}, none, nullptr,
           [&](int i, int j, float v0, float) {
             sdS[i * ldN + j] = eL * sdS[i * ldN + j] + v0;
             return 0.f;
           });
    __syncthreads();
  }
  if (tid == 0) {
    a.part[2 * ((long long)b * a.H + h)] = sumA;
    a.part[2 * ((long long)b * a.H + h) + 1] = sumD;
  }
}

// Ties across a backward chunk boundary bd inside one forward chunk
// [f0, f1): a pair s < bd <= t with cum_t == cum_s took the state's
// gradient, G_ts at t and -G_ts at s (so G_ts on da_u for s < u <= t),
// where the reference's clamp passes half. With G_ts = (C_t.B_s) dt_s
// (dy_t.x_s) this takes back da_u -= 0.5 sum_{s < u <= t} G_ts: ddt_u
// gains that times A and the sequence's dA share that times dt_u. A pair
// ties when s's chunk-local cumsum (ssd_bwd_kernel's, row by row) is flat
// after s, cum_{bd-1} == cum_s, and a = dt A is 0 on every row from bd to
// t; it is taken at the first boundary after s, so s lies in
// [max(f0, bd - L), bd) and t in [bd, q), q the first row from bd with
// a != 0 (or f1). With R_s = sum_t G_ts and K_t = sum_s G_ts, rows u < bd
// take -0.5 sum_{s<u} R_s and rows u >= bd -0.5 sum_{t>=u} K_t. One block
// per (b, h), after ssd_bwd_kernel; a boundary whose first row has
// a != 0 costs one read.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS) ssd_bwd_tie_kernel(
    BwdArgs a) {
  __shared__ float vcum[BWD_MAX_L];  // the chunk before bd, as ssd_bwd_kernel
  __shared__ float vr[BWD_MAX_L];    // R_s, or K_t of a tile of rows
  __shared__ int lim;                // q
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x % a.H, b = blockIdx.x / a.H;
  const int grp = h / (a.H / a.G);
  const int L = a.L, Lf = a.Lf, P = a.P, N = a.N;
  const float Ah = a.A[h];
  const T* xb = static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h;
  const T* bb = static_cast<const T*>(a.Bm) + b * a.bs_b + grp * a.bs_g;
  const T* cb = static_cast<const T*>(a.Cm) + b * a.cs_b + grp * a.cs_g;
  const float* dtb = a.dt + b * a.ds_b + h;
  const long long row0 = (long long)b * a.S * a.H + h;  // (b, 0, h)
  const long long ps = (long long)a.H * P;
  const T* dyb = static_cast<const T*>(a.dy) + row0 * P;
  float* ddtb = a.ddt + row0;
  float sumA = 0.f;  // thread 0's, in boundary order
  // G_ts of one pair: a warp's lanes over n and p, a fixed butterfly
  auto pair = [&](int t, int s) {
    float cbd = 0.f, dxy = 0.f;
    for (int n = lane; n < N; n += 32)
      cbd = fmaf(to_f32(cb[t * a.cs_s + n]), to_f32(bb[s * a.bs_s + n]), cbd);
    for (int p = lane; p < P; p += 32)
      dxy = fmaf(to_f32(dyb[t * ps + p]), to_f32(xb[s * a.xs_s + p]), dxy);
    return warp_sum(cbd) * dtb[s * a.ds_s] * warp_sum(dxy);
  };
  for (int bd = L; bd < a.S; bd += L) {
    if (bd % Lf == 0) continue;
    const int f0 = bd - bd % Lf, f1 = min(f0 + Lf, a.S);
    const int c0 = max(f0, bd - L), r0 = bd - L;
    if (tid == 0) {
      int q = bd;
      while (q < f1 && __fmul_rn(dtb[q * a.ds_s], Ah) == 0.f) ++q;
      if (q > bd) {
        float run = 0.f;
        for (int r = 0; r < L; ++r) {
          run = __fadd_rn(run, __fmul_rn(dtb[(r0 + r) * a.ds_s], Ah));
          vcum[r] = run;
        }
      }
      lim = q;
    }
    __syncthreads();
    const int q = lim;
    if (q > bd) {
      const float last = vcum[L - 1];
      // rows u >= bd, in tiles of BWD_MAX_L from the last: K_t, then the
      // suffix sums by thread 0
      float run = 0.f;
      for (int hi = q; hi > bd; hi -= BWD_MAX_L) {
        const int lo = max(bd, hi - BWD_MAX_L);
        for (int t = lo + warp; t < hi; t += BWD_WARPS) {
          float k = 0.f;
          for (int s = c0; s < bd; ++s)
            if (vcum[s - r0] == last && dtb[s * a.ds_s] != 0.f)
              k += pair(t, s);
          if (lane == 0) vr[t - lo] = k;
        }
        __syncthreads();
        if (tid == 0)
          for (int u = hi - 1; u >= lo; --u) {
            run += vr[u - lo];
            const float corr = -0.5f * run;
            ddtb[(long long)u * a.H] += corr * Ah;
            sumA = fmaf(corr, dtb[u * a.ds_s], sumA);
          }
        __syncthreads();
      }
      // rows u < bd: R_s, then the prefix sums by thread 0
      for (int s = c0 + warp; s < bd; s += BWD_WARPS) {
        float r = 0.f;
        if (vcum[s - r0] == last && dtb[s * a.ds_s] != 0.f)
          for (int t = bd; t < q; ++t) r += pair(t, s);
        if (lane == 0) vr[s - r0] = r;
      }
      __syncthreads();
      if (tid == 0) {
        float pre = 0.f;
        for (int u = c0; u < bd; ++u) {
          const float corr = -0.5f * pre;
          ddtb[(long long)u * a.H] += corr * Ah;
          sumA = fmaf(corr, dtb[u * a.ds_s], sumA);
          pre += vr[u - r0];
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) a.part[2 * ((long long)b * a.H + h)] += sumA;
}

// dB and dC (B, S, G, N) in x's dtype: the heads of each group summed in
// head order; then dA and dD (H,): the batch summed in order
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS) ssd_bwd_reduce_kernel(
    BwdArgs a, T* dB, T* dC, float* dA, float* dD) {
  const long long i = (long long)blockIdx.x * BWD_THREADS + threadIdx.x;
  const long long per = (long long)a.B * a.S * a.G * a.N;
  const int rep = a.H / a.G;
  if (i < 2 * per) {
    const bool isc = i >= per;
    const long long e = isc ? i - per : i;
    const long long r = e / a.N;  // (b, s, g)
    const int n = (int)(e - r * a.N), g = (int)(r % a.G);
    const long long bs = r / a.G;
    const float* src =
        (isc ? a.dcp : a.dbp) + (bs * a.H + (long long)g * rep) * a.N + n;
    float acc = 0.f;
    for (int k = 0; k < rep; ++k) acc += src[(long long)k * a.N];
    (isc ? dC : dB)[e] = from_f32<T>(acc);
  } else if (i < 2 * per + a.H) {
    const int h = (int)(i - 2 * per);
    float sa = 0.f, sd = 0.f;
    for (int b = 0; b < a.B; ++b) {
      sa += a.part[2 * ((long long)b * a.H + h)];
      sd += a.part[2 * ((long long)b * a.H + h) + 1];
    }
    dA[h] = sa;
    dD[h] = sd;
  }
}

template <typename T>
int launch_bwd(const Args& f, const BwdArgs& a, void* dB, void* dC,
               float* dA, float* dD, cudaStream_t stream) {
  using Pr = Prec<T>;
  const int nc = (a.S + a.L - 1) / a.L;
  cudaError_t err;
  if (nc > 1) {
    // step 1: each chunk's end state from zero, then the incoming states
    const long long s1 = smem_bytes(false, Pr::IN, Pr::CMP, false,
                                    n_bufs<T>(f.vec), a.L, a.P, a.N);
    if ((err = fit_smem(ssd_pass1_kernel<T>, s1)) != cudaSuccess)
      return (int)err;
    ssd_pass1_kernel<T><<<(unsigned)(a.B * (nc - 1) * a.H), THREADS, s1,
                          stream>>>(f);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (nc > 2) {
      const long long n = (long long)a.B * a.H * a.P * a.N;
      ssd_pass2_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                         stream>>>(f);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  const long long s2 = 4 * bwd_smem_floats(a.L, a.P, a.N);
  if ((err = fit_smem(ssd_bwd_kernel<T>, s2)) != cudaSuccess) return (int)err;
  ssd_bwd_kernel<T><<<(unsigned)(a.B * a.H), BWD_THREADS, s2, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (a.Lf > a.L) {
    ssd_bwd_tie_kernel<T><<<(unsigned)(a.B * a.H), BWD_THREADS, 0, stream>>>(
        a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long n = 2LL * a.B * a.S * a.G * a.N + a.H;
  ssd_bwd_reduce_kernel<T><<<(unsigned)((n + BWD_THREADS - 1) / BWD_THREADS),
                             BWD_THREADS, 0, stream>>>(
      a, static_cast<T*>(dB), static_cast<T*>(dC), dA, dD);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of the largest block of a call, in bytes (the wrapper
// checks it against the card's limit before a launch).
extern "C" long long ssd_scan_smem_bytes(int dtype, int L, int P, int N,
                                         int carry, int vec) {
  if (dtype == DT_F32)
    return smem_bytes(true, Prec<float>::IN, Prec<float>::CMP, carry != 0,
                      n_bufs<float>(vec != 0), L, P, N);
  return smem_bytes(true, Prec<__nv_bfloat16>::IN, Prec<__nv_bfloat16>::CMP,
                    carry != 0, n_bufs<__nv_bfloat16>(vec != 0), L, P, N);
}

// x: (B, S, H, P) and Bm, Cm: (B, S, G, N), one dtype (DT_F32 / DT_BF16),
// strided with a unit last stride; dt: (B, S, H) float32 with unit H
// stride; A, D: (H,) float32; y: (B, S, H, P) dense, x's dtype; state:
// (B, H, P, N) float32 dense, or null. L = min(chunk, S); the chunks are
// cut into `groups` groups of `per_group` (kernels/autotune.py
// ssd_groups); with groups > 1, scratch holds B H (groups - 1) (P N + 1)
// floats. The state's strips need ceil(P / 16) ceil(N / 64) <= 8. `vec`:
// x, B and C may be read in 16-byte vectors (aligned bases and strides, P
// and N multiples of 8). Returns cudaGetLastError() after the launches.
extern "C" int ssd_scan_launch(
    int dtype, const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, void* y, void* state, void* scratch,
    int B, int S, int H, int P, int G, int N, int L, int per_group,
    int groups, int vec, long long xs_b, long long xs_s, long long xs_h,
    long long ds_b, long long ds_s, long long bs_b, long long bs_s,
    long long bs_g, long long cs_b, long long cs_s, long long cs_g,
    void* stream) {
  const int nc = (S > 0 && L > 0) ? (S + L - 1) / L : 0;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || G <= 0 || L <= 0 ||
      H % G != 0 || per_group <= 0 || groups <= 0 ||
      (long long)(groups - 1) * per_group >= nc ||
      (long long)groups * per_group < nc ||
      (long long)B * H * groups > 0x7fffffffLL ||
      ((up16(P) / 16) * ((up16(N) + 63) / 64)) > WARPS ||
      (groups > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long ends = (long long)B * H * (groups - 1) * P * N;
  float* sc = static_cast<float*>(scratch);
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm,
         Cm, static_cast<const float*>(D), y, static_cast<float*>(state),
         sc, sc == nullptr ? nullptr : sc + ends,
         B, S, H, P, G, N, L, per_group, groups, vec,
         xs_b, xs_s, xs_h, ds_b, ds_s, bs_b, bs_s, bs_g, cs_b, cs_s, cs_g};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch<float>(a, s);
  if (dtype == DT_BF16) return launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory of ssd_scan_bwd_launch's main block at chunk L, in bytes.
extern "C" long long ssd_scan_bwd_smem_bytes(int L, int P, int N) {
  return 4 * bwd_smem_floats(L, P, N);
}

// The backward of ssd_scan_launch's y for the cotangent dy (B, S, H, P),
// dense in x's dtype. x, dt, A, Bm, Cm, D, the strides and `vec` as for
// ssd_scan_launch; L: the chunk (<= S; its block must fit the card's
// shared memory: ssd_scan_bwd_smem_bytes); Lf: the forward's chunk
// (>= L, <= S; with Lf > L, L <= 64). Writes dx (B, S, H, P) dense in
// x's dtype, ddt (B, S, H) dense float32, dB and dC (B, S, G, N) dense in
// x's dtype, dA and dD (H,) float32. Scratch: states, B H (nc - 1) (P N +
// 1) floats (nc = ceil(S / L); null when nc = 1); partial, 2 B S H N + 2 B
// H floats. Returns cudaGetLastError() after the launches.
extern "C" int ssd_scan_bwd_launch(
    int dtype, const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* dy, void* dx, void* ddt,
    void* dB, void* dC, void* dA, void* dD, void* states, void* partial,
    int B, int S, int H, int P, int G, int N, int L, int Lf, int vec,
    long long xs_b,
    long long xs_s, long long xs_h, long long ds_b, long long ds_s,
    long long bs_b, long long bs_s, long long bs_g, long long cs_b,
    long long cs_s, long long cs_g, void* stream) {
  const int nc = (S > 0 && L > 0) ? (S + L - 1) / L : 0;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || G <= 0 || L <= 0 ||
      L > S || Lf < L || Lf > S || (Lf > L && L > BWD_MAX_L) ||
      H % G != 0 || (long long)B * H > 0x7fffffffLL ||
      (long long)B * H * nc > 0x7fffffffLL ||
      ((up16(P) / 16) * ((up16(N) + 63) / 64)) > WARPS ||
      (nc > 1 && states == nullptr) || partial == nullptr)
    return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(states);
  const long long ends = (long long)B * H * (nc - 1) * P * N;
  Args f{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm,
         Cm, static_cast<const float*>(D), nullptr, nullptr,
         sc, sc == nullptr ? nullptr : sc + ends,
         B, S, H, P, G, N, L, 1, nc, vec,
         xs_b, xs_s, xs_h, ds_b, ds_s, bs_b, bs_s, bs_g, cs_b, cs_s, cs_g};
  float* pt = static_cast<float*>(partial);
  const long long bshn = (long long)B * S * H * N;
  BwdArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
            Bm, Cm, static_cast<const float*>(D), dy, sc, dx,
            static_cast<float*>(ddt), pt, pt + bshn, pt + 2 * bshn,
            B, S, H, P, G, N, L, Lf,
            xs_b, xs_s, xs_h, ds_b, ds_s, bs_b, bs_s, bs_g, cs_b, cs_s, cs_g};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fa = static_cast<float*>(dA);
  float* fd = static_cast<float*>(dD);
  if (dtype == DT_F32) return launch_bwd<float>(f, a, dB, dC, fa, fd, s);
  if (dtype == DT_BF16)
    return launch_bwd<__nv_bfloat16>(f, a, dB, dC, fa, fd, s);
  return (int)cudaErrorInvalidValue;
}
