// The composed makespan of a workflow DAG and its reverse pass, one launch
// per call, for Hopper (sm_90a).
//
// Replaces, on the card, the eager composition and autograd of the port's
// workflow/solve.py::_compose_grads_plain (workflow/dag.py::compose_structure
// followed by torch.autograd.grad). The JAX package computes the same
// function inside its jitted solve (repro/workflow/dag.py::compose_structure
// under jax.grad); it has no Pallas kernel for it.
//
// Per row r (a start of the joint solve), with the stage moments smu, svar
// (R, S) float32:
//   forward, in topological order: a source's completion is its stage; a
//   node with one predecessor adds its stage to the predecessor's
//   completion; a join folds its predecessors left to right (list order)
//   by Clark's max of two Gaussians, then adds its stage; several sinks
//   fold once more. loss = mk_mu + lam mk_var.
//   reverse: the same nodes in reverse order, the closed-form cotangents of
//   each add and each Clark fold, with autograd's conventions at every
//   boundary (clamp_min passes the gradient where x >= floor; the where at
//   a == 0 sends nothing to the unselected branch; sqrt's gradient is
//   g / (2 sqrt(x)); erf's is 2/sqrt(pi) exp(-x^2) g), each cotangent
//   computed by the plain version's formula and added into its tensor's
//   buffer in the order autograd's engine adds it (reverse creation
//   order). So the kernel's result is the plain version's, bit for bit,
//   where the two evaluate erf, exp and sqrt alike (CUDA's on the card).
// Outputs, one buffer: losses (R,), then g_mu = dloss/dsmu and
// g_var = dloss/dsvar (R, S) each.
//
// What bounds it: neither bytes nor operations but one dependency chain. A
// join's fold is sequential (Clark's max is order-dependent), forward and
// back: at S = 512 a 170-way join is 169 fold steps of ~40 float32
// operations each way (an erf, two exps, three square roots, divisions),
// a few hundred cycles of latency a step. Design: one block of one warp per
// row. The row's moments and the structure's plan (kernels/compose.py
// encode_arrays: topological levels, fold edges, and each node's cotangent
// sources in autograd's order) are staged into shared memory once with
// cp.async; the completions, the cotangents, each fold step's forward
// intermediates (a Rec: the reverse reads them instead of evaluating the
// fold again) and each fold edge's cotangents live there too, so the chain
// never touches device memory. The lanes take a level's independent nodes
// at once (the 170 branches' adds, distinct joins); a join's fold stays in
// one lane, which runs only the chain from one step's accumulator to the
// next, its next record loaded a step ahead; the lanes take the rest of
// each step across the fold (the item side before, erf's derivative and
// alpha / den after, the edges' cotangents after the reverse). A node's
// cotangent is summed by one lane, from zero, over its sources in the
// plan's order: what its consumers staged (a fold edge's five mu edges and
// its var edge, or a consumer's own cotangent), so each buffer takes
// autograd's adds in autograd's order. Built with --fmad=false, as the
// plain version's torch operations round each step; a fold's cotangent of
// the cdf is a difference of nearly equal products, so another order would
// move the gradient by ~1e-5 relative at 512 stages. No atomics. A plan
// whose state passes the 227 KB a block may hold keeps it in a per-row
// workspace in device memory instead (the same code, kSmem = false).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kVarFloor = 1e-18f;             // _fold_max's clamp
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;
constexpr int kThreads = 32;
constexpr int kSmemMax = 232448;                // a block's opt-in maximum

// The plan's header, in kernels/compose.py HEADER's order: counts, the
// int32 sections' offsets (ints), the float sections' offsets (floats of
// a row's state), the dynamic shared memory of a block (0: device memory).
enum {
  kS, kLevels, kSinks, kSinkBase, kFolds, kInts,
  kOffLvl, kOffNodes, kOffPredOff, kOffPredIdx, kOffFbase, kOffSinks,
  kOffMrefOff, kOffMref, kOffVrefOff, kOffVref, kOffLstOff, kOffLst,
  kFloats, kFMu, kFVar, kFCm, kFCv, kFU, kFRec, kSmemBytes, kHeader
};

struct Plan {
  int v[kHeader];
};

// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return (x != x) ? x : (x < lo ? lo : x);
}

// One Clark fold step max(X1, X2), X_i ~ N(mu_i, v_i) after the fold's
// sqrt(clamp_min(v, 1e-18)), as core/maxstat.py::clark_max_moments_2 and
// workflow/dag.py::_fold_max compute it: its inputs and every intermediate
// the reverse pass reads. Three hands fill it: the item side (mu2, v2, s2,
// B) by the lanes before the step (fold_item), the chain through the
// accumulator by the fold's lane (clark_chain), and what only the reverse
// reads (eu = erf's derivative factor at u, ad = alpha / den) by the lanes
// after (fold_after); the reverse chain adds its cotangents of m2 and m1,
// of d and of a2 (g_*), from which the lanes then fill the step's edges
// (fold_edges). Every value is the one formula of the plain version, so
// the split moves no bit; it keeps the special functions that the next
// step does not wait for off the one lane's chain, where in-order issue
// would wait for each.
struct __align__(16) Rec {
  float mu1, v1, mu2, v2;
  float s1, s2, a2, a;
  float den, alpha, eu, ad;
  float ha, ex, cdf, pdf;
  float omc, m1, A, B;
  float sum12, Cc, vr, ok;
  float g_m2, g_m1, g_d, g_a2;
};

// The item side of a step, from the item's completion.
__device__ __forceinline__ void fold_item(float mu2, float v2, Rec& f) {
  f.mu2 = mu2;
  f.v2 = v2;
  f.s2 = sqrtf(clamp_lo(v2, kVarFloor));
  f.B = mu2 * mu2 + f.s2 * f.s2;
}

// The step's chain from the accumulator (f holds the item side); returns
// its variance clamp_min(m2 - m1 m1, 0).
__device__ __forceinline__ float clark_chain(float mu1, float v1, Rec& f) {
  f.mu1 = mu1;
  f.v1 = v1;
  f.s1 = sqrtf(clamp_lo(v1, kVarFloor));
  f.a2 = f.s1 * f.s1 + f.s2 * f.s2;
  f.a = sqrtf(clamp_lo(f.a2, 0.f));
  const bool ok = f.a > 0.f;
  f.ok = ok ? 1.f : 0.f;
  f.den = ok ? f.a : 1.f;
  const float d = mu1 - f.mu2;
  f.alpha = d / f.den;
  const float u = f.alpha * kInvSqrt2;
  const float P = 0.5f * (1.f + erff(u));
  f.ha = -0.5f * f.alpha;
  f.ex = expf(f.ha * f.alpha);
  const float ph = f.ex * kInvSqrt2Pi;
  f.cdf = ok ? P : (mu1 >= f.mu2 ? 1.f : 0.f);
  f.pdf = ok ? ph : 0.f;
  f.omc = 1.f - f.cdf;
  f.m1 = (mu1 * f.cdf + f.mu2 * f.omc) + f.a * f.pdf;
  f.A = mu1 * mu1 + f.s1 * f.s1;
  f.sum12 = mu1 + f.mu2;
  f.Cc = f.sum12 * f.a;
  const float m2 = (f.A * f.cdf + f.B * f.omc) + f.Cc * f.pdf;
  f.vr = m2 - f.m1 * f.m1;
  return clamp_lo(f.vr, 0.f);
}

// What only the reverse reads.
__device__ __forceinline__ void fold_after(Rec& f) {
  const float u = f.alpha * kInvSqrt2;
  f.eu = expf(-(u * u)) * kTwoOverSqrtPi;
  f.ad = f.alpha / f.den;
}

// The reverse of one step's chain, from the cotangents (gm, gv) of its
// (m1, v); gm already holds what the step's later consumers sent to m1.
// Stores g_m2, g_m1, g_d, g_a2 in the record and returns the cotangents of
// the accumulator it started from: its mu1 edges summed from the first,
// autograd's order, and its var edge.
__device__ __forceinline__ void clark_bwd(Rec& f, float gm, float gv,
                                          float& ngm, float& ngv) {
  const bool ok = f.ok != 0.f;
  // v = clamp_min(m2 - m1 m1, 0)
  const float g_m2 = f.vr >= 0.f ? gv : 0.f;
  const float g_mm = -g_m2;
  const float g_m1 = (gm + g_mm * f.m1) + g_mm * f.m1;
  // m2 = (A cdf + B (1 - cdf)) + ((mu1 + mu2) a) pdf
  const float g_y9 = g_m2 * f.pdf;          // of (mu1 + mu2) a
  const float g_y8 = g_y9 * f.a;            // of mu1 + mu2
  const float g_A = g_m2 * f.cdf;
  // cdf feeds, last first: 1 - cdf (m2), A cdf, 1 - cdf (m1), mu1 cdf
  float g_cdf = -(g_m2 * f.B);
  g_cdf = g_cdf + g_m2 * f.A;
  g_cdf = g_cdf + -(g_m1 * f.mu2);
  g_cdf = g_cdf + g_m1 * f.mu1;
  // pdf feeds ((mu1 + mu2) a) pdf, then a pdf
  const float g_pdf = g_m2 * f.Cc + g_m1 * f.a;
  // the where at a == 0 passes nothing to Phi and phi
  const float g_P = ok ? g_cdf : 0.f;
  const float g_ph = ok ? g_pdf : 0.f;
  // phi = exp((-0.5 alpha) alpha) / sqrt(2 pi); Phi = 0.5 (1 + erf(u))
  const float g_q = (g_ph * kInvSqrt2Pi) * f.ex;
  float g_alpha = g_q * f.ha + (g_q * f.alpha) * -0.5f;
  const float g_e = g_P * 0.5f;
  const float g_u = f.eu * g_e;
  g_alpha = g_alpha + g_u * kInvSqrt2;
  // alpha = d / den, den = where(ok, a, 1)
  const float g_d = g_alpha / f.den;
  const float g_den = -g_alpha * f.ad;
  // a feeds ((mu1 + mu2) a), a pdf, where(ok, a, 1)
  float g_a = g_y9 * f.sum12;
  g_a = g_a + g_m1 * f.pdf;
  g_a = g_a + (ok ? g_den : 0.f);
  // a = sqrt(clamp_min(s1 s1 + s2 s2, 0))
  const float g_ca = g_a / (2.f * f.a);
  const float g_a2 = f.a2 >= 0.f ? g_ca : 0.f;
  // s1 feeds s1 s1 in A (two edges), then s1 s1 in a2 (two edges)
  float g_s1 = g_A * f.s1;
  g_s1 = g_s1 + g_A * f.s1;
  g_s1 = g_s1 + g_a2 * f.s1;
  g_s1 = g_s1 + g_a2 * f.s1;
  // s = sqrt(clamp_min(v, 1e-18))
  ngv = f.v1 >= kVarFloor ? g_s1 / (2.f * f.s1) : 0.f;
  // mu1 edges: (mu1 + mu2), mu1 mu1 (two edges), mu1 cdf, mu1 - mu2
  ngm = g_y8;
  ngm = ngm + g_A * f.mu1;
  ngm = ngm + g_A * f.mu1;
  ngm = ngm + g_m1 * f.cdf;
  ngm = ngm + g_d;
  f.g_m2 = g_m2;
  f.g_m1 = g_m1;
  f.g_d = g_d;
  f.g_a2 = g_a2;
}

// A step's edges, one per edge of the plain version's autograd graph, in
// the order its engine adds them into a buffer (reverse creation order:
// the last consumer first, both edges of an x * x in turn): the item's
// five mu edges ((mu1 + mu2), mu2 mu2 twice, mu2 (1 - cdf), -(mu1 - mu2))
// and its var edge (through sqrt(clamp_min(v, 1e-18))); for the fold's
// first step, item 0's too (mu1's five and its var edge).
__device__ __forceinline__ void fold_edges(const Rec& f, bool first,
                                           float* e2, float* ev2, float* e1,
                                           float* ev1) {
  const float g_y8 = (f.g_m2 * f.pdf) * f.a;
  const float g_B = f.g_m2 * f.omc;
  e2[0] = g_y8;
  e2[1] = g_B * f.mu2;
  e2[2] = g_B * f.mu2;
  e2[3] = f.g_m1 * f.omc;
  e2[4] = -f.g_d;
  float g_s2 = g_B * f.s2;
  g_s2 = g_s2 + g_B * f.s2;
  g_s2 = g_s2 + f.g_a2 * f.s2;
  g_s2 = g_s2 + f.g_a2 * f.s2;
  *ev2 = f.v2 >= kVarFloor ? g_s2 / (2.f * f.s2) : 0.f;
  if (first) {
    const float g_A = f.g_m2 * f.cdf;
    e1[0] = g_y8;
    e1[1] = g_A * f.mu1;
    e1[2] = g_A * f.mu1;
    e1[3] = f.g_m1 * f.cdf;
    e1[4] = f.g_d;
    float g_s1 = g_A * f.s1;
    g_s1 = g_s1 + g_A * f.s1;
    g_s1 = g_s1 + f.g_a2 * f.s1;
    g_s1 = g_s1 + f.g_a2 * f.s1;
    *ev1 = f.v1 >= kVarFloor ? g_s1 / (2.f * f.s1) : 0.f;
  }
}

// A row's state: completions, cotangents (U: gm (S + 1), gv (S + 1), the
// fold edges' mu cotangents (5 a fold edge) and var cotangents), the fold
// records (one a fold edge; item 0's slot unused).
struct State {
  float* cm;
  float* cv;
  float* gm;
  float* gv;
  float* emu;
  float* ev;
  Rec* rec;
};

// Fold the completions of `items` (w of them, fold edges fb ..) left to
// right from their records' item sides, storing each step's record; the
// next record is loaded a step ahead.
__device__ void fold_fwd(const State& st, const int* items, int w, int fb,
                         float& m, float& v) {
  m = st.cm[items[0]];
  v = st.cv[items[0]];
  Rec nf = st.rec[fb + 1];
#pragma unroll 1
  for (int j = 1; j < w; ++j) {
    Rec f = nf;
    if (j + 1 < w) nf = st.rec[fb + j + 1];
    v = clark_chain(m, v, f);
    m = f.m1;
    st.rec[fb + j] = f;
  }
}

// The same fold's reverse chain from the cotangents (gm, gv) of its
// result, last step first; the lanes fill the edges afterwards.
__device__ void fold_bwd(const State& st, int w, int fb, float gm, float gv) {
  Rec f = st.rec[fb + w - 1];
#pragma unroll 1
  for (int j = w - 1; j >= 1; --j) {
    Rec nf;
    if (j > 1) nf = st.rec[fb + j - 1];
    float ngm, ngv;
    clark_bwd(f, gm, gv, ngm, ngv);
    reinterpret_cast<float4*>(&st.rec[fb + j])[6] =
        make_float4(f.g_m2, f.g_m1, f.g_d, f.g_a2);
    gm = ngm;
    gv = ngv;
    f = nf;
  }
}

// A cotangent: zero plus each of its sources in the plan's order.
__device__ __forceinline__ float take(const float* U, const int* refs,
                                      int beg, int end) {
  float s = 0.f;
#pragma unroll 4
  for (int q = beg; q < end; ++q) s = s + U[refs[q]];
  return s;
}

// Copy `bytes` from device to shared memory across the warp: 16-byte
// cp.async where both ends and the size allow, else 4-byte.
__device__ __forceinline__ void stage(void* dst, const void* src, int bytes,
                                      int lane) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const char* s = static_cast<const char*>(src);
  if ((((uintptr_t)src | (uintptr_t)d | (unsigned)bytes) & 15u) == 0) {
    for (int o = 16 * lane; o < bytes; o += 16 * kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + o),
                   "l"(s + o)
                   : "memory");
  } else {
    for (int o = 4 * lane; o < bytes; o += 4 * kThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + o),
                   "l"(s + o)
                   : "memory");
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
compose_grads_kernel(Plan p, int R, const int* __restrict__ ints,
                     const float* __restrict__ smu,
                     const float* __restrict__ svar, float lam,
                     float* __restrict__ out, float* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x, lane = threadIdx.x;
  const int S = p.v[kS];
  const int* I;
  float* F;
  const float* mu;
  const float* var;
  if (kSmem) {
    I = reinterpret_cast<const int*>(smem);
    F = reinterpret_cast<float*>(smem + 4 * (size_t)p.v[kInts]);
    stage(smem, ints, 4 * p.v[kInts], lane);
    stage(F + p.v[kFMu], smu + (size_t)r * S, 4 * S, lane);
    stage(F + p.v[kFVar], svar + (size_t)r * S, 4 * S, lane);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    mu = F + p.v[kFMu];
    var = F + p.v[kFVar];
  } else {
    I = ints;
    F = ws + (size_t)r * p.v[kFloats];
    mu = smu + (size_t)r * S;
    var = svar + (size_t)r * S;
  }
  const int* lvl_off = I + p.v[kOffLvl];
  const int* nodes = I + p.v[kOffNodes];
  const int* pred_off = I + p.v[kOffPredOff];
  const int* pred_idx = I + p.v[kOffPredIdx];
  const int* fbase = I + p.v[kOffFbase];
  const int* sinks = I + p.v[kOffSinks];
  const int* mref_off = I + p.v[kOffMrefOff];
  const int* mref = I + p.v[kOffMref];
  const int* vref_off = I + p.v[kOffVrefOff];
  const int* vref = I + p.v[kOffVref];
  const int* lst_off = I + p.v[kOffLstOff];
  const int* lst = I + p.v[kOffLst];
  const int n_levels = p.v[kLevels], n_sinks = p.v[kSinks];
  State st;
  st.cm = F + p.v[kFCm];
  st.cv = F + p.v[kFCv];
  st.gm = F + p.v[kFU];
  st.gv = st.gm + S + 1;
  st.emu = st.gv + S + 1;
  st.ev = st.emu + 5 * p.v[kFolds];
  st.rec = reinterpret_cast<Rec*>(F + p.v[kFRec]);

  // the fold steps of group g (a level's joins, then the sinks' fold) as
  // (fold edge, item, first step) across the lanes: the item sides before
  // the folds, the edges after their reverse
  auto items_of = [&](int g) {
    for (int t = lst_off[g] + lane; t < lst_off[g + 1]; t += kThreads) {
      const int e = lst[3 * t], it = lst[3 * t + 1];
      fold_item(st.cm[it], st.cv[it], st.rec[e]);
    }
    __syncwarp();
  };
  auto edges_of = [&](int g) {
    for (int t = lst_off[g] + lane; t < lst_off[g + 1]; t += kThreads) {
      const int e = lst[3 * t];
      fold_edges(st.rec[e], lst[3 * t + 2] != 0, st.emu + 5 * e, st.ev + e,
                 st.emu + 5 * (e - 1), st.ev + e - 1);
    }
    __syncwarp();
  };

  // forward, a level at a time: the lanes take its nodes
  for (int L = 0; L < n_levels; ++L) {
    if (lst_off[L + 1] > lst_off[L]) items_of(L);
    for (int t = lvl_off[L] + lane; t < lvl_off[L + 1]; t += kThreads) {
      const int i = nodes[t];
      const int p0 = pred_off[i], w = pred_off[i + 1] - p0;
      if (w == 0) {
        st.cm[i] = mu[i];
        st.cv[i] = var[i];
        continue;
      }
      float m, v;
      if (w == 1) {
        m = st.cm[pred_idx[p0]];
        v = st.cv[pred_idx[p0]];
      } else {
        fold_fwd(st, pred_idx + p0, w, fbase[i], m, v);
      }
      st.cm[i] = m + mu[i];
      st.cv[i] = v + var[i];
    }
    __syncwarp();
  }
  // the sinks and the loss; d loss / d (mk_mu, mk_var) = (1, lam), the
  // cotangent source S of a single sink
  if (n_sinks > 1) items_of(n_levels);
  if (lane == 0) {
    float mk_m, mk_v;
    if (n_sinks == 1) {
      mk_m = st.cm[sinks[0]];
      mk_v = st.cv[sinks[0]];
    } else {
      fold_fwd(st, sinks, n_sinks, p.v[kSinkBase], mk_m, mk_v);
    }
    out[r] = mk_m + lam * mk_v;
    st.gm[S] = 1.f;
    st.gv[S] = lam;
  }
  __syncwarp();
  // what only the reverse reads, every step across the lanes
  for (int t = lane; t < lst_off[n_levels + 1]; t += kThreads)
    fold_after(st.rec[lst[3 * t]]);
  __syncwarp();
  if (n_sinks > 1) {
    if (lane == 0) fold_bwd(st, n_sinks, p.v[kSinkBase], 1.f, lam);
    __syncwarp();
    edges_of(n_levels);
  }
  // reverse, a level at a time from the last: a node's consumers sit on
  // later levels, so its cotangent is complete
  for (int L = n_levels - 1; L >= 0; --L) {
    for (int t = lvl_off[L] + lane; t < lvl_off[L + 1]; t += kThreads) {
      const int i = nodes[t];
      const float g = take(st.gm, mref, mref_off[i], mref_off[i + 1]);
      const float h = take(st.gm, vref, vref_off[i], vref_off[i + 1]);
      st.gm[i] = g;
      st.gv[i] = h;
      const int w = pred_off[i + 1] - pred_off[i];
      if (w > 1) fold_bwd(st, w, fbase[i], g, h);
    }
    __syncwarp();
    if (lst_off[L + 1] > lst_off[L]) edges_of(L);
  }
  float* g_mu = out + R + (size_t)r * S;
  float* g_var = out + R + (size_t)R * S + (size_t)r * S;
  for (int i = lane; i < S; i += kThreads) {
    g_mu[i] = st.gm[i];
    g_var[i] = st.gv[i];
  }
}

}  // namespace

// R rows of S stages. hdr: the plan's header on the host (kHeader ints,
// kernels/compose.py HEADER); ints: its int32 sections on the card (hdr
// kInts of them); smu, svar (R, S) row-major; out: R + 2 R S floats
// (losses, g_mu, g_var); ws: R * hdr[kFloats] floats where hdr[kSmemBytes]
// is 0 (the state in device memory), else unused. Returns
// cudaGetLastError().
extern "C" int compose_grads_launch(int R, const int* hdr, const int* ints,
                                    const float* smu, const float* svar,
                                    float lam, float* out, float* ws,
                                    cudaStream_t stream) {
  Plan p;
  for (int k = 0; k < kHeader; ++k) p.v[k] = hdr[k];
  if (R <= 0 || p.v[kS] <= 0) return 0;
  const int smem = p.v[kSmemBytes];
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem == 0) {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    compose_grads_kernel<false><<<R, kThreads, 0, stream>>>(
        p, R, ints, smu, svar, lam, out, ws);
    return (int)cudaGetLastError();
  }
  static int opted = 0;   // the dynamic shared memory opted into so far
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        compose_grads_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  compose_grads_kernel<true><<<R, kThreads, smem, stream>>>(
      p, R, ints, smu, svar, lam, out, ws);
  return (int)cudaGetLastError();
}
