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
// Outputs: losses (R,), g_mu = dloss/dsmu and g_var = dloss/dsvar (R, S).
//
// What bounds it: neither bytes nor operations. A row is one dependency
// chain of S adds and (joins + sinks) folds of ~40 float32 operations
// (an erf, an exp, three square roots, a division), walked forward and
// back: at S = 512 (a 170-way join) ~700 folds, a few hundred microseconds
// of one thread's latency, against the ~1700 eager torch operations of a
// step at S = 32 that it replaces (22-33 ms of host time). Design: one
// thread per row, R rows in warps of 32 (the solver's R is 1-20); the node
// completions and the accumulator entering each fold step live in a
// node-major scratch (index * R + r), so a warp's rows read neighbouring
// words; the backward recomputes each fold's intermediates from the stored
// accumulator and item, which is the forward's arithmetic bit for bit
// (built with --fmad=false, as the plain version's torch operations round
// each step). The order of the adds matters: a fold's cotangent of the
// cdf is a difference of nearly equal products, so a different order moves
// the gradient by ~1e-5 relative at 512 stages. No atomics: each row's
// sums run in one fixed order, so the result depends on the inputs alone.
#include <cuda_runtime.h>

namespace {

constexpr float kVarFloor = 1e-18f;             // _fold_max's clamp
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;
constexpr int kThreads = 32;

// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return (x != x) ? x : (x < lo ? lo : x);
}

// One Clark fold max(X1, X2), X_i ~ N(mu_i, v_i) after the fold's
// sqrt(clamp_min(v, 1e-18)), as core/maxstat.py::clark_max_moments_2 and
// workflow/dag.py::_fold_max compute it, every intermediate kept for the
// reverse pass.
struct Fold {
  float s1, s2, a2, a, den, d, alpha, u, ha, ex, cdf, pdf, omc, m1, A, B,
      sum12, Cc, vr, v;
  bool ok;
};

__device__ __forceinline__ void clark_fwd(float mu1, float v1, float mu2,
                                          float v2, Fold& f) {
  f.s1 = sqrtf(clamp_lo(v1, kVarFloor));
  f.s2 = sqrtf(clamp_lo(v2, kVarFloor));
  f.a2 = f.s1 * f.s1 + f.s2 * f.s2;
  f.a = sqrtf(clamp_lo(f.a2, 0.f));
  f.ok = f.a > 0.f;
  f.den = f.ok ? f.a : 1.f;
  f.d = mu1 - mu2;
  f.alpha = f.d / f.den;
  f.u = f.alpha * kInvSqrt2;
  const float P = 0.5f * (1.f + erff(f.u));
  f.ha = -0.5f * f.alpha;
  f.ex = expf(f.ha * f.alpha);
  const float ph = f.ex * kInvSqrt2Pi;
  f.cdf = f.ok ? P : (mu1 >= mu2 ? 1.f : 0.f);
  f.pdf = f.ok ? ph : 0.f;
  f.omc = 1.f - f.cdf;
  f.m1 = (mu1 * f.cdf + mu2 * f.omc) + f.a * f.pdf;
  f.A = mu1 * mu1 + f.s1 * f.s1;
  f.B = mu2 * mu2 + f.s2 * f.s2;
  f.sum12 = mu1 + mu2;
  f.Cc = f.sum12 * f.a;
  const float m2 = (f.A * f.cdf + f.B * f.omc) + f.Cc * f.pdf;
  f.vr = m2 - f.m1 * f.m1;
  f.v = clamp_lo(f.vr, 0.f);
}

// The cotangents one fold step sends back, one per edge of the plain
// version's autograd graph, in the order its engine adds them into a
// tensor's buffer (reverse creation order: the last consumer first, and
// both edges of an x * x in turn).
struct FoldGrads {
  float mu1[5];   // (mu1 + mu2), mu1 mu1 (two edges), mu1 cdf, mu1 - mu2
  float mu2[5];   // (mu1 + mu2), mu2 mu2 (two edges), mu2 (1 - cdf), -
  float v1, v2;   // through sqrt(clamp_min(v, 1e-18))
};

// The reverse of one fold step from the cotangents of its (m1, v); gm
// already holds what the step's later consumers sent to m1.
__device__ __forceinline__ void clark_bwd(float mu1, float v1, float mu2,
                                          float v2, const Fold& f, float gm,
                                          float gv, FoldGrads& o) {
  // v = clamp_min(m2 - m1 m1, 0)
  const float g_m2 = f.vr >= 0.f ? gv : 0.f;
  const float g_mm = -g_m2;
  const float g_m1 = (gm + g_mm * f.m1) + g_mm * f.m1;
  // m2 = (A cdf + B (1 - cdf)) + ((mu1 + mu2) a) pdf
  const float g_y9 = g_m2 * f.pdf;          // of (mu1 + mu2) a
  const float g_y8 = g_y9 * f.a;            // of mu1 + mu2
  const float g_A = g_m2 * f.cdf;
  const float g_B = g_m2 * f.omc;
  // cdf feeds, last first: 1 - cdf (m2), A cdf, 1 - cdf (m1), mu1 cdf
  float g_cdf = -(g_m2 * f.B);
  g_cdf = g_cdf + g_m2 * f.A;
  g_cdf = g_cdf + -(g_m1 * mu2);
  g_cdf = g_cdf + g_m1 * mu1;
  // pdf feeds ((mu1 + mu2) a) pdf, then a pdf
  const float g_pdf = g_m2 * f.Cc + g_m1 * f.a;
  // the where at a == 0 passes nothing to Phi and phi
  const float g_P = f.ok ? g_cdf : 0.f;
  const float g_ph = f.ok ? g_pdf : 0.f;
  // phi = exp((-0.5 alpha) alpha) / sqrt(2 pi); Phi = 0.5 (1 + erf(u))
  const float g_q = (g_ph * kInvSqrt2Pi) * f.ex;
  float g_alpha = g_q * f.ha + (g_q * f.alpha) * -0.5f;
  const float g_e = g_P * 0.5f;
  const float g_u = (expf(-(f.u * f.u)) * kTwoOverSqrtPi) * g_e;
  g_alpha = g_alpha + g_u * kInvSqrt2;
  // alpha = d / den, den = where(ok, a, 1)
  const float g_d = g_alpha / f.den;
  const float g_den = -g_alpha * ((f.d / f.den) / f.den);
  // a feeds ((mu1 + mu2) a), a pdf, where(ok, a, 1)
  float g_a = g_y9 * f.sum12;
  g_a = g_a + g_m1 * f.pdf;
  g_a = g_a + (f.ok ? g_den : 0.f);
  // a = sqrt(clamp_min(s1 s1 + s2 s2, 0))
  const float g_ca = g_a / (2.f * f.a);
  const float g_a2 = f.a2 >= 0.f ? g_ca : 0.f;
  // s1 feeds s1 s1 in A (two edges), then s1 s1 in a2 (two edges)
  float g_s1 = g_A * f.s1;
  g_s1 = g_s1 + g_A * f.s1;
  g_s1 = g_s1 + g_a2 * f.s1;
  g_s1 = g_s1 + g_a2 * f.s1;
  float g_s2 = g_B * f.s2;
  g_s2 = g_s2 + g_B * f.s2;
  g_s2 = g_s2 + g_a2 * f.s2;
  g_s2 = g_s2 + g_a2 * f.s2;
  // s = sqrt(clamp_min(v, 1e-18))
  o.v1 = v1 >= kVarFloor ? g_s1 / (2.f * f.s1) : 0.f;
  o.v2 = v2 >= kVarFloor ? g_s2 / (2.f * f.s2) : 0.f;
  o.mu1[0] = g_y8;
  o.mu1[1] = g_A * mu1;
  o.mu1[2] = g_A * mu1;
  o.mu1[3] = g_m1 * f.cdf;
  o.mu1[4] = g_d;
  o.mu2[0] = g_y8;
  o.mu2[1] = g_B * mu2;
  o.mu2[2] = g_B * mu2;
  o.mu2[3] = g_m1 * f.omc;
  o.mu2[4] = -g_d;
}

// The rows' completion moments, node-major: index * R + r.
struct Row {
  int R, r;
  float* cm;       // (S, R) completion means
  float* cv;       // (S, R) completion variances
  float* fm;       // (steps, R) the accumulator entering each fold step
  float* fv;
  float* gm;       // this row's cotangents of the completions, (S,)
  float* gv;
};

// Fold the completions of `items` (w of them) left to right; step k of
// the whole walk stores the accumulator it starts from.
__device__ void fold_fwd(const Row& row, const int* items, int w, int& step,
                         float& m, float& v) {
  const int R = row.R, r = row.r;
  m = row.cm[items[0] * R + r];
  v = row.cv[items[0] * R + r];
  for (int j = 1; j < w; ++j, ++step) {
    row.fm[step * R + r] = m;
    row.fv[step * R + r] = v;
    Fold f;
    clark_fwd(m, v, row.cm[items[j] * R + r], row.cv[items[j] * R + r], f);
    m = f.m1;
    v = f.v;
  }
}

// The same fold backward: its steps are the last `w - 1` before `step`.
// Each cotangent is added into its buffer edge by edge, as the plain
// version's autograd adds it: an item's completion may already hold what
// its later consumers sent; the accumulator between two steps starts
// empty.
__device__ void fold_bwd(const Row& row, const int* items, int w, int& step,
                         float gm, float gv) {
  const int R = row.R, r = row.r;
  for (int j = w - 1; j >= 1; --j) {
    --step;
    const float m = row.fm[step * R + r], v = row.fv[step * R + r];
    const int it = items[j];
    const float mu2 = row.cm[it * R + r], v2 = row.cv[it * R + r];
    Fold f;
    clark_fwd(m, v, mu2, v2, f);
    FoldGrads o;
    clark_bwd(m, v, mu2, v2, f, gm, gv, o);
    for (int e = 0; e < 5; ++e) row.gm[it] = row.gm[it] + o.mu2[e];
    row.gv[it] = row.gv[it] + o.v2;
    if (j > 1) {
      gm = o.mu1[0];
      for (int e = 1; e < 5; ++e) gm = gm + o.mu1[e];
      gv = o.v1;
    } else {
      for (int e = 0; e < 5; ++e)
        row.gm[items[0]] = row.gm[items[0]] + o.mu1[e];
      row.gv[items[0]] = row.gv[items[0]] + o.v1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
compose_grads_kernel(int R, int S, const int* __restrict__ topo,
                     const int* __restrict__ pred_off,
                     const int* __restrict__ pred_idx,
                     const int* __restrict__ sinks, int n_sinks, int n_steps,
                     const float* __restrict__ smu,
                     const float* __restrict__ svar, float lam,
                     float* __restrict__ losses, float* __restrict__ g_mu,
                     float* __restrict__ g_var, float* __restrict__ scratch) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  Row row;
  row.R = R;
  row.r = r;
  row.cm = scratch;
  row.cv = scratch + (size_t)S * R;
  row.fm = scratch + (size_t)2 * S * R;
  row.fv = row.fm + (size_t)n_steps * R;
  row.gm = g_mu + (size_t)r * S;
  row.gv = g_var + (size_t)r * S;
  const float* mu = smu + (size_t)r * S;
  const float* var = svar + (size_t)r * S;

  // forward: completions in topological order, then the sinks
  int step = 0;
  for (int t = 0; t < S; ++t) {
    const int i = topo[t];
    const int p0 = pred_off[i], w = pred_off[i + 1] - p0;
    row.gm[i] = 0.f;
    row.gv[i] = 0.f;
    if (w == 0) {
      row.cm[i * R + r] = mu[i];
      row.cv[i * R + r] = var[i];
      continue;
    }
    float m, v;
    if (w == 1) {
      m = row.cm[pred_idx[p0] * R + r];
      v = row.cv[pred_idx[p0] * R + r];
    } else {
      fold_fwd(row, pred_idx + p0, w, step, m, v);
    }
    row.cm[i * R + r] = m + mu[i];
    row.cv[i * R + r] = v + var[i];
  }
  float mk_m, mk_v;
  if (n_sinks == 1) {
    mk_m = row.cm[sinks[0] * R + r];
    mk_v = row.cv[sinks[0] * R + r];
  } else {
    fold_fwd(row, sinks, n_sinks, step, mk_m, mk_v);
  }
  losses[r] = mk_m + lam * mk_v;

  // reverse: d loss / d (mk_mu, mk_var) = (1, lam), then the nodes in
  // reverse topological order (a node's cotangent is complete once every
  // successor has passed its share back)
  if (n_sinks == 1) {
    row.gm[sinks[0]] += 1.f;
    row.gv[sinks[0]] += lam;
  } else {
    fold_bwd(row, sinks, n_sinks, step, 1.f, lam);
  }
  for (int t = S - 1; t >= 0; --t) {
    const int i = topo[t];
    const int p0 = pred_off[i], w = pred_off[i + 1] - p0;
    if (w == 0) continue;
    if (w == 1) {
      row.gm[pred_idx[p0]] += row.gm[i];
      row.gv[pred_idx[p0]] += row.gv[i];
    } else {
      fold_bwd(row, pred_idx + p0, w, step, row.gm[i], row.gv[i]);
    }
  }
}

}  // namespace

// R rows of S stages; the structure as int32 arrays on the card: topo (S),
// pred_off (S + 1) and pred_idx (pred_off[S]) in fold order, sinks
// (n_sinks); n_steps = the fold steps of one row (the joins' predecessors
// less one each, plus n_sinks - 1 when n_sinks > 1). scratch holds
// (2 S + 2 n_steps) R floats. Returns cudaGetLastError().
extern "C" int compose_grads_launch(int R, int S, const int* topo,
                                    const int* pred_off, const int* pred_idx,
                                    const int* sinks, int n_sinks,
                                    int n_steps, const float* smu,
                                    const float* svar, float lam,
                                    float* losses, float* g_mu, float* g_var,
                                    float* scratch, cudaStream_t stream) {
  if (R <= 0 || S <= 0) return 0;
  const int blocks = (R + kThreads - 1) / kThreads;
  compose_grads_kernel<<<blocks, kThreads, 0, stream>>>(
      R, S, topo, pred_off, pred_idx, sinks, n_sinks, n_steps, smu, svar, lam,
      losses, g_mu, g_var, scratch);
  return (int)cudaGetLastError();
}
