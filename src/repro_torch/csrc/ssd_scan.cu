// Mamba2 SSD (state-space duality) chunked scan.
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
// Head h reads B/C group h / (H / G). Every product and sum is float32;
// y is stored in x's dtype. Unlike the Pallas kernel, this one
//   * writes the (B, H, P, N) float32 state after the last token when the
//     caller passes a buffer for it (the prefill path needs it: the JAX
//     package falls back to its XLA scan there);
//   * takes any S: rows of the ragged last chunk past S load as dt = 0,
//     x = 0, B = C = 0, which leaves the state unchanged (the meaning of
//     the XLA path's padding), and their y is not stored;
//   * reads x, B and C through their batch, sequence and head/group
//     strides (unit stride on the last axis), so the model's B and C,
//     views of one (B, S, 2 G N) projection, pass without a copy.
//
// What bounds it on the H100: at the serving path's short prompts, bytes,
// and most of them the final state (32 KB per (b, h) against ~2 KB of
// inputs); at long S, operations: per chunk and head ~L(L+1)/2 (N + P) +
// 2 L N P multiply-adds, which a tensor-core (wgmma) design would run at the
// bf16 rate. This first kernel is simple and right instead: one block of
// 256 threads per (b, h) walks its chunks in order with the (P, N) state in
// shared memory, and runs the three products on CUDA cores in float32 with
// a register block of TB rows per thread. The chunk's B, C (L x N) and x
// (L x P) tiles are widened to float32 in shared memory, rows of B, C and
// the state padded to N + 1 words so that neighbouring threads hit
// neighbouring banks; the L x L score tile g is built RB rows at a time
// (L = 128, P = 64, N = 128 take 211 KB of the 227 KB a block may have).
// There are B * H blocks: at B = 1 and H = 80 most SMs are idle; splitting
// the chunk walk across blocks is later work.
//
// Repeatability: no atomics; every output is summed by one thread in a
// fixed order, and the cumsum is one thread's sequential sum with its
// products and adds rounded separately, so two runs give the same bits.
#include "dtype.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RB = 32;  // rows of the score tile g built at a time
constexpr int TB = 4;   // rows (t or p) of a thread's register block

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;
  void* y;
  float* state_out;  // nullptr: the caller does not want the final state
  int B, S, H, P, G, N, L;
  long long xs_b, xs_s, xs_h;  // strides of x, in elements (P: 1)
  long long ds_b, ds_s;        // strides of dt (H: 1)
  long long bs_b, bs_s, bs_g;  // strides of Bm (N: 1)
  long long cs_b, cs_s, cs_g;  // strides of Cm (N: 1)
};

__host__ __device__ inline int g_rows(int L) {
  const int r = L < RB ? L : RB;
  return (r + TB - 1) / TB * TB;
}

// floats of dynamic shared memory for one block
__host__ __device__ inline long long smem_floats(int L, int P, int N) {
  const long long ns = N + 1;
  return (long long)P * ns + 2LL * L * ns + (long long)L * P +
         (long long)g_rows(L) * L + 3LL * L;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(Args a) {
  extern __shared__ float smem[];
  const int L = a.L, P = a.P, N = a.N, NS = N + 1;
  float* s_state = smem;           // P x NS
  float* s_C = s_state + P * NS;   // L x NS
  float* s_B = s_C + L * NS;       // L x NS
  float* s_x = s_B + L * NS;       // L x P
  float* s_g = s_x + L * P;        // g_rows(L) x L
  float* s_dt = s_g + g_rows(L) * L;
  float* s_cum = s_dt + L;
  float* s_w = s_cum + L;          // exp(cum_L - cum_s) dt_s

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int grp = h / (a.H / a.G);
  const float Ah = a.A[h], Dh = a.D[h];
  const T* xg = static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h;
  const float* dtg = a.dt + b * a.ds_b + h;
  const T* Bg = static_cast<const T*>(a.Bm) + b * a.bs_b + grp * a.bs_g;
  const T* Cg = static_cast<const T*>(a.Cm) + b * a.cs_b + grp * a.cs_g;
  const long long y_row = (long long)a.H * P;  // y is (B, S, H, P) dense
  T* yg = static_cast<T*>(a.y) + (long long)b * a.S * y_row +
          (long long)h * P;

  for (int i = threadIdx.x; i < P * NS; i += THREADS) s_state[i] = 0.f;

  const int nc = (a.S + L - 1) / L;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    const int nv = min(L, a.S - t0);  // rows of this chunk inside S
    for (int i = threadIdx.x; i < L * N; i += THREADS) {
      const int t = i / N, n = i - t * N;
      float bv = 0.f, cv = 0.f;
      if (t < nv) {
        bv = to_f32(Bg[(t0 + t) * a.bs_s + n]);
        cv = to_f32(Cg[(t0 + t) * a.cs_s + n]);
      }
      s_B[t * NS + n] = bv;
      s_C[t * NS + n] = cv;
    }
    for (int i = threadIdx.x; i < L * P; i += THREADS) {
      const int t = i / P, p = i - t * P;
      s_x[i] = t < nv ? to_f32(xg[(t0 + t) * a.xs_s + p]) : 0.f;
    }
    for (int t = threadIdx.x; t < L; t += THREADS)
      s_dt[t] = t < nv ? dtg[(t0 + t) * a.ds_s] : 0.f;
    __syncthreads();
    if (threadIdx.x == 0) {
      // a = dt * A, then its running sum, each rounded on its own (no FMA)
      float run = 0.f;
      for (int t = 0; t < L; ++t) {
        run = __fadd_rn(run, __fmul_rn(s_dt[t], Ah));
        s_cum[t] = run;
      }
    }
    __syncthreads();
    const float cum_last = s_cum[L - 1];
    for (int s = threadIdx.x; s < L; s += THREADS)
      s_w[s] = expf(cum_last - s_cum[s]) * s_dt[s];

    // y, RB rows of g at a time; rows past S are neither built nor stored
    for (int r0 = 0; r0 < nv; r0 += RB) {
      const int rn = min(RB, nv - r0);
      const int groups = (rn + TB - 1) / TB;
      const int cols = r0 + rn;  // g[t, s] is 0 for s > t
      for (int i = threadIdx.x; i < groups * cols; i += THREADS) {
        const int tg = i / cols, s = i - tg * cols;
        const int t1 = r0 + tg * TB;  // first row of the register block
        float acc[TB];
#pragma unroll
        for (int j = 0; j < TB; ++j) acc[j] = 0.f;
        if (s < t1 + TB) {
          const float* bs = s_B + s * NS;
          const float* cr[TB];
#pragma unroll
          for (int j = 0; j < TB; ++j) cr[j] = s_C + min(t1 + j, L - 1) * NS;
          for (int n = 0; n < N; ++n) {
            const float bv = bs[n];
#pragma unroll
            for (int j = 0; j < TB; ++j) acc[j] = fmaf(cr[j][n], bv, acc[j]);
          }
        }
        const float dts = s_dt[s], cs = s_cum[s];
#pragma unroll
        for (int j = 0; j < TB; ++j) {
          const int t = t1 + j;
          if (t < cols)
            s_g[(t - r0) * L + s] =
                s <= t ? acc[j] * expf(fminf(s_cum[t] - cs, 0.f)) * dts : 0.f;
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < groups * P; i += THREADS) {
        const int tg = i / P, p = i - tg * P;
        const int tl = tg * TB, t1 = r0 + tl;
        float intra[TB], inter[TB];
#pragma unroll
        for (int j = 0; j < TB; ++j) intra[j] = inter[j] = 0.f;
        const int s_end = min(t1 + TB, cols);
        for (int s = 0; s < s_end; ++s) {
          const float xv = s_x[s * P + p];
#pragma unroll
          for (int j = 0; j < TB; ++j)
            intra[j] = fmaf(s_g[(tl + j) * L + s], xv, intra[j]);
        }
        const float* cr[TB];
#pragma unroll
        for (int j = 0; j < TB; ++j) cr[j] = s_C + min(t1 + j, L - 1) * NS;
        const float* st = s_state + p * NS;
        for (int n = 0; n < N; ++n) {
          const float sv = st[n];
#pragma unroll
          for (int j = 0; j < TB; ++j) inter[j] = fmaf(cr[j][n], sv, inter[j]);
        }
#pragma unroll
        for (int j = 0; j < TB; ++j) {
          const int t = t1 + j;
          if (t < cols) {
            const float v = expf(s_cum[t]) * inter[j] + intra[j] +
                            Dh * s_x[t * P + p];
            yg[(long long)(t0 + t) * y_row + p] = from_f32<T>(v);
          }
        }
      }
      __syncthreads();  // s_g is rebuilt for the next rows
    }

    // state' = exp(cum_L) state + sum_s x_s (x) B_s w_s; rows past S have
    // w = 0 and are skipped
    const float decay = expf(cum_last);
    const int pgroups = (P + TB - 1) / TB;
    for (int i = threadIdx.x; i < pgroups * N; i += THREADS) {
      const int pg = i / N, n = i - pg * N;
      const int p1 = pg * TB;
      float acc[TB];
#pragma unroll
      for (int j = 0; j < TB; ++j) acc[j] = 0.f;
      for (int s = 0; s < nv; ++s) {
        const float bw = s_B[s * NS + n] * s_w[s];
        const float* xr = s_x + s * P;
#pragma unroll
        for (int j = 0; j < TB; ++j)
          acc[j] = fmaf(xr[min(p1 + j, P - 1)], bw, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        const int p = p1 + j;
        if (p < P) s_state[p * NS + n] = decay * s_state[p * NS + n] + acc[j];
      }
    }
    __syncthreads();  // the next chunk overwrites the tiles
  }

  if (a.state_out != nullptr) {
    float* so = a.state_out + ((long long)b * a.H + h) * P * N;
    for (int i = threadIdx.x; i < P * N; i += THREADS) {
      const int p = i / N, n = i - p * N;
      so[i] = s_state[p * NS + n];
    }
  }
}

template <typename T>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  static bool configured = false;  // the opt-in limit, set once per type
  if (!configured) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  ssd_scan_kernel<T><<<(unsigned)(a.B * a.H), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs, in bytes (the wrapper checks it against
// the card's limit before a launch).
extern "C" long long ssd_scan_smem_bytes(int L, int P, int N) {
  return 4LL * smem_floats(L, P, N);
}

// x: (B, S, H, P) and Bm, Cm: (B, S, G, N), one dtype (DT_F32 / DT_BF16),
// strided with a unit last stride; dt: (B, S, H) float32 with unit H
// stride; A, D: (H,) float32; y: (B, S, H, P) dense, x's dtype; state:
// (B, H, P, N) float32 dense, or null. L = min(chunk, S). Returns
// cudaGetLastError() after the launch.
extern "C" int ssd_scan_launch(
    int dtype, const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, void* y, void* state, int B, int S, int H,
    int P, int G, int N, int L, long long xs_b, long long xs_s,
    long long xs_h, long long ds_b, long long ds_s, long long bs_b,
    long long bs_s, long long bs_g, long long cs_b, long long cs_s,
    long long cs_g, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || G <= 0 || L <= 0 ||
      H % G != 0 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm,
         Cm, static_cast<const float*>(D), y, static_cast<float*>(state),
         B, S, H, P, G, N, L, xs_b, xs_s, xs_h, ds_b, ds_s, bs_b, bs_s, bs_g,
         cs_b, cs_s, cs_g};
  const size_t smem = 4 * (size_t)smem_floats(L, P, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch<float>(a, smem, s);
  if (dtype == DT_BF16) return launch<__nv_bfloat16>(a, smem, s);
  return (int)cudaErrorInvalidValue;
}
