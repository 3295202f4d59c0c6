// The parent kernels of tools/probe_viterbi_wide.py, kept verbatim as the
// yardstick of the cluster forms that replaced them in the package:
//   * parent_fwd_wide_launch: the factored forward past SP 1024 on one CTA
//     a read, K = 2, 4 or 8 contiguous states a thread, the slot tables
//     read through __ldg every step, the emission inline, the chain scan
//     folding the warp totals in a serial loop (csrc/viterbi_fwd.cu now
//     runs viterbi_fwd_cluster_kernel there);
//   * parent_dense_launch: the dense forward's streamed mode past SP 512
//     on one CTA a read, a thread a destination column walking trans in
//     L2 with four accumulators (csrc/viterbi_dense.cu now runs a cluster
//     of CTAs a read there).
// Both give the plain twins' bits.  Not part of the package; built by the
// probe with nvcc.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEGF = -1e30f;
constexpr int ENTRY_SLOTS = 2;
constexpr int EXIT_SLOTS = 3;
constexpr int CHAIN_SLOTS = ENTRY_SLOTS + EXIT_SLOTS;
template <int D, int C>
struct Layout {
  static constexpr int DIAG = D;
  static constexpr int CHAIN = C;
  static constexpr int CHAIN_ARR = C > 0 ? C : 1;  // no zero-length arrays
};
using Chained = Layout<8, 2>;
using DiagOnly = Layout<12, 0>;
constexpr int MAX_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int order_key(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ float warp_max(float x) {
  return key_value(__reduce_max_sync(FULL, order_key(x)));
}

// SP up to 8192 with K contiguous states a thread (NT = blockDim.x
// threads, a multiple of 32 with NT * K >= SP; a thread whose states
// start at or past SP only takes part in the barriers and shuffles).
// Shared memory: two rows and the chains' h rows, (2 + CHAIN) x SP.
template <int K, class L>
__global__ void __launch_bounds__(1024)
viterbi_fwd_wide_kernel(const float* __restrict__ obs, const int* __restrict__ tact,
                        const float* __restrict__ start, const float* __restrict__ mu,
                        const float* __restrict__ sigma, const int* __restrict__ uni,
                        const float* __restrict__ luni, const float* __restrict__ lsig,
                        const int* __restrict__ src, const float* __restrict__ wts,
                        const float* __restrict__ ramp, int n_chain, float* __restrict__ sc,
                        float* __restrict__ fin, float* __restrict__ acc_out, int B, int T,
                        int SP) {
  constexpr int DIAG_SLOTS = L::DIAG;
  constexpr int NC = L::CHAIN;
  constexpr int NCA = L::CHAIN_ARR;
  extern __shared__ __align__(16) float smem[];
  float* val_sh = smem;           // 2 x SP: the rows, by step parity
  float* h_sh = val_sh + 2 * SP;  // NC x SP
  __shared__ float wmax[2][32];   // each warp's row max, by step parity
  __shared__ float wtot[NCA][32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warp = blockDim.x >> 5;
  const int v0 = tid * K;
  const bool live = v0 < SP;  // SP is a multiple of K: all K states or none
  const int ta = min(tact[b], T);
  const float* x_row = obs + (size_t)b * T;
  const bool chains = NC > 0 && n_chain > 0;

  float val[K], fin_v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) fin_v[j] = 0.0f;
  float acc = 0.0f, m = 0.0f;
  for (int t = 0; t < ta; ++t) {
    const int P = t & 1;
    const float x = __ldg(x_row + t);
    float out[K];
    if (live) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int v = v0 + j;
        const float z = (x - __ldg(mu + v)) / __ldg(sigma + v);
        const float emit = __ldg(uni + v) ? __ldg(luni + v) : (__ldg(lsig + v) - (0.5f * z) * z);
        val[j] = emit;  // the emission, until the transitions are in
        out[j] = NEGF;
      }
    }
    if (t == 0) {
      if (live) {
#pragma unroll
        for (int j = 0; j < K; ++j) val[j] = __ldg(start + v0 + j) + val[j];
      }
    } else {
      const float* prev = val_sh + (P ^ 1) * SP;  // the previous row: st = val - m
      if (live) {
        for (int d = 0; d < DIAG_SLOTS; ++d)
#pragma unroll
          for (int j = 0; j < K; ++j)
            out[j] = fmaxf(out[j], (prev[__ldg(src + d * SP + v0 + j)] - m) +
                                       __ldg(wts + d * SP + v0 + j));
      }
      if (chains) {
        float xs[NCA][K], pre[NCA];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int base = DIAG_SLOTS + c * CHAIN_SLOTS;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            float inj = NEGF;
            if (live) {
              for (int e = 0; e < ENTRY_SLOTS; ++e)
                inj = fmaxf(inj, (prev[__ldg(src + (base + e) * SP + v0 + j)] - m) +
                                     __ldg(wts + (base + e) * SP + v0 + j));
              xs[c][j] = inj - __ldg(ramp + c * SP + v0 + j);
            } else {
              xs[c][j] = -INFINITY;
            }
          }
          // the thread's own states in order, then its total over the warp
#pragma unroll
          for (int j = 1; j < K; ++j) xs[c][j] = fmaxf(xs[c][j], xs[c][j - 1]);
          float incl = xs[c][K - 1];
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) incl = fmaxf(incl, __shfl_up_sync(FULL, incl, d));
          const float below_lane = __shfl_up_sync(FULL, incl, 1);
          pre[c] = lane ? below_lane : -INFINITY;
          if (lane == 31) wtot[c][warp] = incl;
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          for (int w = 0; w < warp; ++w) pre[c] = fmaxf(pre[c], wtot[c][w]);
          if (live) {
#pragma unroll
            for (int j = 0; j < K; ++j)
              h_sh[c * SP + v0 + j] = fmaxf(xs[c][j], pre[c]) + __ldg(ramp + c * SP + v0 + j);
          }
        }
        __syncthreads();
        if (live) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int base = DIAG_SLOTS + c * CHAIN_SLOTS + ENTRY_SLOTS;
            for (int e = 0; e < EXIT_SLOTS; ++e)
#pragma unroll
              for (int j = 0; j < K; ++j)
                out[j] = fmaxf(out[j], h_sh[c * SP + __ldg(src + (base + e) * SP + v0 + j)] +
                                           __ldg(wts + (base + e) * SP + v0 + j));
          }
        }
      }
      if (live) {
#pragma unroll
        for (int j = 0; j < K; ++j) val[j] = out[j] + val[j];
      }
    }
    float lm = -INFINITY;
    if (live) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        val_sh[P * SP + v0 + j] = val[j];
        lm = fmaxf(lm, val[j]);
      }
    }
    lm = warp_max(lm);
    if (lane == 0) wmax[P][warp] = lm;
    __syncthreads();
    m = -INFINITY;
    for (int w = 0; w < n_warp; ++w) m = fmaxf(m, wmax[P][w]);
    acc = acc + m;
    if (live) {
      float* sc_t = sc + ((size_t)t * B + b) * SP + v0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float stn = val[j] - m;
        if (t == ta - 1) fin_v[j] = stn;
        __stcs(sc_t + j, stn);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < K; ++j) fin[(size_t)b * SP + v0 + j] = fin_v[j];
  }
  if (tid == 0) acc_out[b] = acc;
}

template <int K, class L>
int launch_wide(const void* obs, const void* tact, const void* start, const void* mu,
                const void* sigma, const void* uni, const void* luni, const void* lsig,
                const void* src, const void* wts, const void* ramp, int n_chain, void* sc,
                void* fin, void* acc, int B, int T, int SP, cudaStream_t stream) {
  auto kernel = viterbi_fwd_wide_kernel<K, L>;
  const int threads = (SP / K + 31) / 32 * 32;
  const size_t shmem = (size_t)(2 + L::CHAIN) * SP * sizeof(float);  // 128 KB at SP 8192
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, threads, shmem, stream>>>(
      (const float*)obs, (const int*)tact, (const float*)start, (const float*)mu,
      (const float*)sigma, (const int*)uni, (const float*)luni, (const float*)lsig,
      (const int*)src, (const float*)wts, (const float*)ramp, n_chain, (float*)sc, (float*)fin,
      (float*)acc, B, T, SP);
  return (int)cudaGetLastError();
}

// whether the slot counts fit layout L
template <class L>
bool counts_fit(const int* h) {
  const int n_diag = h[0], n_chain = h[1];
  bool ok = n_diag >= 0 && n_diag <= L::DIAG && n_chain >= 0 && n_chain <= L::CHAIN;
  for (int c = 0; c < n_chain && c < L::CHAIN; ++c) {
    const int n_entry = h[2 + 2 * c], n_exit = h[3 + 2 * c];
    ok = ok && n_entry >= 0 && n_entry <= ENTRY_SLOTS && n_exit >= 0 && n_exit <= EXIT_SLOTS;
  }
  return ok;
}

template <class L>
int check_and_launch_wide(const void* obs, const void* tact, const void* start, const void* mu,
                          const void* sigma, const void* uni, const void* luni,
                          const void* lsig, const void* src, const void* wts, const void* ramp,
                          const int* h, void* sc, void* fin, void* acc, int B, int T, int SP,
                          cudaStream_t stream) {
  if (SP % 128 != 0 || SP <= 1024 || SP > 8192 || !counts_fit<L>(h))
    return (int)cudaErrorInvalidValue;
  const int n_chain = h[1];
#define FWD_ARGS obs, tact, start, mu, sigma, uni, luni, lsig, src, wts, ramp, n_chain, sc, fin, \
                 acc, B, T, SP, stream
  if (SP <= 2048) return launch_wide<2, L>(FWD_ARGS);
  if (SP <= 4096) return launch_wide<4, L>(FWD_ARGS);
  return launch_wide<8, L>(FWD_ARGS);
#undef FWD_ARGS
}

template <int VPT>
__global__ void __launch_bounds__(MAX_THREADS)
viterbi_dense_kernel(const float* __restrict__ obs, const int* __restrict__ tact,
                     const float* __restrict__ trans, const float* __restrict__ start,
                     const float* __restrict__ mu, const float* __restrict__ sigma,
                     const int* __restrict__ uni, const float* __restrict__ luni,
                     const float* __restrict__ lsig, float* __restrict__ sc,
                     float* __restrict__ fin, float* __restrict__ acc_out, int B, int T,
                     int SP) {
  extern __shared__ float st_sh[];  // SP
  __shared__ float warp_red[32];
  const int b = blockIdx.x;
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int ta = min(tact[b], T);  // lengths past T would read past the row
  const float* x_row = obs + (size_t)b * T;

  float mu_v[VPT], sig_v[VPT], luni_v[VPT], lsig_v[VPT], start_v[VPT], st[VPT], fin_v[VPT];
  bool uni_v[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = x + k * blockDim.x;
    const bool live = v < SP;
    mu_v[k] = live ? mu[v] : 0.0f;
    sig_v[k] = live ? sigma[v] : 1.0f;
    luni_v[k] = live ? luni[v] : 0.0f;
    lsig_v[k] = live ? lsig[v] : 0.0f;
    start_v[k] = live ? start[v] : NEGF;
    uni_v[k] = live && uni[v] != 0;
    st[k] = 0.0f;
    fin_v[k] = 0.0f;
  }
  float acc = 0.0f;

  for (int t = 0; t < ta; ++t) {
    const float xt = x_row[t];
    float val[VPT];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int v = x + k * blockDim.x;
      const float z = (xt - mu_v[k]) / sig_v[k];
      const float emit = uni_v[k] ? luni_v[k] : (lsig_v[k] - (0.5f * z) * z);
      float best;
      if (t == 0) {
        best = start_v[k];
      } else if (v < SP) {
        float b0 = -INFINITY, b1 = -INFINITY, b2 = -INFINITY, b3 = -INFINITY;
        const float* col = trans + v;
        int u = 0;
        for (; u + 3 < SP; u += 4) {
          b0 = fmaxf(b0, st_sh[u] + col[(size_t)u * SP]);
          b1 = fmaxf(b1, st_sh[u + 1] + col[(size_t)(u + 1) * SP]);
          b2 = fmaxf(b2, st_sh[u + 2] + col[(size_t)(u + 2) * SP]);
          b3 = fmaxf(b3, st_sh[u + 3] + col[(size_t)(u + 3) * SP]);
        }
        for (; u < SP; ++u) b0 = fmaxf(b0, st_sh[u] + col[(size_t)u * SP]);
        best = fmaxf(fmaxf(b0, b1), fmaxf(b2, b3));
      } else {
        best = -INFINITY;
      }
      val[k] = best + emit;
      if (v < SP) mx = fmaxf(mx, val[k]);
    }
    // row max over the block
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
    if (lane == 0) warp_red[warp] = mx;
    __syncthreads();  // also: every thread is done reading st_sh for this step
    float m = warp_red[0];
    for (int w = 1; w < n_warps; ++w) m = fmaxf(m, warp_red[w]);
    acc = acc + m;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int v = x + k * blockDim.x;
      if (v >= SP) continue;
      st[k] = val[k] - m;
      if (t == ta - 1) fin_v[k] = st[k];
      st_sh[v] = st[k];
      sc[((size_t)t * B + b) * SP + v] = st[k];
    }
    __syncthreads();  // the new row is in st_sh; warp_red may be reused
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = x + k * blockDim.x;
    if (v < SP) fin[(size_t)b * SP + v] = fin_v[k];
  }
  if (x == 0) acc_out[b] = acc;
}

template <int VPT>
cudaError_t launch(const float* obs, const int* tact, const float* trans, const float* start,
                   const float* mu, const float* sigma, const int* uni, const float* luni,
                   const float* lsig, float* sc, float* fin, float* acc, int B, int T, int SP,
                   cudaStream_t stream) {
  const int threads = ((SP + VPT - 1) / VPT + 31) / 32 * 32;
  const size_t shmem = (size_t)SP * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(viterbi_dense_kernel<VPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return e;
  }
  viterbi_dense_kernel<VPT><<<B, threads, shmem, stream>>>(
      obs, tact, trans, start, mu, sigma, uni, luni, lsig, sc, fin, acc, B, T, SP);
  return cudaGetLastError();
}

}  // namespace

extern "C" int parent_fwd_wide_launch(const void* obs, const void* tact, const void* start,
                                       const void* mu, const void* sigma, const void* uni,
                                       const void* luni, const void* lsig, const void* src,
                                       const void* wts, const void* ramp, const void* counts,
                                       void* sc, void* fin, void* acc, int B, int T, int SP,
                                       int layout, void* stream) {
  const int* h = (const int*)counts;
  cudaStream_t stream_ = (cudaStream_t)stream;
  switch (layout) {
    case 0:
      return check_and_launch_wide<Chained>(obs, tact, start, mu, sigma, uni, luni, lsig, src,
                                            wts, ramp, h, sc, fin, acc, B, T, SP, stream_);
    case 1:
      return check_and_launch_wide<DiagOnly>(obs, tact, start, mu, sigma, uni, luni, lsig, src,
                                             wts, ramp, h, sc, fin, acc, B, T, SP, stream_);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int parent_dense_launch(const void* obs, const void* tact, const void* trans,
                                    const void* start, const void* mu, const void* sigma,
                                    const void* uni, const void* luni, const void* lsig,
                                    void* sc, void* fin, void* acc, int B, int T, int SP,
                                    void* stream) {
  if (SP <= 0 || SP % 128) return (int)cudaErrorInvalidValue;
  auto o = (const float*)obs;
  auto ta = (const int*)tact;
  auto tr = (const float*)trans;
  auto s0 = (const float*)start;
  auto m = (const float*)mu;
  auto sg = (const float*)sigma;
  auto un = (const int*)uni;
  auto lu = (const float*)luni;
  auto ls = (const float*)lsig;
  auto out = (float*)sc;
  auto fn = (float*)fin;
  auto ac = (float*)acc;
  auto st = (cudaStream_t)stream;
  if (SP <= 1024) return (int)launch<1>(o, ta, tr, s0, m, sg, un, lu, ls, out, fn, ac, B, T, SP, st);
  if (SP <= 2048) return (int)launch<2>(o, ta, tr, s0, m, sg, un, lu, ls, out, fn, ac, B, T, SP, st);
  if (SP <= 4096) return (int)launch<4>(o, ta, tr, s0, m, sg, un, lu, ls, out, fn, ac, B, T, SP, st);
  if (SP <= 8192) return (int)launch<8>(o, ta, tr, s0, m, sg, un, lu, ls, out, fn, ac, B, T, SP, st);
  return (int)cudaErrorInvalidValue;
}
