// Structure-factored max-plus Viterbi forward.
//
// Replaces the Pallas TPU kernel strique_tpu/ops/viterbi_pallas.py
// `_fwd_factored_kernel` (called by `viterbi_forward_pallas_factored`).
// Per read and step: transitions as lane-rolled diagonals
// roll(st + w, o)[v] = (st + w)[(v - o) mod SP] plus, per silent delete
// chain, h = cummax(inj - ramp) + ramp with its exits rolled the same
// way; then the Gaussian/uniform emission, the row max m, the rescaled
// row st = val - m (stored to sc[t, read, :]) and acc += m.
//
// What bounds it on an H100: the serial time chain -- every step waits on
// the previous row, and within a step on a block-wide prefix max per
// chain and a block max; a step is a few hundred flops over 256 lanes.
// The score-row stream (T x B x SP f32, ~0.4 GB for 64 reads of 6144
// samples) is written once, coalesced, at far below the card's
// bandwidth.
//
// Design: one CTA per read, one thread per state lane v (SP = 256 for
// the c9orf72 HMM's 216 states, SP = 128 for its mod HMM's 26); a step
// is three barriers (one with no chain) and independent shared loads:
//   * every roll's source lane u = (v - o) mod SP and weight w[u] are the
//     same at every step: the host stages them per thread
//     (viterbi_cuda.fwd_gather_tables: the layout's diagonal slots, then
//     per chain ENTRY_SLOTS entry and EXIT_SLOTS exit slots; a slot the
//     spec leaves empty has weight -inf, the identity of the max), and
//     each thread holds every slot in registers: no predicate or branch
//     in the step, so every gather's load is in flight at once.  Two
//     slot layouts are compiled, picked by the host per HMM: CHAINED (8
//     diagonals and 2 chains of 2 entries and 3 exits) fits the
//     flanked-repeat HMMs (6 or 7 diagonals, chains of 2 entries and 3
//     and 2 exits); DIAG (12 diagonals, no chain) fits the mod HMMs (11
//     diagonals), whose step has no chain scan and so one barrier.  The
//     wrapper sends a spec that fits neither to the dense forward;
//   * the row is published as val (before the rescale) behind ONE
//     barrier, and every warp then takes the row max itself (NV float4
//     reads a lane, one __reduce_max_sync on an order-preserving int key;
//     max is exact): a gather reads (val[u] - m) + w, the same f32 st[u]
//     the reference rolls; rows alternate between two buffers, so no
//     barrier guards only a reuse;
//   * all chains scan together: interleaved warp shfl_up scans, one
//     barrier for every chain's warp totals (each thread folds the totals
//     of the warps below its own from broadcast float4 reads), one
//     barrier to publish every h row;
//   * the emission is off the chain: obs is staged 32 steps at a time in
//     shared memory by cp.async, one chunk ahead, and at each chunk's
//     first step a thread computes its 32 emissions at once into its own
//     column of a shared table; it keeps the reference's expression
//     tree, lsig - (0.5*z)*z with z = (x - mu) / sigma in IEEE division
//     (lsig from the host);
//   * score rows are stored with streaming stores (__stcs).
// acc accumulates sequentially in f32, in step order.  A read stops at
// its own length: later rows are frozen in the reference and never read.
//
// Past SP 1024 (up to 8192, the dense forward's cap) one thread a state
// no longer fits a CTA, and neither does the emission table (OBS_CHUNK x
// SP floats).  The wide variant (viterbi_fwd_wide_kernel) keeps one CTA
// a read and gives each thread K contiguous states (K = 2, 4, 8 up to SP
// 2048, 4096, 8192): the slot tables, ramps and emission parameters are
// read through __ldg every step instead of held in registers, the
// emission is computed inline from one broadcast obs load a step, the
// chain scan runs each thread's K states serially before the warp and
// block scans, and the row max goes through one shared slot a warp.  It
// evaluates the same f32 expressions as the kernel above, so both give
// the plain twin's bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEGF = -1e30f;
// the host's slot layouts (viterbi_cuda.FWD_LAYOUTS, staged by
// fwd_gather_tables), the limits of a spec each takes: DIAG diagonal
// slots, then CHAIN chains of ENTRY_SLOTS entry and EXIT_SLOTS exit slots
constexpr int ENTRY_SLOTS = 2;
constexpr int EXIT_SLOTS = 3;
constexpr int CHAIN_SLOTS = ENTRY_SLOTS + EXIT_SLOTS;
template <int D, int C>
struct Layout {
  static constexpr int DIAG = D;
  static constexpr int CHAIN = C;
  static constexpr int CHAIN_ARR = C > 0 ? C : 1;  // no zero-length arrays
};
using Chained = Layout<8, 2>;  // layout 0: flanked-repeat HMMs
using DiagOnly = Layout<12, 0>;  // layout 1: mod HMMs
constexpr int OBS_CHUNK = 32;
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a shared-memory f32 at byte address `addr` + OFF
template <int OFF>
__device__ __forceinline__ float lds(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1+%2];\n" : "=f"(x) : "r"(addr), "n"(OFF));
  return x;
}

// SP = 128 NV states, one thread each, every slot of layout L held in
// registers
template <int NV, class L>
__global__ void __launch_bounds__(128 * NV)
viterbi_fwd_kernel(const float* __restrict__ obs, const int* __restrict__ tact,
                   const float* __restrict__ start, const float* __restrict__ mu,
                   const float* __restrict__ sigma, const int* __restrict__ uni,
                   const float* __restrict__ luni, const float* __restrict__ lsig,
                   const int* __restrict__ src, const float* __restrict__ wts,
                   const float* __restrict__ ramp, int n_chain, float* __restrict__ sc,
                   float* __restrict__ fin, float* __restrict__ acc_out, int B, int T) {
  constexpr int SP = 128 * NV;
  constexpr int ROW = SP * 4;  // bytes of a row
  constexpr int DIAG_SLOTS = L::DIAG;
  constexpr int NC = L::CHAIN;
  constexpr int NCA = L::CHAIN_ARR;
  extern __shared__ __align__(16) float smem[];
  float* val_sh = smem;                     // 2 x SP: the rows, by step parity
  float* h_sh = val_sh + 2 * SP;            // NC x SP
  float* emit_sh = h_sh + NC * SP;          // OBS_CHUNK x SP: a column a thread
  __shared__ __align__(16) float wtot[NCA][32];
  __shared__ float obs_sh[2][OBS_CHUNK];

  const int b = blockIdx.x;
  const int v = threadIdx.x;
  const int lane = v & 31;
  const int warp = v >> 5;
  const int ta = min(tact[b], T);  // lengths past T would read past the row
  const float* x_row = obs + (size_t)b * T;

  // shared byte addresses of every gather: a row (parity 0) and the h rows
  const uint32_t val0 = (uint32_t)__cvta_generic_to_shared(val_sh);
  const uint32_t h0 = (uint32_t)__cvta_generic_to_shared(h_sh);
  uint32_t ad[DIAG_SLOTS], ae[NCA][ENTRY_SLOTS], ax[NCA][EXIT_SLOTS];
  float wd[DIAG_SLOTS], we[NCA][ENTRY_SLOTS], wx[NCA][EXIT_SLOTS], rp[NCA];
#pragma unroll
  for (int d = 0; d < DIAG_SLOTS; ++d) {
    ad[d] = val0 + 4 * src[d * SP + v];
    wd[d] = wts[d * SP + v];
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    rp[c] = ramp[c * SP + v];
    const int base = DIAG_SLOTS + c * CHAIN_SLOTS;
#pragma unroll
    for (int e = 0; e < ENTRY_SLOTS; ++e) {
      ae[c][e] = val0 + 4 * src[(base + e) * SP + v];
      we[c][e] = wts[(base + e) * SP + v];
    }
#pragma unroll
    for (int e = 0; e < EXIT_SLOTS; ++e) {
      ax[c][e] = h0 + c * ROW + 4 * src[(base + ENTRY_SLOTS + e) * SP + v];
      wx[c][e] = wts[(base + ENTRY_SLOTS + e) * SP + v];
    }
  }
  const float mu_v = mu[v], sig_v = sigma[v], luni_v = luni[v], lsig_v = lsig[v];
  const float start_v = start[v];
  const bool uni_v = uni[v] != 0;

  // obs chunk 0 now, chunk 1 in flight
  if (v < OBS_CHUNK) {
    if (v < ta) obs_sh[0][v] = x_row[v];
    if (OBS_CHUNK + v < ta) cp_async4(&obs_sh[1][v], x_row + OBS_CHUNK + v);
    cp_async_commit();
  }
  float fin_v = 0.0f, acc = 0.0f, m = 0.0f;
  float* sc_v = sc + (size_t)b * SP + v;  // row t at sc_v + t * B * SP
  const size_t sc_step = (size_t)B * SP;
  __syncthreads();

  // one step; parity P picks the row buffers at compile time
  auto step = [&](auto parity, int t) {
    constexpr int P = decltype(parity)::value;
    const int jc = t % OBS_CHUNK;
    if (P == 0 && jc == 0) {  // a chunk starts on an even step
      const int chunk = t / OBS_CHUNK;
      if (chunk > 0 && v < OBS_CHUNK) {
        // the buffer of chunk+1 last held chunk-1, read before the last barrier
        const int tn = (chunk + 1) * OBS_CHUNK + v;
        if (tn < ta) cp_async4(&obs_sh[(chunk + 1) & 1][v], x_row + tn);
        cp_async_commit();
      }
      const float* x_chunk = obs_sh[chunk & 1];
#pragma unroll 8
      for (int j = 0; j < OBS_CHUNK; ++j) {
        const float x = t + j < ta ? x_chunk[j] : mu_v;
        const float z = (x - mu_v) / sig_v;
        emit_sh[j * SP + v] = uni_v ? luni_v : (lsig_v - (0.5f * z) * z);
      }
    }
    const float emit = emit_sh[jc * SP + v];
    float val;
    if (P == 0 && t == 0) {
      val = start_v + emit;
    } else {
      constexpr int PREV = (P ^ 1) * ROW;  // the previous row: st = val - m
      float out = NEGF;
#pragma unroll
      for (int d = 0; d < DIAG_SLOTS; ++d) out = fmaxf(out, (lds<PREV>(ad[d]) - m) + wd[d]);
      if (NC > 0 && n_chain > 0) {
        float xs[NCA];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float inj = NEGF;
#pragma unroll
          for (int e = 0; e < ENTRY_SLOTS; ++e) inj = fmaxf(inj, (lds<PREV>(ae[c][e]) - m) + we[c][e]);
          xs[c] = inj - rp[c];
        }
        // inclusive scans; a lane below d gets its own value back
#pragma unroll
        for (int d = 1; d < 32; d <<= 1)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            xs[c] = fmaxf(xs[c], __shfl_up_sync(FULL, xs[c], d));
        if (lane == 31) {
#pragma unroll
          for (int c = 0; c < NC; ++c) wtot[c][warp] = xs[c];
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          // the totals of the warps below this one: NV broadcast float4 reads
          const float4* tot4 = reinterpret_cast<const float4*>(wtot[c]);
          float below = -INFINITY;
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const float4 q = tot4[k];
            below = fmaxf(below, fmaxf(fmaxf(4 * k < warp ? q.x : -INFINITY,
                                             4 * k + 1 < warp ? q.y : -INFINITY),
                                       fmaxf(4 * k + 2 < warp ? q.z : -INFINITY,
                                             4 * k + 3 < warp ? q.w : -INFINITY)));
          }
          h_sh[c * SP + v] = fmaxf(xs[c], below) + rp[c];
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < EXIT_SLOTS; ++e) out = fmaxf(out, lds<0>(ax[c][e]) + wx[c][e]);
      }
      val = out + emit;
    }
    val_sh[P * SP + v] = val;
    if (P == 1 && jc == OBS_CHUNK - 1 && v < OBS_CHUNK) cp_async_wait_all();  // chunk+1 lands
    __syncthreads();
    const float4* row4 = reinterpret_cast<const float4*>(val_sh + P * SP) + lane;
    float lm = -INFINITY;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const float4 q = row4[32 * k];
      lm = fmaxf(lm, fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w)));
    }
    m = warp_max(lm);
    const float stn = val - m;
    acc = acc + m;
    if (t == ta - 1) fin_v = stn;
    __stcs(sc_v, stn);
    sc_v += sc_step;
  };
  for (int t = 0; t < ta; t += 2) {
    step(std::integral_constant<int, 0>{}, t);
    if (t + 1 < ta) step(std::integral_constant<int, 1>{}, t + 1);
  }
  if (v < OBS_CHUNK) cp_async_wait_all();
  fin[(size_t)b * SP + v] = fin_v;
  if (v == 0) acc_out[b] = acc;
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

template <int NV, class L>
int launch(const void* obs, const void* tact, const void* start, const void* mu,
           const void* sigma, const void* uni, const void* luni, const void* lsig,
           const void* src, const void* wts, const void* ramp, int n_chain, void* sc,
           void* fin, void* acc, int B, int T, cudaStream_t stream) {
  constexpr int SP = 128 * NV;
  auto kernel = viterbi_fwd_kernel<NV, L>;
  const size_t shmem = (size_t)(2 + L::CHAIN + OBS_CHUNK) * SP * sizeof(float);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, SP, shmem, stream>>>(
      (const float*)obs, (const int*)tact, (const float*)start, (const float*)mu,
      (const float*)sigma, (const int*)uni, (const float*)luni, (const float*)lsig,
      (const int*)src, (const float*)wts, (const float*)ramp, n_chain, (float*)sc, (float*)fin,
      (float*)acc, B, T);
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
int check_and_launch(const void* obs, const void* tact, const void* start, const void* mu,
                     const void* sigma, const void* uni, const void* luni, const void* lsig,
                     const void* src, const void* wts, const void* ramp, const int* h,
                     void* sc, void* fin, void* acc, int B, int T, int SP,
                     cudaStream_t stream) {
  if (SP % 128 != 0 || SP > 1024 || !counts_fit<L>(h)) return (int)cudaErrorInvalidValue;
  const int n_chain = h[1];
#define FWD_ARGS obs, tact, start, mu, sigma, uni, luni, lsig, src, wts, ramp, n_chain, sc, fin, \
                 acc, B, T, stream
  switch (SP / 128) {
    case 1: return launch<1, L>(FWD_ARGS);
    case 2: return launch<2, L>(FWD_ARGS);
    case 3: return launch<3, L>(FWD_ARGS);
    case 4: return launch<4, L>(FWD_ARGS);
    case 5: return launch<5, L>(FWD_ARGS);
    case 6: return launch<6, L>(FWD_ARGS);
    case 7: return launch<7, L>(FWD_ARGS);
    default: return launch<8, L>(FWD_ARGS);
  }
#undef FWD_ARGS
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

}  // namespace

// src, wts: (slots, SP) per-thread slot tables of the layout (0: CHAINED,
// DIAG + CHAIN * CHAIN_SLOTS slots; 1: DIAG_ONLY, its diagonal slots);
// ramp (chains, SP); counts: a host array of n_diag, n_chain and
// (n_entry, n_exit) per chain.  A spec past the layout's slots, or an
// unknown layout, is refused (PaddedHMM sends an HMM that fits no layout
// to the dense forward).
extern "C" int viterbi_fwd_launch(const void* obs, const void* tact, const void* start,
                                  const void* mu, const void* sigma, const void* uni,
                                  const void* luni, const void* lsig, const void* src,
                                  const void* wts, const void* ramp, const void* counts,
                                  void* sc, void* fin, void* acc, int B, int T, int SP,
                                  int layout, void* stream) {
  const int* h = (const int*)counts;
  cudaStream_t stream_ = (cudaStream_t)stream;
  switch (layout) {
    case 0:
      return check_and_launch<Chained>(obs, tact, start, mu, sigma, uni, luni, lsig, src, wts,
                                       ramp, h, sc, fin, acc, B, T, SP, stream_);
    case 1:
      return check_and_launch<DiagOnly>(obs, tact, start, mu, sigma, uni, luni, lsig, src, wts,
                                        ramp, h, sc, fin, acc, B, T, SP, stream_);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The wide variant: the same arguments, SP a multiple of 128 in (1024,
// 8192] (the narrow kernel above takes SP up to 1024).
extern "C" int viterbi_fwd_wide_launch(const void* obs, const void* tact, const void* start,
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
