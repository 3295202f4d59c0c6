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
// no longer fits a CTA, and neither does the emission table.  The cluster
// form (viterbi_fwd_cluster_kernel, below) spreads a read over a
// thread-block cluster of C CTAs, one state a thread again: each CTA
// holds a copy of the whole previous row, received by st.async, and the
// chains' CTA-local cummaxes cross the cluster the same way.  (The
// one-CTA wide form it replaces, K states a thread with the slot tables
// read through __ldg each step, is kept in tools/probe_viterbi_wide.cu,
// which times the two side by side.)
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

#include "cluster.cuh"

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
constexpr int MAX_SP = 8192;     // viterbi_cuda.MAX_SP
constexpr int MAX_CLUSTER = 8;   // the portable cluster size

// lanes a CTA of the cluster form: SP over C CTAs, in whole warps
__host__ __device__ constexpr int cluster_lanes(int SP, int C) {
  return (SP + 32 * C - 1) / (32 * C) * 32;
}

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

// Past SP 1024 (up to MAX_SP = 8192) one thread a state no longer fits a
// CTA: a read is a thread-block cluster of C CTAs (viterbi_cuda
// fwd_cluster_ctas), CTA r holding lanes [r VC, (r + 1) VC), one a
// thread (VC = blockDim.x, 32 ceil(SP / 32 C); lanes at or past SP are
// dead and take part in the shuffles and barriers only).  Each thread
// keeps the narrow kernel's habits: every slot in registers, the
// emission of step t + 1 computed while step t's exchange is in flight.
// Each CTA holds a copy of the whole previous row, so every diagonal and
// entry gathers locally whatever its offset:
//   * the val row: each live lane's val by st.async (4 lanes a 16-byte
//     message) into the step parity's row of every CTA, and each warp's
//     max (one word), completing 4 (SP + NP) bytes on that parity's
//     mbarrier; m is the max of the NP = C NW warp maxima (max is exact:
//     the whole row's max);
//   * the chains: xs = inj - ramp, a warp shfl_up scan, one CTA barrier
//     for the warps' totals, lp = the CTA's own cummax, sent as the val
//     row is into the chain rows of every CTA (4 NC SP bytes on the
//     parity's chain mbarrier).  An exit gathers h[u] = max(lp[u], the
//     totals of the CTAs below u's) + ramp[u], the cummax over lanes
//     0..u wherever u lies (a CTA's total is lp at its top live lane);
//     so any exit offset works.
// Rows alternate between two buffers by step parity and every CTA waits
// on its own mbarriers (CTA scope: st.async's bytes land in its shared
// memory): a CTA sends row t + 2 into a buffer only after every CTA sent
// row t + 1, which each does after its reads of row t, so nothing else
// guards a reuse.  The expression trees are the narrow kernel's, so the
// bits are the plain twin's.
template <class L, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
viterbi_fwd_cluster_kernel(const float* __restrict__ obs, const int* __restrict__ tact,
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
  __shared__ __align__(16) float wtot[NCA][32];
  __shared__ __align__(8) uint64_t bar[4];  // val rows 0-1, chain rows 2-3, by parity
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int VC = blockDim.x;
  const int NW = VC >> 5;
  const int NP = C * NW;          // warp maxima a row
  const int NPP = (NP + 3) & ~3;  // keeps the chain rows 16-byte aligned
  const int b = blockIdx.x / C;
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int v = rank * VC + x;
  const bool live = v < SP;
  const int vl = live ? v : SP - 1;  // a dead lane reads a live lane's tables, unused
  const int ta = min(tact[b], T);    // lengths past T would read past the row
  const float* x_row = obs + (size_t)b * T;
  const bool chains = NC > 0 && n_chain > 0;
  const uint32_t ROWB = 4u * SP;
  const uint32_t vb0 = smem_addr(smem);    // [2][SP]: the val rows
  const uint32_t pb0 = vb0 + 2 * ROWB;     // [2][NPP]: their warp maxima
  const uint32_t lb0 = pb0 + 8u * NPP;     // [2][NC][SP]: the chain rows
  const uint32_t VBYTES = 4u * (SP + NP);
  const uint32_t LBYTES = NC * ROWB;
  const uint32_t bar0 = smem_addr(&bar[0]);

  uint32_t ad[DIAG_SLOTS], ae[NCA][ENTRY_SLOTS], ax[NCA][EXIT_SLOTS];
  float wd[DIAG_SLOTS], we[NCA][ENTRY_SLOTS], wx[NCA][EXIT_SLOTS], rx[NCA][EXIT_SLOTS], rp[NCA];
  int kx[NCA][EXIT_SLOTS];  // the CTA of each exit's source lane
#pragma unroll
  for (int d = 0; d < DIAG_SLOTS; ++d) {
    ad[d] = vb0 + 4u * src[d * SP + vl];
    wd[d] = wts[d * SP + vl];
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    rp[c] = ramp[c * SP + vl];
    const int base = DIAG_SLOTS + c * CHAIN_SLOTS;
#pragma unroll
    for (int e = 0; e < ENTRY_SLOTS; ++e) {
      ae[c][e] = vb0 + 4u * src[(base + e) * SP + vl];
      we[c][e] = wts[(base + e) * SP + vl];
    }
#pragma unroll
    for (int e = 0; e < EXIT_SLOTS; ++e) {
      const int u = src[(base + ENTRY_SLOTS + e) * SP + vl];
      ax[c][e] = lb0 + c * ROWB + 4u * u;
      wx[c][e] = wts[(base + ENTRY_SLOTS + e) * SP + vl];
      rx[c][e] = ramp[c * SP + u];
      kx[c][e] = u / VC;
    }
  }
  const float mu_v = mu[vl], sig_v = sigma[vl], luni_v = luni[vl], lsig_v = lsig[vl];
  const float start_v = start[vl];
  const bool uni_v = uni[vl] != 0;
  auto emission = [&](float xt) {
    const float z = (xt - mu_v) / sig_v;
    return uni_v ? luni_v : (lsig_v - (0.5f * z) * z);
  };
  if (x == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8 * i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (ta > 0) expect_tx(bar0, VBYTES);
    if (ta > 1) expect_tx(bar0 + 8, VBYTES);
    if (chains && ta > 1) expect_tx(bar0 + 24, LBYTES);  // step 1's chain rows
    if (chains && ta > 2) expect_tx(bar0 + 16, LBYTES);  // step 2's
  }
  float emit = ta > 0 ? emission(x_row[0]) : 0.0f;
  float x_next = ta > 1 ? x_row[1] : 0.0f;
  float val = 0.0f, m = 0.0f, acc = 0.0f, fin_v = 0.0f;
  float* sc_v = sc + (size_t)b * SP + v;  // row t at sc_v + t * B * SP
  const size_t sc_step = (size_t)B * SP;
  // every CTA of the cluster runs, its barriers armed, before any row moves
  cluster.sync();

  // the max of a row's NP warp maxima, in every warp
  auto row_max = [&](int q) {
    float lm = -INFINITY;
    for (int i = lane; i < NP; i += 32) lm = fmaxf(lm, lds<0>(pb0 + 4u * (q * NPP + i)));
    return warp_max(lm);
  };
  // lanes 4k..4k+3's y into 16 bytes at `addr` (lane 4k's) of every CTA
  auto send = [&](float y, uint32_t addr, uint32_t mbar) {
    const float y1 = __shfl_down_sync(FULL, y, 1);
    const float y2 = __shfl_down_sync(FULL, y, 2);
    const float y3 = __shfl_down_sync(FULL, y, 3);
    if (live && (lane & 3) == 0) {
      const float4 q4 = make_float4(y, y1, y2, y3);
      for (int r = 0; r < C; ++r) st_async_v4(addr, q4, mbar, r);
    }
  };

  for (int t = 0; t < ta; ++t) {
    const int p = t & 1;
    if (t == 0) {
      val = start_v + emit;
    } else {
      const int q = p ^ 1;  // row t - 1
      wait_parity_cta(bar0 + 8 * q, ((t - 1) >> 1) & 1);
      if (x == 0 && t + 1 < ta) expect_tx(bar0 + 8 * q, VBYTES);  // row t + 1
      m = row_max(q);
      acc = acc + m;
      if (live) __stcs(sc_v + (size_t)(t - 1) * sc_step, val - m);
      const uint32_t prev = q * ROWB;
      float out = NEGF;
#pragma unroll
      for (int d = 0; d < DIAG_SLOTS; ++d) out = fmaxf(out, (lds<0>(ad[d] + prev) - m) + wd[d]);
      if (chains) {
        float xs[NCA];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float inj = NEGF;
#pragma unroll
          for (int e = 0; e < ENTRY_SLOTS; ++e)
            inj = fmaxf(inj, (lds<0>(ae[c][e] + prev) - m) + we[c][e]);
          xs[c] = live ? inj - rp[c] : -INFINITY;
        }
        // inclusive scans; a lane below d gets its own value back
#pragma unroll
        for (int d = 1; d < 32; d <<= 1)
#pragma unroll
          for (int c = 0; c < NC; ++c) xs[c] = fmaxf(xs[c], __shfl_up_sync(FULL, xs[c], d));
        if (lane == 31) {
#pragma unroll
          for (int c = 0; c < NC; ++c) wtot[c][warp] = xs[c];
        }
        __syncthreads();
        const uint32_t lrow = lb0 + p * LBYTES;  // step t's chain rows
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4* tot4 = reinterpret_cast<const float4*>(wtot[c]);
          float below = -INFINITY;
          for (int k = 0; 4 * k < warp; ++k) {
            const float4 w4 = tot4[k];
            below = fmaxf(below, fmaxf(fmaxf(4 * k < warp ? w4.x : -INFINITY,
                                             4 * k + 1 < warp ? w4.y : -INFINITY),
                                       fmaxf(4 * k + 2 < warp ? w4.z : -INFINITY,
                                             4 * k + 3 < warp ? w4.w : -INFINITY)));
          }
          send(fmaxf(xs[c], below), lrow + c * ROWB + 4u * v, bar0 + 16 + 8 * p);
        }
        wait_parity_cta(bar0 + 16 + 8 * p, ((t - 1) >> 1) & 1);
        if (x == 0 && t + 2 < ta) expect_tx(bar0 + 16 + 8 * p, LBYTES);  // step t + 2's
        const uint32_t lpar = p * LBYTES;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float tot[8];  // each CTA's total: lp at its top live lane
#pragma unroll
          for (int k = 0; k < 8; ++k)
            tot[k] = k < C ? lds<0>(lrow + c * ROWB + 4u * min(k * VC + VC - 1, SP - 1))
                           : -INFINITY;
#pragma unroll
          for (int e = 0; e < EXIT_SLOTS; ++e) {
            float tb = -INFINITY;  // the cummax of the CTAs below the source lane's
#pragma unroll
            for (int k = 0; k < 8; ++k) tb = k < kx[c][e] ? fmaxf(tb, tot[k]) : tb;
            const float cm = fmaxf(lds<0>(ax[c][e] + lpar), tb);
            out = fmaxf(out, (cm + rx[c][e]) + wx[c][e]);
          }
        }
      }
      val = out + emit;
    }
    send(val, vb0 + p * ROWB + 4u * v, bar0 + 8 * p);
    const float wm = warp_max(live ? val : -INFINITY);
    if (lane == 0) {
      const uint32_t a = pb0 + 4u * (p * NPP + rank * NW + warp);
      for (int r = 0; r < C; ++r) st_async_b32(a, __float_as_uint(wm), bar0 + 8 * p, r);
    }
    if (t + 1 < ta) {
      emit = emission(x_next);
      if (t + 2 < ta) x_next = x_row[t + 2];
    }
  }
  if (ta > 0) {
    const int q = (ta - 1) & 1;
    wait_parity_cta(bar0 + 8 * q, ((ta - 1) >> 1) & 1);
    m = row_max(q);
    acc = acc + m;
    fin_v = val - m;
    if (live) __stcs(sc_v + (size_t)(ta - 1) * sc_step, fin_v);
  }
  if (live) fin[(size_t)b * SP + v] = fin_v;
  if (rank == 0 && x == 0) acc_out[b] = acc;
  // no CTA leaves while a partner may still send into it
  cluster.sync();
}

// The launch of B reads on C CTAs a read: VC = 32 ceil(SP / 32 C) lanes
// a CTA, the launch bound by VC.  attr outlives cfg's use.
template <class L, int MAXT>
cudaError_t cluster_config(int B, int SP, int C, cudaStream_t stream, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  const int VC = cluster_lanes(SP, C);
  const int NP = C * (VC / 32);
  // the rows, their warp maxima and the chain rows: 194 KB at SP 8192
  const size_t shmem = (size_t)(2 * SP + 2 * ((NP + 3) & ~3) + 2 * L::CHAIN * SP) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(viterbi_fwd_cluster_kernel<L, MAXT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(B * C);
  cfg->blockDim = dim3(VC);
  cfg->dynamicSmemBytes = shmem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// the clusters of C CTAs at SP the card runs at once with one CTA an SM
// (0 when none fits): the query asks as if each CTA took all of an SM's
// shared memory
template <class L, int MAXT>
int cluster_capacity(int SP, int C) {
  auto kern = viterbi_fwd_cluster_kernel<L, MAXT>;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaFuncAttributes fa;
  int dev = 0, optin = 0, clusters = 0;
  if (cluster_config<L, MAXT>(C, SP, C, 0, &attr, &cfg) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&fa, kern) != cudaSuccess)
    return 0;
  cfg.dynamicSmemBytes = (size_t)optin - fa.sharedSizeBytes;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)cfg.dynamicSmemBytes) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg) != cudaSuccess)
    return 0;
  return clusters;
}

template <class L, int MAXT>
int launch_cluster(const void* obs, const void* tact, const void* start, const void* mu,
                   const void* sigma, const void* uni, const void* luni, const void* lsig,
                   const void* src, const void* wts, const void* ramp, int n_chain, void* sc,
                   void* fin, void* acc, int B, int T, int SP, int C, cudaStream_t stream) {
  auto kern = viterbi_fwd_cluster_kernel<L, MAXT>;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config<L, MAXT>(B, SP, C, stream, &attr, &cfg);
  if (e != cudaSuccess) return (int)e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kern, (const float*)obs, (const int*)tact, (const float*)start,
                         (const float*)mu, (const float*)sigma, (const int*)uni,
                         (const float*)luni, (const float*)lsig, (const int*)src,
                         (const float*)wts, (const float*)ramp, n_chain, (float*)sc,
                         (float*)fin, (float*)acc, B, T, SP);
  if (e != cudaSuccess) return (int)e;
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
int check_and_launch_cluster(const void* obs, const void* tact, const void* start,
                             const void* mu, const void* sigma, const void* uni,
                             const void* luni, const void* lsig, const void* src,
                             const void* wts, const void* ramp, const int* h, void* sc,
                             void* fin, void* acc, int B, int T, int SP, int C,
                             cudaStream_t stream) {
  if (SP % 128 != 0 || SP <= 0 || SP > MAX_SP || C < 1 || C > MAX_CLUSTER ||
      cluster_lanes(SP, C) > 1024 || !counts_fit<L>(h))
    return (int)cudaErrorInvalidValue;
  const int n_chain = h[1];
#define FWD_ARGS obs, tact, start, mu, sigma, uni, luni, lsig, src, wts, ramp, n_chain, sc, fin, \
                 acc, B, T, SP, C, stream
  if (cluster_lanes(SP, C) <= 512) return launch_cluster<L, 512>(FWD_ARGS);
  return launch_cluster<L, 1024>(FWD_ARGS);
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

// The cluster form: the same arguments, then C, the CTAs a read
// (viterbi_cuda.fwd_cluster_ctas; at most 8, VC = 32 ceil(SP / 32 C) at
// most 1024 lanes a CTA), SP a multiple of 128 up to 8192.
extern "C" int viterbi_fwd_cluster_launch(const void* obs, const void* tact, const void* start,
                                          const void* mu, const void* sigma, const void* uni,
                                          const void* luni, const void* lsig, const void* src,
                                          const void* wts, const void* ramp,
                                          const void* counts, void* sc, void* fin, void* acc,
                                          int B, int T, int SP, int layout, int C,
                                          void* stream) {
  const int* h = (const int*)counts;
  cudaStream_t stream_ = (cudaStream_t)stream;
  switch (layout) {
    case 0:
      return check_and_launch_cluster<Chained>(obs, tact, start, mu, sigma, uni, luni, lsig,
                                               src, wts, ramp, h, sc, fin, acc, B, T, SP, C,
                                               stream_);
    case 1:
      return check_and_launch_cluster<DiagOnly>(obs, tact, start, mu, sigma, uni, luni, lsig,
                                                src, wts, ramp, h, sc, fin, acc, B, T, SP, C,
                                                stream_);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The clusters of C CTAs a read at SP (the cluster form's launch shape,
// layout 0 or 1) the card runs at once with no two CTAs on one SM, an
// occupancy query and no launch; 0 for a shape the launch refuses.  The
// SMs of a graphics processing cluster hold whole clusters only, so this
// may be fewer than SMs / C.
extern "C" int viterbi_fwd_cluster_capacity(int SP, int layout, int C) {
  if (SP % 128 != 0 || SP <= 0 || SP > MAX_SP || C < 1 || C > MAX_CLUSTER ||
      cluster_lanes(SP, C) > 1024 || (layout != 0 && layout != 1))
    return 0;
  const bool small = cluster_lanes(SP, C) <= 512;
  if (layout == 0)
    return small ? cluster_capacity<Chained, 512>(SP, C) : cluster_capacity<Chained, 1024>(SP, C);
  return small ? cluster_capacity<DiagOnly, 512>(SP, C) : cluster_capacity<DiagOnly, 1024>(SP, C);
}
