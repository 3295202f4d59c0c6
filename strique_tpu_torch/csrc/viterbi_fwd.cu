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
// the previous row, and within a step on a read-wide prefix max per chain
// and a read-wide max; a step is a few hundred flops over 256 lanes.
// The score-row stream (T x B x SP f32, ~0.4 GB for 64 reads of 6144
// samples) is written once, coalesced, at far below the card's
// bandwidth.
//
// Design: one CTA per read of W warps, S = SP / (32 W) consecutive states
// a lane (lane l of the read holds states l S ... l S + S - 1; SP = 256
// for the c9orf72 HMM's 216 states, SP = 128 for its mod HMM's 26; W by
// SP and layout from FWD_STATES, the fastest of
// tools/probe_viterbi_narrow.py's sweep: 4 warps at SP 128 and 256, 1 and
// 2 states a lane, 4 states a lane at most).  Between the barriers a lane
// works S independent states, so their gathers and maxes are in flight at
// once; a step is three barriers over the read's warps (one with no
// chain):
//   * every roll's source lane u = (v - o) mod SP and weight w[u] are the
//     same at every step: the host stages them per state
//     (viterbi_cuda.fwd_gather_tables: the layout's diagonal slots, then
//     per chain ENTRY_SLOTS entry and EXIT_SLOTS exit slots; a slot the
//     spec leaves empty has weight -inf, the identity of the max), and
//     each lane holds every slot of its S states in registers: no
//     predicate or branch in the step.  Rows live in shared memory in
//     row_word order (u XOR its 32-word block's low bits), so a warp's
//     gathers, S states apart a lane, take one wavefront.  Two slot
//     layouts are compiled, picked by the host per HMM: CHAINED (8
//     diagonals and 2 chains of 2 entries and 3 exits) fits the
//     flanked-repeat HMMs (6 or 7 diagonals, chains of 2 entries and 3
//     and 2 exits); DIAG (12 diagonals, no chain) fits the mod HMMs (11
//     diagonals), whose step has no chain scan and so one barrier.  The
//     wrapper sends a spec that fits neither to the dense forward;
//   * the row is published as val (before the rescale) with each warp's
//     max (a lane's S states, then one __reduce_max_sync on an
//     order-preserving int key) behind ONE barrier, and every lane folds
//     the W warp maxima (max is exact): a gather reads (val[u] - m) + w,
//     the same f32 st[u] the reference rolls.  Rows alternate between two
//     buffers, so no barrier guards only a reuse;
//   * all chains scan together, h = cummax(inj - ramp) + ramp: a lane's
//     inclusive max over its S states in state order, interleaved warp
//     shfl_up scans of the lane totals, one barrier for every chain's warp
//     totals (each lane folds the totals of the warps below its own from
//     broadcast float4 reads), one barrier to publish every h row;
//   * the emission is off the chain: obs is staged 32 steps at a time in
//     shared memory by cp.async, one chunk ahead, and a lane computes its
//     states' emissions of step t + 1 after step t's last barrier, while
//     the rescale and the next step's gathers go on.  It keeps the
//     reference's expression tree, lsig - (0.5*z)*z with z = (x - mu) /
//     sigma rounded as the IEEE division rounds it (lsig from the host),
//     by a multiply with sigma's double reciprocal (quotient()), which
//     takes no slow-path branch: that branch ends a basic block, so the
//     division's latency could not overlap anything;
//   * a lane's S entries of a score row go out in one vector streaming
//     store (__stcs).
// acc accumulates sequentially in f32, in step order.  A read stops at
// its own length: later rows are frozen in the reference and never read.
// (The one state a thread form, W = SP / 32 with every warp reading the
// whole row for its max, is kept in tools/probe_viterbi_narrow.cu.)
//
// Past SP 1024 (up to 8192, the dense forward's cap) one thread a state
// no longer fits a CTA.  The cluster form (viterbi_fwd_cluster_kernel,
// below) spreads a read over a thread-block cluster of C CTAs, one state
// a thread again: each CTA holds a copy of the whole previous row,
// received by st.async, and the chains' CTA-local cummaxes cross the
// cluster the same way.  (The
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

// states a lane of the narrow kernel by slot layout (0 CHAINED, 1 DIAG)
// and SP / 128 - 1, the fastest of tools/probe_viterbi_narrow.py's sweep
// on an H100 (viterbi_cuda.FWD_STATES, held equal by a CPU test); W =
// SP / (32 S) warps a read
constexpr int FWD_STATES[2][8] = {{1, 2, 4, 4, 4, 4, 4, 4}, {1, 2, 2, 4, 2, 2, 4, 4}};

template <int NV, class L>
constexpr int fwd_warps() {
  return 4 * NV / FWD_STATES[L::CHAIN > 0 ? 0 : 1][NV - 1];
}

// the shared word of state u in a row of the narrow kernel at S states a
// lane: u XOR its 32-word block's low bits, so a warp's 32 lanes, S
// states apart, fall in 32 distinct banks (S a power of two); a lane's S
// states stay in one aligned group of S words
template <int S>
__host__ __device__ constexpr int row_word(int u) {
  return u ^ ((u >> 5) & (S - 1));
}

// Clock hooks of the narrow kernel's step phases
// (tools/probe_viterbi_narrow.cu compiles this file with FWD_HOOK set to a
// counting hook): start, mark(i) at the end of phase i (0 the step's start
// and an obs chunk's prefetch, 1 the gathers and scans, 2 the totals'
// barrier, 3 the fold and h rows, 4 the h rows' barrier, 5 the exits and
// the row's publication, 6 its barrier, 7 the rescale, the next step's
// emissions and the score row), finish.  The kernels built here take
// NoFwdHook, whose calls vanish.
struct NoFwdHook {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void finish(int) {}
};
#ifndef FWD_HOOK
#define FWD_HOOK NoFwdHook
#endif

// a / b in f32, rounded to nearest as the IEEE division rounds it, from rb
// = 1.0 / (double)b: the double product is within 2^-52 (relative) of a /
// b, which lies at least 2^-49 from the nearest midpoint of two floats
// (a and b carry 24-bit significands), so rounding it to f32 rounds a / b
// (tests/test_torch_viterbi_staging.py holds the identity over random
// and edge operands).  Branch-free: the f32 division's slow-path branch
// ends a basic block, so nothing else could overlap its latency.
__device__ __forceinline__ float quotient(float a, double rb) {
  return __double2float_rn((double)a * rb);
}

// dynamic shared bytes of the narrow kernel at SP with NC chains: the two
// rows, the h rows, and each state's emission constants (mu, lsig, luni,
// uni; 1 / sigma in double)
constexpr size_t narrow_shmem(int SP, int NC) {
  return (size_t)(2 + NC + 4 + 2) * SP * sizeof(float);
}

// a lane's S consecutive entries of a score row, one streaming store
template <int S>
__device__ __forceinline__ void store_row(float* p, const float (&v)[S]) {
  if constexpr (S == 1) {
    __stcs(p, v[0]);
  } else if constexpr (S == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int q = 0; q < S / 4; ++q)
      __stcs(reinterpret_cast<float4*>(p) + q,
             make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  }
}

// SP = 128 NV states on W warps a read (one CTA), S = SP / (32 W)
// consecutive states a lane, every slot of layout L held in registers
template <int NV, class L, int W>
__global__ void __launch_bounds__(32 * W, 1)
viterbi_fwd_kernel(const float* __restrict__ obs, const int* __restrict__ tact,
                   const float* __restrict__ start, const float* __restrict__ mu,
                   const float* __restrict__ sigma, const int* __restrict__ uni,
                   const float* __restrict__ luni, const float* __restrict__ lsig,
                   const int* __restrict__ src, const float* __restrict__ wts,
                   const float* __restrict__ ramp, int n_chain, float* __restrict__ sc,
                   float* __restrict__ fin, float* __restrict__ acc_out, int B, int T) {
  constexpr int SP = 128 * NV;
  constexpr int NT = 32 * W;   // threads of the read
  constexpr int S = SP / NT;   // states a lane
  static_assert(S * NT == SP && (S & (S - 1)) == 0 && S <= 8, "S: 1, 2, 4 or 8");
  constexpr int ROW = SP * 4;  // bytes of a row
  constexpr int DIAG_SLOTS = L::DIAG;
  constexpr int NC = L::CHAIN;
  constexpr int NCA = L::CHAIN_ARR;
  extern __shared__ __align__(16) float smem[];
  float* val_sh = smem;             // 2 x SP: the rows, by step parity, in row_word order
  float* h_sh = val_sh + 2 * SP;    // NC x SP, in row_word order
  // a state's emission constants, S x NT each: (mu, lsig, luni, uni as 0
  // or 1), then 1 / sigma in double
  float4* par_sh = reinterpret_cast<float4*>(h_sh + NC * SP);
  double* rsig_sh = reinterpret_cast<double*>(par_sh + SP);
  __shared__ __align__(16) float wtot[NCA][32];  // the chains' warp totals
  __shared__ __align__(16) int wkey[2][32];      // the warps' row maxima, by parity
  __shared__ __align__(16) float obs_sh[2][OBS_CHUNK];

  const int b = blockIdx.x;
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int v0 = x * S;            // the lane's first state
  const int ta = min(tact[b], T);  // lengths past T would read past the row
  const float* x_row = obs + (size_t)b * T;

  // shared byte addresses of every gather: a row (parity 0) and the h rows
  const uint32_t val0 = (uint32_t)__cvta_generic_to_shared(val_sh);
  const uint32_t h0 = (uint32_t)__cvta_generic_to_shared(h_sh);
  uint32_t ad[S][DIAG_SLOTS], ae[S][NCA][ENTRY_SLOTS], ax[S][NCA][EXIT_SLOTS];
  float wd[S][DIAG_SLOTS], we[S][NCA][ENTRY_SLOTS], wx[S][NCA][EXIT_SLOTS], rp[S][NCA];
  int own[S];  // the lane's states' words
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int v = v0 + k;
    own[k] = row_word<S>(v);
    par_sh[k * NT + x] = make_float4(mu[v], lsig[v], luni[v], uni[v] != 0 ? 1.0f : 0.0f);
    rsig_sh[k * NT + x] = 1.0 / (double)sigma[v];
#pragma unroll
    for (int d = 0; d < DIAG_SLOTS; ++d) {
      ad[k][d] = val0 + 4 * row_word<S>(src[d * SP + v]);
      wd[k][d] = wts[d * SP + v];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      rp[k][c] = ramp[c * SP + v];
      const int base = DIAG_SLOTS + c * CHAIN_SLOTS;
#pragma unroll
      for (int e = 0; e < ENTRY_SLOTS; ++e) {
        ae[k][c][e] = val0 + 4 * row_word<S>(src[(base + e) * SP + v]);
        we[k][c][e] = wts[(base + e) * SP + v];
      }
#pragma unroll
      for (int e = 0; e < EXIT_SLOTS; ++e) {
        ax[k][c][e] = h0 + c * ROW + 4 * row_word<S>(src[(base + ENTRY_SLOTS + e) * SP + v]);
        wx[k][c][e] = wts[(base + ENTRY_SLOTS + e) * SP + v];
      }
    }
  }

  // obs chunk 0 now, chunk 1 in flight
  if (x < OBS_CHUNK) {
    if (x < ta) obs_sh[0][x] = x_row[x];
    if (OBS_CHUNK + x < ta) cp_async4(&obs_sh[1][x], x_row + OBS_CHUNK + x);
    cp_async_commit();
  }
  float acc = 0.0f, m = 0.0f;
  float* fin_b = fin + (size_t)b * SP + v0;
  if (ta <= 0) {
#pragma unroll
    for (int k = 0; k < S; ++k) fin_b[k] = 0.0f;
  }
  float* sc_v = sc + (size_t)b * SP + v0;  // row t at sc_v + t * B * SP
  const size_t sc_step = (size_t)B * SP;
  // state k's emission of sample xt: the reference's tree, lsig -
  // (0.5*z)*z with z = (xt - mu) / sigma (quotient(): IEEE's rounding)
  auto emission = [&](int k, float xt) {
    const float4 q = par_sh[k * NT + x];
    const float z = quotient(xt - q.x, rsig_sh[k * NT + x]);
    return q.w != 0.0f ? q.z : q.y - (0.5f * z) * z;
  };
  FWD_HOOK hook;
  __syncthreads();
  float emit[S];  // the step's emissions, computed during the step before
#pragma unroll
  for (int k = 0; k < S; ++k) emit[k] = emission(k, obs_sh[0][0]);
  hook.start();

  // one step; parity P picks the row buffers at compile time
  auto step = [&](auto parity, int t) {
    constexpr int P = decltype(parity)::value;
    const int jc = t % OBS_CHUNK;
    if (P == 0 && jc == 0 && t > 0 && x < OBS_CHUNK) {  // a chunk starts on an even step
      // chunk+1's buffer last held chunk-1, read before the last barrier
      const int chunk = t / OBS_CHUNK;
      const int tn = (chunk + 1) * OBS_CHUNK + x;
      if (tn < ta) cp_async4(&obs_sh[(chunk + 1) & 1][x], x_row + tn);
      cp_async_commit();
    }
    hook.mark(0);
    float val[S];
    if (P == 0 && t == 0) {
#pragma unroll
      for (int k = 0; k < S; ++k) val[k] = start[v0 + k] + emit[k];
    } else {
      constexpr int PREV = (P ^ 1) * ROW;  // the previous row
      float out[S];
      if (NC > 0 && n_chain > 0) {
        // chains first: their scans are the step's longest chain
        float p[NCA][S];  // the lane's inclusive cummax of inj - ramp, state by state
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int k = 0; k < S; ++k) {
            float inj = NEGF;
#pragma unroll
            for (int e = 0; e < ENTRY_SLOTS; ++e)
              inj = fmaxf(inj, (lds<PREV>(ae[k][c][e]) - m) + we[k][c][e]);
            const float xs = inj - rp[k][c];
            p[c][k] = k ? fmaxf(p[c][k - 1], xs) : xs;
          }
#pragma unroll
        for (int k = 0; k < S; ++k) {
          out[k] = NEGF;
#pragma unroll
          for (int d = 0; d < DIAG_SLOTS; ++d)
            out[k] = fmaxf(out[k], (lds<PREV>(ad[k][d]) - m) + wd[k][d]);
        }
        // cy: the cummax of the states below the lane's first in its warp
        // (S > 1: an exclusive scan of lane totals) or through its state
        // (S = 1: inclusive, as lanes below d get their own value back)
        float cy[NCA];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          cy[c] = p[c][S - 1];
          if (S > 1) {
            const float y = __shfl_up_sync(FULL, cy[c], 1);
            cy[c] = lane ? y : -INFINITY;
          }
        }
#pragma unroll
        for (int d = 1; d < 32; d <<= 1)
#pragma unroll
          for (int c = 0; c < NC; ++c) cy[c] = fmaxf(cy[c], __shfl_up_sync(FULL, cy[c], d));
        hook.mark(1);
        if (lane == 31) {
#pragma unroll
          for (int c = 0; c < NC; ++c) wtot[c][warp] = S > 1 ? fmaxf(cy[c], p[c][S - 1]) : cy[c];
        }
        __syncthreads();
        hook.mark(2);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          // the totals of the warps below this one: broadcast float4 reads
          const float4* tot4 = reinterpret_cast<const float4*>(wtot[c]);
#pragma unroll
          for (int q = 0; q < (W + 3) / 4; ++q) {
            const float4 z = tot4[q];
            cy[c] = fmaxf(cy[c], fmaxf(fmaxf(4 * q < warp ? z.x : -INFINITY,
                                             4 * q + 1 < warp ? z.y : -INFINITY),
                                       fmaxf(4 * q + 2 < warp ? z.z : -INFINITY,
                                             4 * q + 3 < warp ? z.w : -INFINITY)));
          }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int k = 0; k < S; ++k)
            h_sh[c * SP + own[k]] = (S > 1 ? fmaxf(p[c][k], cy[c]) : cy[c]) + rp[k][c];
        hook.mark(3);
        __syncthreads();
        hook.mark(4);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < EXIT_SLOTS; ++e)
#pragma unroll
            for (int k = 0; k < S; ++k)
              out[k] = fmaxf(out[k], lds<0>(ax[k][c][e]) + wx[k][c][e]);
      } else {
#pragma unroll
        for (int k = 0; k < S; ++k) {
          out[k] = NEGF;
#pragma unroll
          for (int d = 0; d < DIAG_SLOTS; ++d)
            out[k] = fmaxf(out[k], (lds<PREV>(ad[k][d]) - m) + wd[k][d]);
        }
      }
#pragma unroll
      for (int k = 0; k < S; ++k) val[k] = out[k] + emit[k];
    }
    // the row max: the lane's states, its warp (keyed: max is exact), then
    // the read's W warps
    float lm = val[0];
#pragma unroll
    for (int k = 1; k < S; ++k) lm = fmaxf(lm, val[k]);
    int key = __reduce_max_sync(FULL, order_key(lm));
#pragma unroll
    for (int k = 0; k < S; ++k) val_sh[P * SP + own[k]] = val[k];
    if (lane == 0) wkey[P][warp] = key;
    if (P == 1 && jc == OBS_CHUNK - 1 && x < OBS_CHUNK) cp_async_wait_all();  // chunk+1 lands
    hook.mark(5);
    __syncthreads();
    hook.mark(6);
    const int4* key4 = reinterpret_cast<const int4*>(wkey[P]);
#pragma unroll
    for (int q = 0; q < (W + 3) / 4; ++q) {
      const int4 z = key4[q];
      key = max(key, max(max(z.x, 4 * q + 1 < W ? z.y : z.x),
                         max(4 * q + 2 < W ? z.z : z.x, 4 * q + 3 < W ? z.w : z.x)));
    }
    m = key_value(key);
    // the next step's emissions, off this step's chain (sample t + 1 landed
    // before the barrier above)
    const float xn = obs_sh[((t + 1) / OBS_CHUNK) & 1][(t + 1) % OBS_CHUNK];
#pragma unroll
    for (int k = 0; k < S; ++k) emit[k] = emission(k, xn);
    float stn[S];
#pragma unroll
    for (int k = 0; k < S; ++k) stn[k] = val[k] - m;
    acc = acc + m;
    if (t == ta - 1) {
#pragma unroll
      for (int k = 0; k < S; ++k) fin_b[k] = stn[k];
    }
    store_row<S>(sc_v, stn);
    sc_v += sc_step;
    hook.mark(7);
  };
  for (int t = 0; t < ta; t += 2) {
    step(std::integral_constant<int, 0>{}, t);
    if (t + 1 < ta) step(std::integral_constant<int, 1>{}, t + 1);
  }
  if (x < OBS_CHUNK) cp_async_wait_all();
  if (x == 0) acc_out[b] = acc;
  hook.finish(b);
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
  constexpr int W = fwd_warps<NV, L>();
  auto kernel = viterbi_fwd_kernel<NV, L, W>;
  const size_t shmem = narrow_shmem(SP, L::CHAIN);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, 32 * W, shmem, stream>>>(
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

// A probe that includes this file for its kernels defines
// VITERBI_FWD_KERNELS_ONLY and instantiates its own.
#ifndef VITERBI_FWD_KERNELS_ONLY

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

#endif  // VITERBI_FWD_KERNELS_ONLY
