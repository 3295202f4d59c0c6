// Column-sweep Gotoh flank alignment: pointers and bottom taps.
//
// Replaces the Pallas TPU kernel strique_tpu/ops/align_pallas.py
// `_align_kernel` (called by `align_forward_pallas`), the form
// STRIQUE_ALIGN_KERNEL=col selects.  Step c computes signal column
// j = c + 1 for every template row i at once:
//   sc    = max(off - |a[j-1] - tmpl[i]|^1.2, dmin)
//   Ih'   = max(Ih + ge_h, S + go_h)
//   M'    = S(i-1) + sc                      (S of the previous column)
//   Q     = max(M', Ih')                     (row 0 pinned to 0)
//   C     = inclusive prefix max over rows of (Q + go_v) - (i+1) g
//   Iv'   = C(i-1) + i g,   S' = max(Q, Iv')
// and a 4-bit code per cell: bits 0-1 the best matrix (M > V > H), bit 2
// Ih extends, bit 3 Iv(i) extends from row i-1 (its test runs at lane
// i-1 and shifts up one row).
//
// Two compile-time score modes:
//   POW     every cell evaluates |d|^1.2 of its f32 sample and template
//           value in double precision.
//   TABLE   morph-form input (MP <= 1024): u8 bins (B, N) and a 256-entry
//           f32 level table per read, the template as its U distinct
//           values plus each lane's index into them.  The CTA evaluates
//           the row's U x 258 scores once, with POW's own expression (the
//           entries of ops/align_cuda.py `score_table`), into shared
//           memory; lane i then scores column c as table[lidx[i]][bin[c]].
//           The +1e30 pad lanes and lane 0 index the +1e30 level, whose
//           entries are dmin, as POW gives them.  A column is never read
//           past the bins row (c < round_up(n, 8) <= N), so the row's own
//           bins stand where the f32 route reads lut[bins].
//
// What bounds it on an H100: the serial chain of N column steps per row,
// each a prefix max across all MP lanes, so every step crosses the
// CTA's warps once.  In POW mode the per-cell FP64 pow makes FP64
// throughput the per-SM cost of a step; in TABLE mode a step is the
// recurrence's f32 operations, a warp scan, a warp redux and one block
// barrier, a latency chain.
// The pointer plane (N/8 x B x MP int32, ~0.70 GB per 64-row bench call)
// is written once, coalesced, and is not the limit.
//
// Design: one CTA per row, template lanes on threads (LPT contiguous
// lanes a thread: 4 in TABLE mode, which halves the warps that a step's
// instructions queue behind against one lane a thread; in POW mode 1,
// and more when MP > 1024), a lane's S and Ih in registers.  ONE
// __syncthreads a step:
//   * before it, every warp does all it can alone: S of lane i-1 and its
//     extend bit come by shfl from the lane below; the prefix max is a
//     serial max over the thread's lanes and a warp shfl_up scan.  Only a
//     warp's first lane needs the warp below, for its M move
//     (S(i-1) + sc): that lane scans with Q = Ih' alone, and the last
//     lane of the warp below, which holds S(i-1), publishes the M move's
//     part of the first lane's prefix term, ((S(i-1) + sc) + go_v) -
//     (i+1) g.  Rounding is monotone, so (max(M', Ih') + go_v) - k is the
//     max of the two parts' terms: the split gives the same bits.  The
//     first lane's score for the next column is published one step ahead,
//     for that.
//   * after it, every warp folds the totals and M-move terms of the
//     warps below it with one redux.sync max (on order-preserving integer
//     keys; shared memory indexed by step parity, so no second barrier
//     guards a reuse), and the first lane of each warp finishes its M'
//     and Q from the published S(i-1).
//   * bit 3 of a warp's first lane is the extend test of the warp
//     below's last lane at the same column; it rides the next step's
//     barrier, so every pointer word (8 columns) is stored one step
//     after its last column, and the last one behind one more barrier.
// Max is exact, so this association gives the reference's values (its
// two-level scan is a Mosaic layout choice).  The 8 samples (or bins) of
// the next 8 columns are loaded a group ahead, off the step chain.  Lane
// i stores row i's codes as one int32 word at [c/8, row, i-1] (row 0's at
// lane MP-1: the wrapped lane of the reference, never read).  A row stops
// at its own round_up(n, 8) (the reference skips 128-column chunks past
// the batch's longest read) and fills its remaining bottom taps with NEG.
//
//
// TABLE past one CTA (more than 1024 lanes, or a table too large for one
// block): a thread-block cluster of K CTAs a row (K <= 8; the host's
// launch plan, ops/align_cuda.py `col_launch_plan`, picks K and a call's
// rows), CTA k owning the contiguous lanes [k MPC, (k+1) MPC) at 4 lanes
// a thread and a score table of only its own lanes' levels, one CTA an
// SM (`col_cluster_kernel`).  What a warp needs of the lanes below it at
// column c -- the prefix total through the lane below its first (P), S
// of that lane at column c - 1 and its extend test at column c -- does
// not depend on the warp, so no barrier runs a step: the warps (and the
// CTAs) run skewed, each a group of 8 columns behind the one below.  A
// warp's last lane sends (S, P) each column and the group's 8 extend bits
// into a ring slot of the warp above (one slot an 8-column group, a
// "full" and an "empty" mbarrier a slot): in shared memory within the
// CTA, by st.async into the next CTA's ring across CTAs.  The warp's
// first lane waits on a slot once a group (CTA-scope), its lanes 0-7
// take the group's values, and it frees the slot (across CTAs a relaxed
// remote arrive behind a CTA-scope fence).  Max is exact, so folding P
// into each warp's scan gives the one-CTA kernel's values.
//
// Value contract: the reference's expression trees, built with
// -fmad=false (no a + b*c contracts); |d|^1.2 is
// (float)pow((double)d, (double)1.2f), and the +1e30 template pad and
// lane 0 give sc = dmin through pow -> inf.  Every max that a NaN may
// reach is `max_nan` (PTX max.NaN.f32): NaN when either operand is NaN, as
// jnp.maximum and torch.maximum give it (fmaxf dropped a flat read's
// NaN); on other operands the bits of fmaxf, which a TABLE row whose
// table inputs are all finite runs instead (`col_align_kernel`'s NANS).  The
// redux's integer keys put max_nan's NaN (the canonical 0x7fffffff) above
// +inf, and it reads back as a NaN.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

#include "cluster.cuh"

constexpr float NEGF = -1e30f;
constexpr double POW_EXP = 1.2000000476837158;  // (double)1.2f
constexpr int MAX_THREADS = 1024;
constexpr int SCORE_COLS = 258;      // 256 bins, NEG, 0.0 (the last two unread here)
constexpr int EXCH = 5 * 2 * 32;     // exchange floats: 5 slots x 2 parities x 32 warps
constexpr size_t SMEM_MAX = 232448;  // 227 KB: a block's dynamic shared memory
constexpr unsigned FULL = 0xffffffffu;
// the cluster form's CTA ring, at the start of shared memory: RING slots
// of an 8-column group ((S, P) a column, then the extend bits, padded to
// 16 bytes), then a "full" and an "empty" mbarrier a slot
constexpr int RING = 8;
constexpr int SLOT_FLOATS = 20;
constexpr uint32_t SLOT_BYTES = 4 * 17;  // 8 (S, P) pairs and the bits
constexpr int RING_FLOATS = RING * SLOT_FLOATS + RING * 2 * 2;
constexpr int MAX_CTAS = 8;  // a portable cluster
constexpr int CL_MAX_LANES = 2048;  // a cluster CTA's lanes: 512 threads of 4
// the cluster form's warp rings: LRING slots an 8-column group each, for
// up to CL_WARPS warps (ops/align_cuda.py COL_RING_BYTES = 4 CL_FIXED)
constexpr int LRING = 4;
constexpr int CL_WARPS = CL_MAX_LANES / 4 / 32;
constexpr int CL_FIXED = RING_FLOATS + CL_WARPS * LRING * (4 + SLOT_FLOATS);

enum Score { POW = 0, TABLE = 1 };

struct Params {
  float go_h, go_v, ge_h, ge_v, off, dmin, g;
  int neg_h;
};

// what the TABLE score mode reads in place of sig and tmpl
struct Table {
  const uint8_t* bins;   // (B, N) morph bins
  const float* lut;      // (B, 256) each read's level values
  const float* levels;   // (1, UP) distinct template values
  const int* lidx;       // (1, MP) lane -> index into its CTA's levels
  int up;                // UP
};

// an int key whose order is the float order (and back): redux.sync takes
// integers.  A NaN whose sign bit is clear keys above +inf; the one
// caller passes max results (and -inf), and max.NaN.f32 gives the
// canonical NaN 0x7fffffff, the top key, which reads back as a NaN
__device__ __forceinline__ int order_key(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ float cell_score(float av, float tm, const Params& p) {
  const float diff = fabsf(av - tm);
  const float pw = (float)pow((double)diff, POW_EXP);
  return max_nan(p.off - pw, p.dmin);
}

// the inputs of 8 consecutive columns [c0, c0 + 8): f32 samples (POW) or
// bins (TABLE)
template <int SCORE>
struct Cols {
  float4 a0, a1;
  uint2 bn;
  __device__ __forceinline__ void load(const float* a, const uint8_t* brow, int c0) {
    if (SCORE == POW) {
      a0 = *reinterpret_cast<const float4*>(a + c0);
      a1 = *reinterpret_cast<const float4*>(a + c0 + 4);
    } else {
      bn = *reinterpret_cast<const uint2*>(brow + c0);
    }
  }
  // column c0 + s's score for a lane of template value tm (POW) or score
  // row tbase (TABLE); s is a compile-time constant after unrolling
  __device__ __forceinline__ float score(int s, float tm, int tbase, const float* T,
                                         const Params& p) const {
    if (SCORE == TABLE) return T[tbase + (((s < 4 ? bn.x : bn.y) >> (8 * (s & 3))) & 0xff)];
    const float av = s == 0 ? a0.x : s == 1 ? a0.y : s == 2 ? a0.z : s == 3 ? a0.w
                   : s == 4 ? a1.x : s == 5 ? a1.y : s == 6 ? a1.z : a1.w;
    return cell_score(av, tm, p);
  }
};

// the DP's max: max_nan where a NaN may reach it (NANS), else fmaxf, the
// same bits on every other operand; the compiler schedules the TABLE step
// around fmaxf better than around max_nan's inline asm
// (tools/probe_col_max.py times the two instances)
template <bool NANS>
__device__ __forceinline__ float mx(float a, float b) {
  return NANS ? max_nan(a, b) : fmaxf(a, b);
}

// Whether a TABLE row is the other instance's: a row whose level table
// and template levels are all finite meets no NaN (every score is finite,
// every DP value finite or -inf, and nothing subtracts infinities), so
// the fmaxf instance (NANS false) runs it; any other row, and POW, the
// max_nan instance.  A TABLE call launches both instances over all its
// rows, and each leaves at once the rows that are the other's (every CTA
// of a cluster row reads the same values, so they leave together, before
// any of them touches a peer).  `levels` counts every CTA's of the row.
template <bool NANS>
__device__ __forceinline__ bool other_instance(const Table& tb, int row, int levels) {
  const float* lut = tb.lut + (size_t)row * 256;
  bool odd = false;
  for (int e = threadIdx.x; e < 256 + levels; e += blockDim.x) {
    const float v = e < 256 ? lut[e] : tb.levels[e - 256];
    odd |= !(fabsf(v) <= 3.402823466e38f);  // NaN or inf
  }
  return (__syncthreads_or(odd) != 0) != NANS;
}

// One CTA a row (MPC = MP): TABLE mode runs MP <= 1024 lanes, so at most
// 1024 / LPT threads.  NANS: which max the DP takes (`other_instance`).
template <int LPT, int SCORE, bool NANS>
__global__ void __launch_bounds__(SCORE == TABLE ? MAX_THREADS / LPT : MAX_THREADS)
col_align_kernel(const float* __restrict__ sig, const float* __restrict__ tmpl, Table tb,
                 const int* __restrict__ nact, int32_t* __restrict__ ptr,
                 float* __restrict__ bottom, int B, int N, int MP, int MPC, int m, Params p) {
  if constexpr (SCORE == TABLE) {
    if (other_instance<NANS>(tb, blockIdx.x, tb.up)) return;
  }
  // the exchange slots [parity * 32 + warp]; TABLE: the U x 258 scores
  // follow
  extern __shared__ __align__(16) float smem_all[];
  float* smem = smem_all;
  float* x_tot = smem;               // the warp's prefix total, its first lane's M' left out
  float* x_ca = smem + 64;           // warp w's first lane: its M' prefix term (from w-1)
  float* x_s = smem + 128;           // warp w: S of warp w-1's last lane, previous column
  int* x_e = (int*)(smem + 192);     // warp w: warp w-1's last extend test, previous column
  float* x_sc = smem + 256;          // warp w's first lane: its score at the next column
  const float* T = smem + EXCH;

  const int row = blockIdx.x;
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int i0 = x * LPT;  // first lane of this thread
  const bool active = i0 < MP;
  const bool edge = lane == 0 && warp > 0;            // S(i0-1) lives in the warp below
  const bool feeds = lane == 31 && warp + 1 < n_warps;  // feeds the next warp's first lane
  const float f_next = (float)(i0 + LPT);             // that lane's row
  int n = nact[row];
  if (n > N) n = N;
  int c_end = (n + 7) & ~7;
  if (c_end > N) c_end = N;
  const float* a = SCORE == POW ? sig + (size_t)row * N : nullptr;
  const uint8_t* brow = SCORE == TABLE ? tb.bins + (size_t)row * N : nullptr;
  float* bot = bottom + (size_t)row * N;
  const float fill_s = p.neg_h ? -p.dmin : NEGF;

  float S[LPT], Ih[LPT], tm[LPT], sc[LPT];
  int tbase[LPT];
  uint32_t acc[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int i = i0 + k;
    const float fi = (float)i;
    S[k] = (i == 0) ? 0.0f : p.go_v + p.ge_v * (fi - 1.0f);
    Ih[k] = NEGF;
    tm[k] = SCORE == POW && i < MP ? tmpl[i] : 1e30f;
    tbase[k] = SCORE == TABLE && i < MP ? tb.lidx[i] * SCORE_COLS : 0;
    acc[k] = 0;
  }
  for (int i = x; i < 64; i += blockDim.x) x_ca[i] = -INFINITY;  // warp 0: no M' from below
  if (SCORE == TABLE) {
    // entry [u][b]: template level u against bin b's value (b < 256), NEG
    // (b = 256) or 0.0 (b = 257), as ops/align_cuda.py `score_table`
    const float* lut = tb.lut + (size_t)row * 256;
    const float* lv = tb.levels;
    float* Tw = smem + EXCH;
    for (int e = x; e < tb.up * SCORE_COLS; e += blockDim.x) {
      const int u = e / SCORE_COLS;
      const int b = e - u * SCORE_COLS;
      const float xv = b < 256 ? lut[b] : (b == 256 ? NEGF : 0.0f);
      Tw[e] = cell_score(xv, lv[u], p);
    }
  }
  Cols<SCORE> cur, nxt;
  cur.a0 = cur.a1 = nxt.a0 = nxt.a1 = make_float4(0.f, 0.f, 0.f, 0.f);
  cur.bn = nxt.bn = make_uint2(0, 0);
  if (c_end > 0) cur.load(a, brow, 0);
  __syncthreads();  // the table
#pragma unroll
  for (int k = 0; k < LPT; ++k) sc[k] = cur.score(0, tm[k], tbase[k], T, p);
  if (edge) x_sc[32 + warp] = sc[0];  // read at step 0 from parity 1
  __syncthreads();

  int e_last = 0;  // the extend test of this thread's last lane, previous column
  for (int c0 = 0; c0 < c_end; c0 += 8) {
    if (c0 + 8 < c_end) nxt.load(a, brow, c0 + 8);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int c = c0 + s;
      const int par = (s & 1) * 32;
      // -- before the barrier: this warp alone --------------------------
      float scn[LPT];  // scores of the next column
#pragma unroll
      for (int k = 0; k < LPT; ++k)
        scn[k] = s < 7 ? cur.score(s + 1, tm[k], tbase[k], T, p)
                       : nxt.score(0, tm[k], tbase[k], T, p);
      if (edge) x_sc[par + warp] = scn[0];
      const float s_up = __shfl_up_sync(FULL, S[LPT - 1], 1);  // S(i0-1) within the warp
      const float s_in = fill_s;  // S of lane -1
      float newM[LPT], Q[LPT], pre[LPT];
      int ihx[LPT];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const float fi = (float)(i0 + k);
        const float ih_ext = Ih[k] + p.ge_h;
        const float ih_open = S[k] + p.go_h;
        ihx[k] = ih_ext >= ih_open ? 4 : 0;
        Ih[k] = mx<NANS>(ih_ext, ih_open);
        const float left = k > 0 ? S[k - 1] : (lane > 0 ? s_up : s_in);
        newM[k] = left + sc[k];
        float q = mx<NANS>(newM[k], Ih[k]);
        if (!p.neg_h && i0 + k == 0) q = 0.0f;
        if (k == 0 && edge) q = Ih[0];  // its M' waits for the warp below
        Q[k] = q;
        const float cv = (q + p.go_v) - ((fi + 1.0f) * p.g);
        pre[k] = k == 0 ? cv : mx<NANS>(pre[k - 1], cv);
      }
      float tot = active ? pre[LPT - 1] : NEGF;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float y = __shfl_up_sync(FULL, tot, d);
        if (lane >= d) tot = mx<NANS>(tot, y);
      }
      const float up = __shfl_up_sync(FULL, tot, 1);  // through thread x-1 (this warp)
      if (lane == 31) x_tot[par + warp] = tot;
      if (feeds) {
        const float s_last = S[LPT - 1];
        x_ca[par + warp + 1] =
            ((s_last + x_sc[(par ^ 32) + warp + 1]) + p.go_v) - ((f_next + 1.0f) * p.g);
        x_s[par + warp + 1] = s_last;
        x_e[par + warp + 1] = e_last;
      }
      __syncthreads();
      // -- after the barrier -------------------------------------------
      // through warp-1: the warps below, each its total and first M'
      const float wt = lane < warp ? mx<NANS>(x_tot[par + lane], x_ca[par + lane]) : -INFINITY;
      const float carry = key_value(__reduce_max_sync(FULL, order_key(wt)));
      const float base = mx<NANS>(carry, x_ca[par + warp]);  // ... and this warp's first M'
      const float inc = lane > 0 ? mx<NANS>(base, up) : base;  // through lane i0-1 (k > 0: i0)
      if (edge) {
        newM[0] = x_s[par + warp] + sc[0];
        Q[0] = mx<NANS>(newM[0], Q[0]);
        // bit 3 of the previous column, from the warp below
        if (c > 0) acc[0] |= (uint32_t)x_e[par + warp] << (4 * ((s + 7) & 7) + 3);
      }
      if (s == 0 && c0 > 0) {  // the previous group's word is complete
        int32_t* out = ptr + ((size_t)((c0 >> 3) - 1) * B + row) * MP;
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          const int i = i0 + k;
          if (i < MP) out[i == 0 ? MP - 1 : i - 1] = (int32_t)acc[k];
          acc[k] = 0;
        }
      }
      int ext[LPT];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const float fi = (float)(i0 + k);
        const float cm_k = k == 0 ? (lane > 0 ? inc : carry) : mx<NANS>(inc, pre[k - 1]);
        const float iv = (i0 + k == 0 ? NEGF : cm_k) + fi * p.g;
        const float s_new = mx<NANS>(Q[k], iv);
        const int which = newM[k] >= s_new ? 0 : (iv >= s_new ? 2 : 1);
        ext[k] = (iv + p.ge_v) >= (s_new + p.go_v) ? 1 : 0;
        const int bit3 = k > 0 ? ext[k - 1] << 3 : 0;
        acc[k] |= (uint32_t)(which | ihx[k] | bit3) << (4 * s);
        S[k] = s_new;
        if (i0 + k == m) bot[c] = (c + 1 <= n) ? s_new : NEGF;
        sc[k] = scn[k];
      }
      // bit 3 of a thread's first lane: lane i0-1's test, same column
      const int e_up = __shfl_up_sync(FULL, ext[LPT - 1], 1);
      if (lane > 0) acc[0] |= (uint32_t)e_up << (4 * s + 3);
      e_last = ext[LPT - 1];
    }
    cur = nxt;
  }
  if (c_end > 0) {
    // the last column's bit 3 for each warp's first lane (parity 0 was
    // last read before the last step's barrier), then the last word
    if (feeds) x_e[warp + 1] = e_last;
    __syncthreads();
    if (edge) acc[0] |= (uint32_t)x_e[warp] << (4 * 7 + 3);
    int32_t* out = ptr + ((size_t)((c_end >> 3) - 1) * B + row) * MP;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int i = i0 + k;
      if (i < MP) out[i == 0 ? MP - 1 : i - 1] = (int32_t)acc[k];
    }
  }
  for (int c = c_end + x; c < N; c += blockDim.x) bot[c] = NEGF;
}

// TABLE on a cluster of K CTAs a row, MPC lanes a CTA (MPC / 4 threads of
// 4 contiguous lanes each): warps chained by rings, no barrier a step
// (see the top of the file).  Shared memory: [the CTA ring: RING_FLOATS]
// [the warp rings: CL_WARPS x LRING full, then empty mbarriers; then
// CL_WARPS x LRING slots, warp w's at w * LRING, warp 0's unused] [the
// CTA's U x 258 scores]
template <bool NANS>
__global__ void __launch_bounds__(CL_MAX_LANES / 4)
col_cluster_kernel(Table tb, const int* __restrict__ nact, int32_t* __restrict__ ptr,
                   float* __restrict__ bottom, int B, int N, int MP, int MPC, int m, Params p) {
  constexpr int LPT = 4;
  const int K = (int)cg::this_cluster().num_blocks();
  const int rank = (int)cg::this_cluster().block_rank();
  const int row = blockIdx.x / K;
  if (other_instance<NANS>(tb, row, K * tb.up)) return;
  extern __shared__ __align__(16) float smem_all[];
  float* wring = smem_all + RING_FLOATS;
  float* wdata = wring + 4 * CL_WARPS * LRING;
  float* T = wdata + CL_WARPS * LRING * SLOT_FLOATS;
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int warps = blockDim.x >> 5;
  const int lane0 = rank * MPC;      // the CTA's first lane
  const int i0 = lane0 + x * LPT;    // first lane of this thread
  const bool active = i0 < MP;
  // the ring ends: a warp's first thread waits for its slot (from CTA
  // k - 1's last warp for warp 0), its last thread sends (to CTA k + 1
  // from the last warp); warp 0 of CTA 0 has lane -1 below it
  const bool below = warp > 0 || rank > 0;
  const bool recv = lane == 0 && below;
  const bool send = lane == 31 && (warp + 1 < warps || rank + 1 < K);
  const bool remote_in = rank > 0 && warp == 0;
  const bool remote_out = send && warp + 1 == warps;
  const uint32_t ring_a = smem_addr(smem_all);
  const uint32_t full_a = ring_a + 4 * RING * SLOT_FLOATS;
  const uint32_t empty_a = full_a + 8 * RING;
  const uint32_t wfull_a = smem_addr(wring);
  const uint32_t wempty_a = wfull_a + 8 * CL_WARPS * LRING;
  int n = nact[row];
  if (n > N) n = N;
  int c_end = (n + 7) & ~7;
  if (c_end > N) c_end = N;
  const int groups = c_end >> 3;
  const uint8_t* brow = tb.bins + (size_t)row * N;
  float* bot = bottom + (size_t)row * N;
  const float fill_s = p.neg_h ? -p.dmin : NEGF;

  float S[LPT], Ih[LPT];
  int tbase[LPT];
  uint32_t acc[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int i = i0 + k;
    S[k] = (i == 0) ? 0.0f : p.go_v + p.ge_v * ((float)i - 1.0f);
    Ih[k] = NEGF;
    tbase[k] = i < MP ? tb.lidx[i] * SCORE_COLS : 0;
    acc[k] = 0;
  }
  // S of lane i0 - 1 at the column before the group's first (before column
  // 0: its value as a lane's S starts; lane -1's fill below CTA 0's warp 0)
  float in_s = below ? p.go_v + p.ge_v * ((float)(i0 - 1) - 1.0f) : fill_s;
  uint32_t out_e = 0;  // send: the group's extend bits of the warp's last lane
  if (x == 0) {
    for (int q = 0; q < RING; ++q) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(full_a + 8 * q));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(empty_a + 8 * q));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (rank > 0)
      for (int q = 0; q < RING && q < groups; ++q) expect_tx(full_a + 8 * q, SLOT_BYTES);
  }
  for (int q = x; q < CL_WARPS * LRING; q += blockDim.x) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(wfull_a + 8 * q));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(wempty_a + 8 * q));
  }
  {
    // entry [u][b]: the CTA's level u against bin b's value (b < 256), NEG
    // (b = 256) or 0.0 (b = 257), as ops/align_cuda.py `score_table`
    const float* lut = tb.lut + (size_t)row * 256;
    const float* lv = tb.levels + (size_t)rank * tb.up;
    for (int e = x; e < tb.up * SCORE_COLS; e += blockDim.x) {
      const int u = e / SCORE_COLS;
      const int b = e - u * SCORE_COLS;
      const float xv = b < 256 ? lut[b] : (b == 256 ? NEGF : 0.0f);
      T[e] = cell_score(xv, lv[u], p);
    }
  }
  Cols<TABLE> cur, nxt;
  cur.bn = nxt.bn = make_uint2(0, 0);
  if (c_end > 0) cur.load(nullptr, brow, 0);
  cg::this_cluster().sync();  // every CTA's table and mbarriers ready before any byte moves

  // group g: CTA ring slot g % RING, warp ring slot g % LRING
  for (int g = 0; g < groups; ++g) {
    const int c0 = g << 3;
    if (c0 + 8 < c_end) nxt.load(nullptr, brow, c0 + 8);
    const int slot = g % RING, wslot = g % LRING;
    const float* rs = remote_in ? smem_all + slot * SLOT_FLOATS
                                : wdata + (warp * LRING + wslot) * SLOT_FLOATS;
    float* ws = wdata + ((warp + 1) * LRING + wslot) * SLOT_FLOATS;  // a local send's slot
    if (recv)
      wait_parity_cta(remote_in ? full_a + 8 * slot : wfull_a + 8 * (warp * LRING + wslot),
                      (g / (remote_in ? RING : LRING)) & 1);
    if (send && g >= (remote_out ? RING : LRING))
      wait_parity_cta(remote_out ? empty_a + 8 * slot
                                 : wempty_a + 8 * ((warp + 1) * LRING + wslot),
                      (g / (remote_out ? RING : LRING) - 1) & 1);
    __syncwarp();
    // lanes 0-7: column c0 + lane's P from below and S of lane i0 - 1 at
    // the column before it; lane 0 the extend bits and the next in_s
    float g_p = -INFINITY, g_s = in_s;
    uint32_t in_e = 0;
    if (below && lane < 8) {
      g_p = rs[2 * lane + 1];
      if (lane > 0) g_s = rs[2 * lane - 2];
    }
    if (below && lane == 0) {
      in_e = __float_as_uint(rs[16]);
      in_s = rs[2 * 7];
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int c = c0 + s;
      // the prefix through the lane below the warp's first, and that
      // lane's S at column c - 1
      const float carry = __shfl_sync(FULL, g_p, s);
      const float s_in = __shfl_sync(FULL, g_s, s);
      const float s_up = __shfl_up_sync(FULL, S[LPT - 1], 1);  // S(i0-1) within the warp
      float newM[LPT], Q[LPT], pre[LPT];
      int ihx[LPT];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const float fi = (float)(i0 + k);
        const float sc = cur.score(s, 0.0f, tbase[k], T, p);
        const float ih_ext = Ih[k] + p.ge_h;
        const float ih_open = S[k] + p.go_h;
        ihx[k] = ih_ext >= ih_open ? 4 : 0;
        Ih[k] = mx<NANS>(ih_ext, ih_open);
        const float left = k > 0 ? S[k - 1] : (lane > 0 ? s_up : s_in);
        newM[k] = left + sc;
        float q = mx<NANS>(newM[k], Ih[k]);
        if (!p.neg_h && i0 + k == 0) q = 0.0f;
        Q[k] = q;
        const float cv = (q + p.go_v) - ((fi + 1.0f) * p.g);
        pre[k] = k == 0 ? cv : mx<NANS>(pre[k - 1], cv);
      }
      float tot = active ? pre[LPT - 1] : NEGF;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float y = __shfl_up_sync(FULL, tot, d);
        if (lane >= d) tot = mx<NANS>(tot, y);
      }
      const float up = __shfl_up_sync(FULL, tot, 1);  // through thread x-1 (this warp)
      const float inc = lane > 0 ? mx<NANS>(carry, up) : carry;  // through lane i0-1
      int ext[LPT];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const float fi = (float)(i0 + k);
        const float cm_k = k == 0 ? inc : mx<NANS>(inc, pre[k - 1]);
        const float iv = (i0 + k == 0 ? NEGF : cm_k) + fi * p.g;
        const float s_new = mx<NANS>(Q[k], iv);
        const int which = newM[k] >= s_new ? 0 : (iv >= s_new ? 2 : 1);
        ext[k] = (iv + p.ge_v) >= (s_new + p.go_v) ? 1 : 0;
        const int bit3 = k > 0 ? ext[k - 1] << 3 : 0;
        acc[k] |= (uint32_t)(which | ihx[k] | bit3) << (4 * s);
        S[k] = s_new;
        if (i0 + k == m) bot[c] = (c + 1 <= n) ? s_new : NEGF;
      }
      // bit 3 of a thread's first lane: lane i0-1's test, same column (the
      // warp's first lane: the ring's bit)
      const int e_up = __shfl_up_sync(FULL, ext[LPT - 1], 1);
      acc[0] |= (lane > 0 ? (uint32_t)e_up : (in_e >> s) & 1u) << (4 * s + 3);
      if (send) {  // this column's S and P of the warp's last lane
        const float p_out = mx<NANS>(inc, pre[LPT - 1]);
        if (remote_out)
          st_async_v2(ring_a + 4 * (slot * SLOT_FLOATS + 2 * s), S[LPT - 1], p_out,
                      full_a + 8 * slot, rank + 1);
        else
          *reinterpret_cast<float2*>(ws + 2 * s) = make_float2(S[LPT - 1], p_out);
        out_e |= (uint32_t)ext[LPT - 1] << s;
      }
    }
    int32_t* out = ptr + ((size_t)g * B + row) * MP;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int i = i0 + k;
      if (i < MP) out[i == 0 ? MP - 1 : i - 1] = (int32_t)acc[k];
      acc[k] = 0;
    }
    if (send) {
      if (remote_out) {
        st_async_b32(ring_a + 4 * (slot * SLOT_FLOATS + 16), out_e, full_a + 8 * slot, rank + 1);
      } else {
        ws[16] = __uint_as_float(out_e);
        arrive_local(wfull_a + 8 * ((warp + 1) * LRING + wslot));
      }
      out_e = 0;
    }
    __syncwarp();  // lanes 0-7's reads of the slot are done
    if (recv) {
      if (remote_in) {
        if (g + RING < groups) expect_tx(full_a + 8 * slot, SLOT_BYTES);
        arrive_remote_after_reads(empty_a + 8 * slot, rank - 1);  // the slot is free again
      } else {
        arrive_local(wempty_a + 8 * (warp * LRING + wslot));
      }
    }
    cur = nxt;
  }
  if (m >= lane0 && m < lane0 + MPC)  // the CTA of the bottom lane
    for (int c = c_end + x; c < N; c += blockDim.x) bot[c] = NEGF;
  cg::this_cluster().sync();  // no CTA leaves while a peer may write into it
}

template <int LPT, int SCORE, bool NANS>
cudaError_t launch_one(const float* sig, const float* tmpl, const Table& tb, const int* nact,
                       int32_t* ptr, float* bottom, int B, int N, int MP, int m, Params p,
                       cudaStream_t stream) {
  const int threads = ((MP / LPT) + 31) / 32 * 32;
  const size_t table = SCORE == TABLE ? (size_t)tb.up * SCORE_COLS : 0;
  const size_t shmem = (EXCH + table) * sizeof(float);
  if (shmem > SMEM_MAX) return cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(col_align_kernel<LPT, SCORE, NANS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
    if (e != cudaSuccess) return e;
  }
  col_align_kernel<LPT, SCORE, NANS><<<B, threads, shmem, stream>>>(
      sig, tmpl, tb, nact, ptr, bottom, B, N, MP, MP, m, p);
  return cudaGetLastError();
}

// POW: the max_nan instance; TABLE: both, each taking its own rows
template <int LPT, int SCORE>
cudaError_t launch(const float* sig, const float* tmpl, const Table& tb, const int* nact,
                   int32_t* ptr, float* bottom, int B, int N, int MP, int m, Params p,
                   cudaStream_t stream) {
  if (SCORE == TABLE) {
    cudaError_t e =
        launch_one<LPT, SCORE, false>(sig, tmpl, tb, nact, ptr, bottom, B, N, MP, m, p, stream);
    if (e != cudaSuccess) return e;
  }
  return launch_one<LPT, SCORE, true>(sig, tmpl, tb, nact, ptr, bottom, B, N, MP, m, p, stream);
}

// the cluster launch's configuration: K CTAs a row, MPC / 4 threads, and
// every CTA a whole SM's shared memory, so no two CTAs of a call share an
// SM's issue (the block scheduler packs a cluster's CTAs onto SMs where
// their memory fits)
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int B, int MPC, int K,
                                  cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * K);
  cfg.blockDim = dim3(MPC / 4);
  cfg.dynamicSmemBytes = SMEM_MAX;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// TABLE on a cluster of K CTAs a row, MPC lanes each, 4 lanes a thread
template <bool NANS>
cudaError_t launch_cluster_one(const Table& tb, const int* nact, int32_t* ptr, float* bottom,
                               int B, int N, int MP, int MPC, int K, int m, Params p,
                               cudaStream_t stream) {
  auto kern = col_cluster_kernel<NANS>;
  if ((CL_FIXED + (size_t)tb.up * SCORE_COLS) * sizeof(float) > SMEM_MAX)
    return cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, B, MPC, K, stream);
  // the cluster must fit the card: K CTAs of this shared memory on K SMs
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kern, tb, nact, ptr, bottom, B, N, MP, MPC, m, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

cudaError_t launch_cluster(const Table& tb, const int* nact, int32_t* ptr, float* bottom, int B,
                           int N, int MP, int MPC, int K, int m, Params p, cudaStream_t stream) {
  cudaError_t e = launch_cluster_one<false>(tb, nact, ptr, bottom, B, N, MP, MPC, K, m, p, stream);
  if (e != cudaSuccess) return e;
  return launch_cluster_one<true>(tb, nact, ptr, bottom, B, N, MP, MPC, K, m, p, stream);
}

bool shape_ok(int N, int MP, int m) { return MP % 128 == 0 && N % 8 == 0 && m > 0 && m < MP; }

// a cluster split the host's rule can give: K in 2..8 CTAs of MPC lanes
// (a multiple of 128, at most CL_MAX_LANES), none empty
bool split_ok(int MP, int K, int MPC) {
  return K >= 2 && K <= MAX_CTAS && MPC > 0 && MPC % 128 == 0 && MPC <= CL_MAX_LANES &&
         (K - 1) * MPC < MP && K * MPC >= MP;
}

// the most clusters of K CTAs of MPC lanes the card runs at once, as
// launch_cluster_one launches them (one CTA an SM); 0 when none fits
int cluster_capacity(int K, int MPC) {
  auto kern = col_cluster_kernel<false>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX))
    return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, 1, MPC, K, nullptr);
  int clusters = 0;
  return cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg) == cudaSuccess ? clusters : 0;
}

}  // namespace

// clusters of K CTAs of MPC lanes (a split col_table_launch takes) the
// card runs at once; the host's launch plan keeps a call's rows within it
extern "C" int col_cluster_capacity(int K, int MPC) {
  if (!(K >= 2 && K <= MAX_CTAS && MPC > 0 && MPC % 128 == 0 && MPC <= CL_MAX_LANES)) return 0;
  return cluster_capacity(K, MPC);
}

extern "C" int col_align_launch(const void* sig, const void* tmpl, const void* nact, void* ptr,
                                void* bottom, int B, int N, int MP, int m, int neg_h,
                                float go_h, float go_v, float ge_h, float ge_v, float off,
                                float dmin, float g, void* stream) {
  if (!shape_ok(N, MP, m)) return (int)cudaErrorInvalidValue;
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  auto s = (const float*)sig;
  auto tp = (const float*)tmpl;
  auto na = (const int*)nact;
  auto pt = (int32_t*)ptr;
  auto bt = (float*)bottom;
  auto st = (cudaStream_t)stream;
  const Table none{};
  if (MP <= 1024) return (int)launch<1, POW>(s, tp, none, na, pt, bt, B, N, MP, m, p, st);
  if (MP <= 2048) return (int)launch<2, POW>(s, tp, none, na, pt, bt, B, N, MP, m, p, st);
  if (MP <= 4096) return (int)launch<4, POW>(s, tp, none, na, pt, bt, B, N, MP, m, p, st);
  if (MP <= 8192) return (int)launch<8, POW>(s, tp, none, na, pt, bt, B, N, MP, m, p, st);
  return (int)cudaErrorInvalidValue;
}

// TABLE: 4 lanes a thread, one CTA a row (ctas = 1, MP <= 1024) or a
// cluster of `ctas` CTAs of mpc lanes each; bins (B, N) read in place;
// levels (ctas, UP), each CTA's own
extern "C" int col_table_launch(const void* bins, const void* lut, const void* levels,
                                const void* lidx, const void* nact, void* ptr, void* bottom,
                                int B, int N, int MP, int UP, int ctas, int mpc, int m,
                                int neg_h, float go_h, float go_v, float ge_h, float ge_v,
                                float off, float dmin, float g, void* stream) {
  if (!shape_ok(N, MP, m)) return (int)cudaErrorInvalidValue;
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  const Table tb{(const uint8_t*)bins, (const float*)lut, (const float*)levels,
                 (const int*)lidx, UP};
  if (ctas == 1) {
    if (MP > 1024 || mpc != MP) return (int)cudaErrorInvalidValue;
    return (int)launch<4, TABLE>(nullptr, nullptr, tb, (const int*)nact, (int32_t*)ptr,
                                 (float*)bottom, B, N, MP, m, p, (cudaStream_t)stream);
  }
  if (!split_ok(MP, ctas, mpc)) return (int)cudaErrorInvalidValue;
  return (int)launch_cluster(tb, (const int*)nact, (int32_t*)ptr, (float*)bottom, B, N, MP, mpc,
                             ctas, m, p, (cudaStream_t)stream);
}
