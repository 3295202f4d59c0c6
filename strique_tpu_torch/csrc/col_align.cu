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
// block): a thread-block cluster of K CTAs a row (K <= 8, picked on the
// host by ops/align_cuda.py `col_table_ctas`), CTA k owning the
// contiguous lanes [k MPC, (k+1) MPC) at 4 lanes a thread and a score
// table of only its own lanes' levels.  What CTA k needs of the lanes
// below it at column c is what a warp needs of the warps below it: the
// prefix total through lane k MPC - 1 at column c (P), S of that lane at
// column c - 1 and its extend test at column c.  None of it depends on
// CTA k, so CTA k runs behind CTA k - 1: the thread of CTA k - 1 that
// owns its last lane sends (S, P) each column and the group's 8 extend
// bits by st.async into a ring slot of CTA k's shared memory (one slot
// an 8-column group, one "full" mbarrier a slot, on which the bytes
// complete); thread 0 of CTA k waits on a slot once a group, passes P to
// its warps beside the exchange slots (one more float a step, under the
// same barrier), takes S into its M move and the extend bit into its
// first lane's bit 3, and frees the slot by a remote arrive on the
// sender's "empty" mbarrier.  Each CTA keeps its one barrier a step.  Max
// is exact, so folding P into each warp's carry gives the one-CTA
// kernel's values.
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
// the cluster form's ring, at the start of shared memory: RING slots of an
// 8-column group ((S, P) a column, then the extend bits, padded to 16
// bytes), a "full" and an "empty" mbarrier a slot, and the CTA's P by
// step parity (ops/align_cuda.py COL_RING_BYTES = 4 RING_FLOATS)
constexpr int RING = 8;
constexpr int SLOT_FLOATS = 20;
constexpr uint32_t SLOT_BYTES = 4 * 17;  // 8 (S, P) pairs and the bits
constexpr int RING_FLOATS = RING * SLOT_FLOATS + RING * 2 * 2 + 4;
constexpr int MAX_CTAS = 8;  // a portable cluster
constexpr int CL_MAX_LANES = 2048;  // a cluster CTA's lanes: 512 threads of 4

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

// TABLE mode on one CTA runs MP <= 1024 lanes, so at most 1024 / LPT
// threads; the cluster form (CL) up to CL_MAX_LANES lanes a CTA.  One
// CTA a row has MPC = MP.  NANS: which max the DP takes.  A TABLE row
// whose level table and template levels are all finite meets no NaN
// (every score is finite, every DP value finite or -inf, and nothing
// subtracts infinities), so the fmaxf instance runs it; any other row,
// and POW, the max_nan instance.  A TABLE call launches both instances
// over all its rows, and each leaves at once the rows that are the
// other's (every CTA of a cluster row reads the same values, so they
// leave together, before any of them touches a peer).
template <int LPT, int SCORE, bool CL, bool NANS>
__global__ void __launch_bounds__(CL ? CL_MAX_LANES / LPT
                                     : (SCORE == TABLE ? MAX_THREADS / LPT : MAX_THREADS))
col_align_kernel(const float* __restrict__ sig, const float* __restrict__ tmpl, Table tb,
                 const int* __restrict__ nact, int32_t* __restrict__ ptr,
                 float* __restrict__ bottom, int B, int N, int MP, int MPC, int m, Params p) {
  if constexpr (SCORE == TABLE) {
    const int rows_k = CL ? (int)cg::this_cluster().num_blocks() : 1;
    const float* lut = tb.lut + (size_t)(blockIdx.x / rows_k) * 256;
    bool odd = false;
    for (int e = threadIdx.x; e < 256 + rows_k * tb.up; e += blockDim.x) {
      const float v = e < 256 ? lut[e] : tb.levels[e - 256];
      odd |= !(fabsf(v) <= 3.402823466e38f);  // NaN or inf
    }
    if ((__syncthreads_or(odd) != 0) != NANS) return;  // the other instance's row
  }
  // CL: the ring first (RING_FLOATS).  Then the exchange slots [parity *
  // 32 + warp]; TABLE: the U x 258 scores follow
  extern __shared__ __align__(16) float smem_all[];
  float* smem = smem_all + (CL ? RING_FLOATS : 0);
  float* x_tot = smem;               // the warp's prefix total, its first lane's M' left out
  float* x_ca = smem + 64;           // warp w's first lane: its M' prefix term (from w-1)
  float* x_s = smem + 128;           // warp w: S of warp w-1's last lane, previous column
  int* x_e = (int*)(smem + 192);     // warp w: warp w-1's last extend test, previous column
  float* x_sc = smem + 256;          // warp w's first lane: its score at the next column
  const float* T = smem + EXCH;
  float* x_p = smem_all + RING_FLOATS - 4;  // CL: the CTA's P, by step parity

  int K = 1, rank = 0;  // CTAs of the row, this CTA's place among them
  if constexpr (CL) {
    K = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int row = blockIdx.x / K;
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int lane0 = rank * MPC;  // the CTA's first lane
  const int i0 = lane0 + x * LPT;  // first lane of this thread
  const bool active = i0 < MP;
  const bool edge = lane == 0 && warp > 0;            // S(i0-1) lives in the warp below
  const bool feeds = lane == 31 && warp + 1 < n_warps;  // feeds the next warp's first lane
  const float f_next = (float)(i0 + LPT);             // that lane's row
  // CL: thread 0 takes lane lane0 - 1's S, P and extend test from the
  // ring (recv); the thread of the CTA's last lane sends its own (send)
  const bool recv = CL && rank > 0 && x == 0;
  const bool send = CL && rank + 1 < K && x == blockDim.x - 1;
  const uint32_t ring_a = smem_addr(smem_all);
  const uint32_t full_a = ring_a + 4 * RING * SLOT_FLOATS;
  const uint32_t empty_a = full_a + 8 * RING;
  int n = nact[row];
  if (n > N) n = N;
  int c_end = (n + 7) & ~7;
  if (c_end > N) c_end = N;
  const int groups = c_end >> 3;
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
  // recv: S of lane lane0 - 1 at the column before the current one (its
  // value before column 0 as the lane's own S starts)
  float in_s = p.go_v + p.ge_v * ((float)(lane0 - 1) - 1.0f);
  uint32_t in_e = 0;   // recv: the group's extend bits of lane lane0 - 1
  uint32_t out_e = 0;  // send: the group's extend bits of the CTA's last lane
  for (int i = x; i < 64; i += blockDim.x) x_ca[i] = -INFINITY;  // warp 0: no M' from below
  if constexpr (CL) {
    if (x == 0) {
      for (int q = 0; q < RING; ++q) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(full_a + 8 * q));
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(empty_a + 8 * q));
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (rank > 0)
        for (int q = 0; q < RING && q < groups; ++q) expect_tx(full_a + 8 * q, SLOT_BYTES);
    }
  }
  if (SCORE == TABLE) {
    // entry [u][b]: template level u against bin b's value (b < 256), NEG
    // (b = 256) or 0.0 (b = 257), as ops/align_cuda.py `score_table`
    const float* lut = tb.lut + (size_t)row * 256;
    const float* lv = tb.levels + (size_t)rank * tb.up;
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
  if constexpr (CL)
    cg::this_cluster().sync();  // the table, and every CTA's mbarriers initialised
  else
    __syncthreads();  // the table
#pragma unroll
  for (int k = 0; k < LPT; ++k) sc[k] = cur.score(0, tm[k], tbase[k], T, p);
  if (edge) x_sc[32 + warp] = sc[0];  // read at step 0 from parity 1
  __syncthreads();

  int e_last = 0;  // the extend test of this thread's last lane, previous column
  for (int c0 = 0; c0 < c_end; c0 += 8) {
    if (c0 + 8 < c_end) nxt.load(a, brow, c0 + 8);
    const int g = c0 >> 3;
    const int slot = g % RING;
    const float* rs = smem_all + slot * SLOT_FLOATS;
    if (CL && recv) {
      wait_parity(full_a + 8 * slot, (g / RING) & 1);
      in_e = __float_as_uint(rs[16]);
    }
    if (CL && send && g >= RING) wait_parity(empty_a + 8 * slot, (g / RING - 1) & 1);
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
      // S of the lane below the CTA at the previous column, and P
      const float s_in = CL && recv ? (s == 0 ? in_s : rs[2 * s - 2]) : fill_s;
      if (CL && recv) x_p[s & 1] = rs[2 * s + 1];
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
      float carry = key_value(__reduce_max_sync(FULL, order_key(wt)));
      if (CL && rank > 0) carry = mx<NANS>(carry, x_p[s & 1]);  // ... and the CTAs below
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
      // bit 3 of the CTA's first lane: the extend test below the CTA
      if (CL && recv) acc[0] |= ((in_e >> s) & 1u) << (4 * s + 3);
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
      if (CL && send) {  // this column's S and P of the CTA's last lane
        st_async_v2(ring_a + 4 * (slot * SLOT_FLOATS + 2 * s), S[LPT - 1],
                    mx<NANS>(inc, pre[LPT - 1]), full_a + 8 * slot, rank + 1);
        out_e |= (uint32_t)ext[LPT - 1] << s;
      }
      // bit 3 of a thread's first lane: lane i0-1's test, same column
      const int e_up = __shfl_up_sync(FULL, ext[LPT - 1], 1);
      if (lane > 0) acc[0] |= (uint32_t)e_up << (4 * s + 3);
      e_last = ext[LPT - 1];
    }
    if (CL && send) {
      st_async_b32(ring_a + 4 * (slot * SLOT_FLOATS + 16), out_e, full_a + 8 * slot, rank + 1);
      out_e = 0;
    }
    if (CL && recv) {
      in_s = rs[2 * 7];
      if (g + RING < groups) expect_tx(full_a + 8 * slot, SLOT_BYTES);
      arrive_remote(empty_a + 8 * slot, rank - 1);  // the slot is free again
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
  if (m >= lane0 && m < lane0 + MPC)  // the CTA of the bottom lane
    for (int c = c_end + x; c < N; c += blockDim.x) bot[c] = NEGF;
  if constexpr (CL) cg::this_cluster().sync();  // no CTA leaves while a peer may write into it
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
    cudaError_t e = cudaFuncSetAttribute(col_align_kernel<LPT, SCORE, false, NANS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
    if (e != cudaSuccess) return e;
  }
  col_align_kernel<LPT, SCORE, false, NANS><<<B, threads, shmem, stream>>>(
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

// TABLE on a cluster of K CTAs a row, MPC lanes each, 4 lanes a thread
template <bool NANS>
cudaError_t launch_cluster_one(const Table& tb, const int* nact, int32_t* ptr, float* bottom,
                               int B, int N, int MP, int MPC, int K, int m, Params p,
                               cudaStream_t stream) {
  auto kern = col_align_kernel<4, TABLE, true, NANS>;
  const size_t shmem = (RING_FLOATS + EXCH + (size_t)tb.up * SCORE_COLS) * sizeof(float);
  if (shmem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * K);
  cfg.blockDim = dim3(MPC / 4);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the cluster must fit the card: K CTAs of this shared memory on K SMs
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kern, (const float*)nullptr, (const float*)nullptr, tb, nact, ptr,
                         bottom, B, N, MP, MPC, m, p);
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

}  // namespace

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
