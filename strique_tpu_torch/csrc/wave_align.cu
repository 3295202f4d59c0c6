// Anti-diagonal Gotoh flank alignment: pointers, checkpoints, windows.
//
// Replaces the Pallas TPU kernel strique_tpu/ops/align_pallas.py
// `_wave_kernel` in all four of its calls, as compile-time modes of one
// body:
//   PTR     `align_forward_wave` (one template shared by every row: a
//           template row stride of 0) and `align_forward_wave_multi` (a
//           template and length per row, flank fusion): pointer words and
//           bottom taps.
//   CKPT    `align_forward_ckpt`, pass 1 of the ultra-long two-pass route:
//           no pointer plane, bottom taps, and the diagonal state (S1, S2,
//           Ih, C) dumped after every ckpt_steps-th step.
//   WINDOW  `align_window_from_state`, pass 2: pointer words over a W-step
//           window resumed from a checkpoint; column-0 forcing only for
//           rows that start cold; no bottom taps (the caller discards
//           them).
//
// and two compile-time score modes:
//   POW     every cell evaluates |d|^1.2 of its f32 signal sample and
//           template value in double precision (all three modes).
//   TABLE   morph-form input (all three modes, MP <= 1024): u8 bins (B, NB)
//           and a 256-entry f32 level table per read, the template as its
//           U distinct values plus each lane's index into them.  A row
//           meets at most U x 258 distinct (template value, signal value)
//           pairs: U levels against the 256 bins, the NEG fill before the
//           read and the 0.0 fill past its end.  The CTA evaluates those
//           scores once, with POW's own expression, into shared memory
//           behind the exchange buffers (123-147 KB for the bench
//           templates' 119-142 levels); each cell then looks its score up
//           by its lane's level and its bin.  A bins row is read in place
//           in every mode: CKPT runs ND steps past a row of NB samples
//           (the POW route pads the f32 row with 0.0 up to ND - MP, which
//           the 0.0 column stands for), and a window reads its row at the
//           row's own offset t0, with 0.0 on both sides of the read (the
//           POW window's gather fill).
//
// What bounds it on an H100: the serial chain of diagonal steps.  Step t
// of row r needs step t-1 of the neighbouring template lane (S, C) and
// step t-2 (S), so a row is ND = N + MP dependent steps (~25.5k at the
// bench shape, ~1.31M for an ultra-long read in pass 1) with a
// block-wide barrier between them.  The pointer plane (ND/8 x B x 896
// int32, ~0.73 GB per 64-row bench call) is written once, coalesced, and
// is not the limit; pass 1 writes none and its checkpoints are
// ND/ckpt_steps x 4 planes (~9 MB per 8 ultra-long rows).  In POW mode
// the double-precision pow of every cell makes FP64 throughput the cost
// of a step (~1.2 us at the bench shape).  In TABLE mode a step is the
// recurrence's own f32 operations, its pointer code and the exchange,
// issued by one SM for all MP lanes of its row (~0.29 us; ~0.23 us in
// CKPT, which has no pointer code): instruction issue and the barrier
// set it.
//
// Design: one CTA per row (the wrapper sizes a call to the rows it has,
// up to the card's SM count, the two-pass route too, both flanks in one
// call).
// A lane's running state (S at t-1, Ih, the column cummax C, and S of
// lane i-1 at t-2) lives in registers, one thread per template lane (LPT
// lanes per thread when MP > 1024); S and C of lane i-1 come through a
// shared-memory double buffer, one __syncthreads per step.  Lane i reads
// its signal sample a[t-i] directly (NEG before the read, 0 past the
// padded end: the reference's reversed sliding window, indexed), in TABLE
// mode as its bin (256 before the read, 257 past the bins row) and
// that bin's table entry; in a POW window it reads sig_win[t-i], or
// r_init[i-t-1] before the window, both of which carry the reference
// window gather's 0.0 fill, and in a TABLE window the bin of sample
// t0 + t - i of its row (257 outside the read).  The step loop runs in
// unrolled groups of 8 steps (t_end is a multiple of 8), whose 4-bit
// codes pack into a register and store as one int32 word [t/8, row, i].
// A row stops at its own last useful step, round_up(n + m, 8) (in a
// window: round_up(steps_needed, 8)), and fills the rest of its bottom
// taps with NEG.  A checkpoint stride is a multiple of 128 steps, so a
// dump falls on the last step of a group: the test runs once a group.
// The checkpoint's S2 is the lane's OWN S at t-1 (the registers keep
// only lane i-1's, for the diagonal move), so the dump takes the lane's
// S1 before the step's update; a resumed window seeds the i-1 register
// from S2 of lane i-1.
//
// TABLE past one CTA (a template of more than 1024 lanes, or a table too
// large beside the row's exchange buffers), or where a call's rows leave
// SMs idle: a thread-block cluster of K CTAs a row (K <= 8, picked on the
// host by ops/align_cuda.py `wave_launch_plan`, by the step each K takes
// within the SM count).  CTA k owns the contiguous lanes [k MPC, (k+1)
// MPC), MPC a multiple of 128 up to 2048, and builds the score table of
// only the levels its own lanes use (the host's per-CTA
// `template_levels`), so each CTA's table fits its SM.  A thread owns one
// lane (two contiguous ones past 1024 lanes a CTA, four past 1536), a
// warp 32 LPT contiguous lanes.  Lane i needs S and C of lane i-1 at step
// t - 1 and nothing flows the other way, so no barrier runs a step: inside a warp
// the values move by shuffle, and each warp runs a group behind the one
// before it, whose last lane fills a ring for the warp's first: in shared
// memory between the warps of a CTA (LRING slots, local full/empty
// mbarriers), by st.async into CTA k's shared memory from CTA k - 1 (RING
// slots, one "full" mbarrier each, on which the bytes complete, freed by
// a remote arrive on CTA k - 1's "empty" mbarrier).  A slot holds an
// 8-step group; its receiver waits once a group.  A lane reads its
// group's scores before the group from bins it read a group earlier, off
// the step's chain.  A
// cluster barrier at the start (the mbarriers and tables ready) and at
// the end (no CTA leaves while a peer may still write into it) are the
// only others.  A form with one __syncthreads a step through
// shared-memory buffers (the one-CTA kernel's) stepped at a latency floor
// on a cluster (~490 cycles at 128 lanes a CTA, ~600 at 896;
// tools/probe_wave_cluster.py), its ring waits 3-13% of it.  A ring wait
// acquires at CTA scope and a slot is freed by a relaxed remote arrive
// after a CTA fence: a cluster-scope acquire invalidates the SM's L1 and
// a cluster-scope release waits for the thread's global stores.  Every
// CTA asks for a whole SM's shared memory, so no two share an SM, and
// the host keeps a call's clusters within what the card runs at once
// (wave_cluster_capacity).
// Every lane computes what the one-CTA kernel computes for it, from the
// same operands, so the cluster form is bit-equal to it (and to its
// twin).
//
// Value contract (bit-identical to the reference's f32 stream, up to the
// measured 1-ulp pow difference): every expression tree of the Pallas
// body is kept, and the build uses -fmad=false so no a + b*c contracts
// into an FMA.  |d|^1.2 is (float)pow((double)d, (double)1.2f); the +1e30
// template pad still yields sc = dmin.  TABLE and POW share one score
// function, so a table entry is the value POW computes for its pair.
// Every max is `max_nan` (PTX max.NaN.f32): NaN when either operand is
// NaN, as jnp.maximum and torch.maximum give it; fmaxf dropped the NaN of
// a flat read's all-NaN level table, and the read's gated row then ended
// elsewhere than the reference's.  On other operands it is max.f32,
// fmaxf's own instruction: the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

#include "cluster.cuh"

constexpr float NEGF = -1e30f;
constexpr double POW_EXP = 1.2000000476837158;  // (double)1.2f
constexpr int SCORE_COLS = 258;                 // 256 bins, NEG, 0.0
constexpr int BIN_NEG = 256;                    // before the read
constexpr int BIN_ZERO = 257;                   // 0.0: past the read (and around a window)
constexpr size_t SMEM_MAX = 232448;             // 227 KB: a block's dynamic shared memory
// the cluster form's ring, at the start of shared memory: RING slots of
// an 8-step group's (S, C) pairs, then a "full" and an "empty" mbarrier a
// slot (ops/align_cuda.py WAVE_RING_BYTES = 4 RING_FLOATS)
constexpr int RING = 8;
constexpr int SLOT_FLOATS = 16;
constexpr int RING_FLOATS = RING * SLOT_FLOATS + RING * 2 * 2;
constexpr uint32_t SLOT_BYTES = 4 * SLOT_FLOATS;
constexpr int LRING = 4;  // the cluster form's warp rings: slots, one 8-step group each
constexpr int MAX_CTAS = 8;                     // a portable cluster
constexpr int CL_MAX_LANES = 2048;              // a cluster CTA's lanes: 512 threads of 4
// the cluster form's lanes a thread, by the CTA's lanes: one up to 1024
// lanes, two up to 1536, four past it; each instance's launch bounds
// are its most threads (1024, 768, 512), so a thread of 2 or 4 lanes
// keeps its lanes' state, scores and bins in registers
constexpr int cluster_threads(int lpt) { return lpt == 1 ? 1024 : lpt == 2 ? 768 : 512; }

enum Mode { PTR = 0, CKPT = 1, WINDOW = 2 };
enum Score { POW = 0, TABLE = 1 };

struct Params {
  float go_h, go_v, ge_h, ge_v, off, dmin, g;
  int neg_h;
};

// what the CKPT and WINDOW modes read or write beyond the PTR mode's
struct Resume {
  const float* rinit;    // WINDOW, POW: (B, MP), lane i holds a[t0-1-i]
  const int* t0;         // WINDOW, TABLE: (B,), the window's first step
  const float* st[4];    // WINDOW: S1, S2, Ih, C after step t0-1, (B, MP) each
  const int* cold;       // WINDOW: (B,), 1 = the window starts at the origin
  float* ck[4];          // CKPT: S1, S2, Ih, C planes, (ND/ckpt_steps, B, MP)
  int ckpt_steps;        // CKPT
};

// what the TABLE score mode reads in place of sig and tmpl
struct Table {
  const uint8_t* bins;   // (B, NB) morph bins
  const float* lut;      // (B, 256) each read's level values
  const float* levels;   // (R, K, UP) distinct template values of each CTA's lanes
  const int* lidx;       // (R, MP) lane -> index into its CTA's levels of its row
  int up;                // UP
  int per_row;           // R == B (1) or R == 1 (0)
};

// What a probe reads of a cluster row's step loop (tools/probe_wave_cluster.cu
// compiles this file with WAVE_HOOK set to a counting hook): the loop's
// start and end, each ring wait (0: the CTA ring's slot full, 1: its
// slot empty again; 2, 3: the same of a warp ring), and a group's phases
// (mark 0: its start, 1: its scores read, 2: its waits done, 3: its 8
// steps done).  The kernels built here take NoHook, whose calls vanish.
struct NoHook {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void wait_begin() {}
  __device__ __forceinline__ void wait_end(int) {}
  __device__ __forceinline__ void finish(int) {}
};
#ifndef WAVE_HOOK
#define WAVE_HOOK NoHook
#endif

// a lane's running state
struct Lane {
  float S1, Ih, C, hS;   // S at t-1, Ih, column cummax, S of lane i-1 at t-2
  uint32_t acc;          // pointer codes of the current 8-step word
};

__device__ __forceinline__ float cell_score(float av, float tm, const Params& p) {
  const float diff = fabsf(av - tm);
  const float pw = (float)pow((double)diff, POW_EXP);
  return max_nan(p.off - pw, p.dmin);
}

// TABLE: the score-table column of sample ai of a row of NB bins; before
// the read it is `before` (NEG, or 0.0 in a window)
template <int BEFORE>
__device__ __forceinline__ int bin_at(const uint8_t* brow, int ai, int NB) {
  return ai < 0 ? BEFORE : (ai < NB ? (int)brow[ai] : BIN_ZERO);
}

// One DP cell: lane i at step t (nibble q = t & 7 of its pointer word),
// given its score and lane i-1's S and C at step t-1.  Updates the lane's
// state and its pointer word; the caller exchanges S and C and stores the
// word.
template <int MODE>
__device__ __forceinline__ void dp_cell(Lane& L, float sc, float s_prev, float c_sh, int i,
                                        int t, int q, const Params& p, int m, int n, bool cold,
                                        float* bot, bool dump, size_t ck_row, const Resume& r) {
  const float fi = (float)i;
  const float s2 = L.hS;  // S(i-1) at t-2
  L.hS = s_prev;
  const float ih_ext = L.Ih + p.ge_h;
  const float ih_open = L.S1 + p.go_h;
  float new_ih = max_nan(ih_ext, ih_open);
  const float new_m = s2 + sc;
  float q_s = max_nan(new_m, new_ih);
  if (!p.neg_h && i == 0) q_s = 0.0f;
  const float cvec = (q_s + p.go_v) - ((fi + 1.0f) * p.g);
  const float new_c = max_nan(c_sh, cvec);
  const float new_iv = c_sh + fi * p.g;
  float new_s = max_nan(q_s, new_iv);
  if (MODE != CKPT) {
    const int which = new_m >= new_s ? 0 : (new_iv >= new_s ? 2 : 1);
    const uint32_t code = which | ((ih_ext >= ih_open) ? 4 : 0)
                        | (((new_iv + p.ge_v) >= (new_s + p.go_v)) ? 8 : 0);
    L.acc |= code << (4 * q);
  }
  if (i == t + 1 && cold) {  // cell (t+1, 0) enters the valid region
    new_s = p.go_v + p.ge_v * (fi - 1.0f);
    new_ih = NEGF;
  }
  if (MODE != WINDOW && i == m) {
    const int j = t + 1 - m;
    bot[t] = (j >= 1 && j <= n) ? new_s : NEGF;
  }
  if (dump) {
    r.ck[0][ck_row + i] = new_s;
    r.ck[1][ck_row + i] = L.S1;  // the lane's own S at t-1
    r.ck[2][ck_row + i] = new_ih;
    r.ck[3][ck_row + i] = new_c;
  }
  L.S1 = new_s;
  L.Ih = new_ih;
  L.C = new_c;
}

// ND steps over rows of NS samples (the row stride of sig, or of the
// bins in TABLE mode).  PTR: ND = NS + MP.  CKPT: ND >= NS + MP, a
// multiple of ckpt_steps.  nact = n, mrow = m per row.  WINDOW: ND = W;
// POW reads sig = sig_win (B, W), TABLE the read's bins from t0; nact =
// the steps a row needs, mrow unused.  TABLE reads tb in place of sig
// and tmpl.  One CTA a row: its lanes MPC = MP (the launch passes MP
// twice), the exchange buffers' width.  Kept a parameter of its own:
// ptxas schedules the step by it, and the same kernel with W taken from
// MP ran its PTR and WINDOW steps 3-5% slower on an H100.
template <int LPT, int MODE, int SCORE>
__global__ void __launch_bounds__(1024)
wave_align_kernel(const float* __restrict__ sig, const float* __restrict__ tmpl, Table tb,
                  const int* __restrict__ nact, const int* __restrict__ mrow,
                  int32_t* __restrict__ ptr, float* __restrict__ bottom,
                  int B, int ND, int NS, int MP, int MPC, int tmpl_stride, Params p, Resume r) {
  // two buffers each of S and C, MPC + 1 floats: index 0 holds lane -1's
  // fill, lane li lives at index li + 1; in TABLE mode the U x 258 scores
  // follow
  extern __shared__ __align__(16) float smem[];
  const int W = MPC + 1;
  float* T = smem + 4 * W;

  const int K = 1, rank = 0;  // one CTA a row
  const int row = blockIdx.x / K;
  const int lane0 = rank * MPC;  // the CTA's first lane
  const int n = nact[row];
  const int m = MODE == WINDOW ? 0 : mrow[row];
  int t_end = (n + m + 7) & ~7;
  if (t_end > ND) t_end = ND;
  const float* a = SCORE == POW ? sig + (size_t)row * NS : nullptr;
  const float* tm_row = SCORE == POW ? tmpl + (size_t)row * tmpl_stride : nullptr;
  // a TABLE window's lane i at local step t reads sample toff + t - i
  const int toff = MODE == WINDOW && SCORE == TABLE ? r.t0[row] : 0;
  const uint8_t* brow = SCORE == TABLE ? tb.bins + (size_t)row * NS : nullptr;
  float* bot = MODE == WINDOW ? nullptr : bottom + (size_t)row * ND;
  const float fill_s = p.neg_h ? -p.dmin : NEGF;
  const bool cold = MODE != WINDOW || r.cold[row] != 0;

  Lane L[LPT];
  float tm[LPT];    // POW: the lane's template value
  int tbase[LPT];   // TABLE: the lane's level row in the score table
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int li = threadIdx.x + k * blockDim.x;
    const int i = lane0 + li;
    if (MODE == WINDOW && i < MP) {
      // resume: the state after step t0-1; hS is S of lane i-1 at t0-2
      const size_t o = (size_t)row * MP + i;
      L[k].S1 = r.st[0][o];
      L[k].Ih = r.st[2][o];
      L[k].C = r.st[3][o];
      L[k].hS = (i == 0) ? fill_s : r.st[1][o - 1];
    } else {
      // step -1 state: only cell (0, 0) (S = 0) is ever read before the
      // wavefront pins a lane's column-0 boundary
      L[k].S1 = (i == 0) ? 0.0f : NEGF;
      L[k].Ih = NEGF;
      L[k].C = NEGF;
      L[k].hS = (i == 0) ? fill_s : NEGF;  // S of lane i-1 at step -2
    }
    if (SCORE == POW) tm[k] = (i < MP) ? tm_row[i] : 1e30f;
    if (SCORE == TABLE)
      tbase[k] = (i < MP) ? tb.lidx[(size_t)row * tb.per_row * MP + i] * SCORE_COLS : 0;
    L[k].acc = 0;
    if (i < MP) {
      smem[W + li + 1] = L[k].S1;      // S buffer 1 (step -1)
      smem[3 * W + li + 1] = L[k].C;   // C buffer 1
    }
  }
  if (threadIdx.x == 0) {
    smem[0] = fill_s;
    smem[W] = fill_s;
    smem[2 * W] = NEGF;
    smem[3 * W] = NEGF;
  }
  if (SCORE == TABLE) {
    // entry [u][b]: template level u against bin b's value (b < 256), NEG
    // (b = 256) or 0.0 (b = 257)
    const float* lut = tb.lut + (size_t)row * 256;
    const float* lv = tb.levels + ((size_t)row * tb.per_row * K + rank) * tb.up;
    for (int e = threadIdx.x; e < tb.up * SCORE_COLS; e += blockDim.x) {
      const int u = e / SCORE_COLS;
      const int b = e - u * SCORE_COLS;
      const float x = b < 256 ? lut[b] : (b == BIN_NEG ? NEGF : 0.0f);
      T[e] = cell_score(x, lv[u], p);
    }
  }
  __syncthreads();

  // t_end is a multiple of 8 (ND and W are): groups of 8 steps, one
  // pointer word each.  CKPT: after step (g+1)*ckpt_steps - 1 the state
  // goes to slot g; ckpt_steps is a multiple of 8, so that step closes a
  // group.
  int ck_next = MODE == CKPT ? r.ckpt_steps : 0;
  size_t ck_row = (size_t)row * MP;
  for (int t0 = 0; t0 < t_end; t0 += 8) {
    const bool dump_group = MODE == CKPT && t0 + 8 == ck_next;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int t = t0 + s;
      float* s_cur = smem + (s & 1) * W;
      float* c_cur = smem + (2 + (s & 1)) * W;
      const float* s_prv = smem + ((s & 1) ^ 1) * W;
      const float* c_prv = smem + (2 + ((s & 1) ^ 1)) * W;
      const bool dump = dump_group && s == 7;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int li = threadIdx.x + k * blockDim.x;
        const int i = lane0 + li;
        if (i >= MP) continue;
        float sc;
        if (SCORE == TABLE) {
          const int b = MODE == WINDOW ? bin_at<BIN_ZERO>(brow, toff + t - i, NS)
                                       : bin_at<BIN_NEG>(brow, t - i, NS);
          sc = T[tbase[k] + b];
        } else {
          const int ai = t - i;
          float av;
          if (MODE == WINDOW)
            av = ai >= 0 ? a[ai] : r.rinit[(size_t)row * MP + (i - t - 1)];
          else
            av = ai < 0 ? NEGF : (ai < NS ? a[ai] : 0.0f);
          sc = cell_score(av, tm[k], p);
        }
        float sp = s_prv[li], cp = c_prv[li];
        dp_cell<MODE>(L[k], sc, sp, cp, i, t, s, p, m, n, cold, bot, dump, ck_row, r);
        s_cur[li + 1] = L[k].S1;
        c_cur[li + 1] = L[k].C;
        if (MODE != CKPT && s == 7) {
          ptr[((size_t)(t0 >> 3) * B + row) * MP + i] = (int32_t)L[k].acc;
          L[k].acc = 0;
        }
      }
      __syncthreads();
    }
    if (dump_group) {
      ck_next += r.ckpt_steps;
      ck_row += (size_t)B * MP;
    }
  }
  if (MODE != WINDOW && m >= lane0 && m < lane0 + MPC)  // the CTA of the bottom lane
    for (int t = t_end + threadIdx.x; t < ND; t += blockDim.x) bot[t] = NEGF;
}

// TABLE on a cluster of K CTAs a row, MPC lanes a CTA, LPT contiguous
// lanes a thread (thread j owns lanes LPT j .. LPT j + LPT - 1 of its
// CTA): warps chained by rings, no barrier a step (see the top of the
// file).
template <int LPT, int MODE, class Hook>
__global__ void __launch_bounds__(cluster_threads(LPT))
wave_cluster_kernel(Table tb, const int* __restrict__ nact, const int* __restrict__ mrow,
                    int32_t* __restrict__ ptr, float* __restrict__ bottom, int B, int ND,
                    int NS, int MP, int MPC, Params p, Resume r) {
  // [the CTA ring: RING_FLOATS][the warp rings, within 4 (MPC + 1)
  // floats: warps x LRING full then empty mbarriers, then the slots]
  // [the CTA's U x 258 scores]
  extern __shared__ __align__(16) float smem_all[];
  const int warps = blockDim.x >> 5;
  float* wring = smem_all + RING_FLOATS;
  float* wdata = wring + 4 * warps * LRING;
  float* T = wring + 4 * (MPC + 1);
  const int K = (int)cg::this_cluster().num_blocks();
  const int rank = (int)cg::this_cluster().block_rank();
  const int row = blockIdx.x / K;
  const int lane0 = rank * MPC + LPT * (int)threadIdx.x;  // the thread's first lane
  const int w = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int n = nact[row];
  const int m = MODE == WINDOW ? 0 : mrow[row];
  int t_end = (n + m + 7) & ~7;
  if (t_end > ND) t_end = ND;
  const int toff = MODE == WINDOW ? r.t0[row] : 0;
  const uint8_t* brow = tb.bins + (size_t)row * NS;
  float* bot = MODE == WINDOW ? nullptr : bottom + (size_t)row * ND;
  const float fill_s = p.neg_h ? -p.dmin : NEGF;
  const bool cold = MODE != WINDOW || r.cold[row] != 0;
  // the ring ends: a warp's first thread receives its predecessor lane's
  // (S, C) (from CTA k - 1 for warp 0), its last thread sends its own
  // (to CTA k + 1 from the last warp); warp 0 of CTA 0 reads lane -1's fill
  const bool recv = wl == 0 && (w > 0 || rank > 0);
  const bool send = wl == 31 && (w + 1 < warps || rank + 1 < K);
  const bool remote_in = recv && w == 0, remote_out = send && w + 1 == warps;
  const uint32_t ring_a = smem_addr(smem_all);
  const uint32_t full_a = ring_a + 4 * RING * SLOT_FLOATS;
  const uint32_t empty_a = full_a + 8 * RING;
  const uint32_t wfull_a = smem_addr(wring);
  const uint32_t wempty_a = wfull_a + 8 * warps * LRING;
  const int groups = t_end >> 3;

  Lane L[LPT];
  int tbase[LPT];  // the lane's level row in the score table
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int i = lane0 + k;
    if (MODE == WINDOW && i < MP) {
      const size_t o = (size_t)row * MP + i;
      L[k].S1 = r.st[0][o];
      L[k].Ih = r.st[2][o];
      L[k].C = r.st[3][o];
      L[k].hS = (i == 0) ? fill_s : r.st[1][o - 1];
    } else {
      L[k].S1 = (i == 0) ? 0.0f : NEGF;
      L[k].Ih = NEGF;
      L[k].C = NEGF;
      L[k].hS = (i == 0) ? fill_s : NEGF;
    }
    tbase[k] = (i < MP) ? tb.lidx[(size_t)row * tb.per_row * MP + i] * SCORE_COLS : 0;
    L[k].acc = 0;
  }
  // the receiver: S and C of its predecessor lane at the step before the
  // current one (step -1 first; lane -1's fill for warp 0 of CTA 0)
  float in_s = fill_s, in_c = NEGF;
  if (recv) {
    const int pl = lane0 - 1;
    in_s = MODE == WINDOW && pl < MP ? r.st[0][(size_t)row * MP + pl] : NEGF;
    in_c = MODE == WINDOW && pl < MP ? r.st[3][(size_t)row * MP + pl] : NEGF;
  }
  if (threadIdx.x == 0) {
    for (int q = 0; q < RING; ++q) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(full_a + 8 * q));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(empty_a + 8 * q));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (rank > 0)
      for (int q = 0; q < RING && q < groups; ++q) expect_tx(full_a + 8 * q, SLOT_BYTES);
  }
  for (int q = threadIdx.x; q < warps * LRING; q += blockDim.x) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(wfull_a + 8 * q));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(wempty_a + 8 * q));
  }
  {
    // entry [u][b]: the CTA's level u against bin b's value (b < 256),
    // NEG (b = 256) or 0.0 (b = 257)
    const float* lut = tb.lut + (size_t)row * 256;
    const float* lv = tb.levels + ((size_t)row * tb.per_row * K + rank) * tb.up;
    for (int e = threadIdx.x; e < tb.up * SCORE_COLS; e += blockDim.x) {
      const int u = e / SCORE_COLS;
      const int b = e - u * SCORE_COLS;
      const float x = b < 256 ? lut[b] : (b == BIN_NEG ? NEGF : 0.0f);
      T[e] = cell_score(x, lv[u], p);
    }
  }
  cg::this_cluster().sync();  // every CTA's mbarriers and table ready before any byte moves

  // each lane's bins of a group's 8 steps (its score-table columns)
  int bn[LPT][8];
  auto load_bins = [&](int tg) {
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int ai = tg + s - (lane0 + k);
        bn[k][s] = MODE == WINDOW ? bin_at<BIN_ZERO>(brow, toff + ai, NS)
                                  : bin_at<BIN_NEG>(brow, ai, NS);
      }
    }
  };
  load_bins(0);

  // group g: CTA ring slot g % RING, warp ring slot g % LRING
  int ck_next = MODE == CKPT ? r.ckpt_steps : 0;
  size_t ck_row = (size_t)row * MP;
  Hook hook;
  hook.start();
  for (int t0 = 0; t0 < t_end; t0 += 8) {
    const bool dump_group = MODE == CKPT && t0 + 8 == ck_next;
    const int g = t0 >> 3;
    const int slot = g % RING, wslot = g % LRING;
    hook.mark(0);
    // the group's scores from the bins read a group ahead; then the next
    // group's bins, in flight while this group's steps run
    float sc[LPT][8];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
#pragma unroll
      for (int s = 0; s < 8; ++s) sc[k][s] = T[tbase[k] + bn[k][s]];
    }
    load_bins(t0 + 8);
    hook.mark(1);
    const float* rs = remote_in ? smem_all + slot * SLOT_FLOATS
                                : wdata + (w * LRING + wslot) * SLOT_FLOATS;
    float* ws = wdata + ((w + 1) * LRING + wslot) * SLOT_FLOATS;  // a local send's slot
    if (recv) {
      hook.wait_begin();
      wait_parity_cta(remote_in ? full_a + 8 * slot : wfull_a + 8 * (w * LRING + wslot),
                      (g / (remote_in ? RING : LRING)) & 1);
      hook.wait_end(remote_in ? 0 : 2);
    }
    if (send && g >= (remote_out ? RING : LRING)) {
      hook.wait_begin();
      wait_parity_cta(remote_out ? empty_a + 8 * slot : wempty_a + 8 * ((w + 1) * LRING + wslot),
                      (g / (remote_out ? RING : LRING) - 1) & 1);
      hook.wait_end(remote_out ? 1 : 3);
    }
    __syncwarp();
    hook.mark(2);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int t = t0 + s;
      const bool dump = dump_group && s == 7;
      // lane lane0 - 1 at step t - 1
      float sp = __shfl_up_sync(0xffffffffu, L[LPT - 1].S1, 1);
      float cp = __shfl_up_sync(0xffffffffu, L[LPT - 1].C, 1);
      if (wl == 0) {
        sp = recv && s > 0 ? rs[2 * s - 2] : in_s;
        cp = recv && s > 0 ? rs[2 * s - 1] : in_c;
      }
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int i = lane0 + k;
        const float s_next = L[k].S1, c_next = L[k].C;  // lane i at t - 1, for lane i + 1
        dp_cell<MODE>(L[k], sc[k][s], sp, cp, i, t, s, p, m, n, cold, bot, dump && i < MP,
                      ck_row, r);
        sp = s_next;
        cp = c_next;
      }
      if (send) {
        if (remote_out)
          st_async_v2(ring_a + 4 * (slot * SLOT_FLOATS + 2 * s), L[LPT - 1].S1, L[LPT - 1].C,
                      full_a + 8 * slot, rank + 1);
        else
          *reinterpret_cast<float2*>(ws + 2 * s) = make_float2(L[LPT - 1].S1, L[LPT - 1].C);
      }
      if (MODE != CKPT && s == 7) {
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          if (lane0 + k < MP)
            ptr[((size_t)(t0 >> 3) * B + row) * MP + lane0 + k] = (int32_t)L[k].acc;
          L[k].acc = 0;
        }
      }
    }
    hook.mark(3);
    if (send && !remote_out) arrive_local(wfull_a + 8 * ((w + 1) * LRING + wslot));
    if (recv) {
      in_s = rs[2 * 7];
      in_c = rs[2 * 7 + 1];
      if (remote_in) {
        if (g + RING < groups) expect_tx(full_a + 8 * slot, SLOT_BYTES);
        arrive_remote_after_reads(empty_a + 8 * slot, rank - 1);  // the slot is free again
      } else {
        arrive_local(wempty_a + 8 * (w * LRING + wslot));
      }
    }
    if (dump_group) {
      ck_next += r.ckpt_steps;
      ck_row += (size_t)B * MP;
    }
  }
  hook.finish(groups);
  const int first = rank * MPC;
  if (MODE != WINDOW && m >= first && m < first + MPC)  // the CTA of the bottom lane
    for (int t = t_end + threadIdx.x; t < ND; t += blockDim.x) bot[t] = NEGF;
  cg::this_cluster().sync();  // no CTA leaves while a peer may write into it
}

template <int LPT, int MODE, int SCORE>
cudaError_t launch(const float* sig, const float* tmpl, const Table& tb, const int* nact,
                   const int* mrow, int32_t* ptr, float* bottom, int B, int ND, int NS, int MP,
                   int tmpl_stride, Params p, const Resume& r, cudaStream_t stream) {
  int threads = (MP + LPT - 1) / LPT;
  threads = (threads + 31) / 32 * 32;
  const size_t table = SCORE == TABLE ? (size_t)tb.up * SCORE_COLS : 0;
  const size_t shmem = (4 * (size_t)(MP + 1) + table) * sizeof(float);
  if (shmem > SMEM_MAX) return cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(wave_align_kernel<LPT, MODE, SCORE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
    if (e != cudaSuccess) return e;
  }
  wave_align_kernel<LPT, MODE, SCORE><<<B, threads, shmem, stream>>>(
      sig, tmpl, tb, nact, mrow, ptr, bottom, B, ND, NS, MP, MP, tmpl_stride, p, r);
  return cudaGetLastError();
}

// TABLE on a cluster of K CTAs a row, MPC lanes each (MPC / LPT threads)
template <int LPT, int MODE, class Hook>
cudaError_t launch_cluster(const Table& tb, const int* nact, const int* mrow, int32_t* ptr,
                           float* bottom, int B, int ND, int NS, int MP, int MPC, int K,
                           Params p, const Resume& r, cudaStream_t stream) {
  auto kern = wave_cluster_kernel<LPT, MODE, Hook>;
  const size_t shmem =
      (RING_FLOATS + 4 * (size_t)(MPC + 1) + (size_t)tb.up * SCORE_COLS) * sizeof(float);
  if (shmem > SMEM_MAX) return cudaErrorInvalidValue;
  // every CTA asks for a whole SM's shared memory: one CTA an SM, so no
  // two CTAs of a wide call share an SM's issue (the block scheduler
  // packs a cluster's CTAs onto SMs where their memory fits)
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * K);
  cfg.blockDim = dim3(MPC / LPT);
  cfg.dynamicSmemBytes = SMEM_MAX;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the cluster must fit the card: K CTAs of this shared memory on K SMs
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kern, tb, nact, mrow, ptr, bottom, B, ND, NS, MP, MPC, p, r);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// POW: the lanes a thread runs follow MP
template <int MODE>
int dispatch_pow(const void* sig, const void* tmpl, const void* nact, const void* mrow,
                 void* ptr, void* bottom, int B, int ND, int NS, int MP, int tmpl_stride,
                 Params p, const Resume& r, void* stream) {
  auto s = (const float*)sig;
  auto tp = (const float*)tmpl;
  auto na = (const int*)nact;
  auto mr = (const int*)mrow;
  auto pt = (int32_t*)ptr;
  auto bt = (float*)bottom;
  auto st = (cudaStream_t)stream;
  const Table none{};
#define WAVE_POW(LPT) \
  (int)launch<LPT, MODE, POW>(s, tp, none, na, mr, pt, bt, B, ND, NS, MP, tmpl_stride, p, r, st)
  if (MP <= 1024) return WAVE_POW(1);
  if (MP <= 2048) return WAVE_POW(2);
  if (MP <= 4096) return WAVE_POW(4);
  if (MP <= 8192) return WAVE_POW(8);
#undef WAVE_POW
  return (int)cudaErrorInvalidValue;
}

// a cluster split the host's rule can give: K in 2..8 CTAs of MPC lanes
// (a multiple of 128, at most CL_MAX_LANES), none empty
bool split_ok(int MP, int K, int MPC) {
  return K >= 2 && K <= MAX_CTAS && MPC > 0 && MPC % 128 == 0 && MPC <= CL_MAX_LANES &&
         (K - 1) * MPC < MP && K * MPC >= MP;
}

// TABLE: one CTA a row, one lane a thread (K = 1, MP <= 1024), or a
// cluster of K CTAs a row, MPC lanes each, 1, 2 or 4 lanes a thread
template <int MODE, class Hook = WAVE_HOOK>
int dispatch_table(const void* bins, const void* lut, const void* levels, const void* lidx,
                   const void* nact, const void* mrow, void* ptr, void* bottom, int B, int ND,
                   int NS, int MP, int UP, int per_row, int K, int MPC, Params p,
                   const Resume& r, void* stream) {
  const Table tb{(const uint8_t*)bins, (const float*)lut, (const float*)levels,
                 (const int*)lidx, UP, per_row ? 1 : 0};
  auto na = (const int*)nact;
  auto mr = (const int*)mrow;
  auto pt = (int32_t*)ptr;
  auto bt = (float*)bottom;
  auto st = (cudaStream_t)stream;
  if (K == 1) {
    if (MP > 1024 || MPC != MP) return (int)cudaErrorInvalidValue;
    return (int)launch<1, MODE, TABLE>(nullptr, nullptr, tb, na, mr, pt, bt, B, ND, NS, MP, 0, p,
                                       r, st);
  }
  if (!split_ok(MP, K, MPC)) return (int)cudaErrorInvalidValue;
#define WAVE_CLUSTER(LPT) \
  (int)launch_cluster<LPT, MODE, Hook>(tb, na, mr, pt, bt, B, ND, NS, MP, MPC, K, p, r, st)
  if (MPC <= 1024) return WAVE_CLUSTER(1);
  if (MPC <= 1536) return WAVE_CLUSTER(2);
  return WAVE_CLUSTER(4);
#undef WAVE_CLUSTER
}

// the most clusters of K CTAs of MPC lanes the card runs at once, as
// launch_cluster launches them (one CTA an SM); 0 when none fits
template <int LPT>
int cluster_capacity(int K, int MPC) {
  auto kern = wave_cluster_kernel<LPT, PTR, NoHook>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX))
    return 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K);
  cfg.blockDim = dim3(MPC / LPT);
  cfg.dynamicSmemBytes = SMEM_MAX;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  return cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg) == cudaSuccess ? clusters : 0;
}

Resume ckpt_resume(void* ck_s1, void* ck_s2, void* ck_ih, void* ck_c, int ckpt_steps) {
  Resume r{};
  r.ck[0] = (float*)ck_s1;
  r.ck[1] = (float*)ck_s2;
  r.ck[2] = (float*)ck_ih;
  r.ck[3] = (float*)ck_c;
  r.ckpt_steps = ckpt_steps;
  return r;
}

Resume window_resume(const void* r_init, const void* t0, const void* s1, const void* s2,
                     const void* ih, const void* c, const void* cold) {
  Resume r{};
  r.rinit = (const float*)r_init;
  r.t0 = (const int*)t0;
  r.st[0] = (const float*)s1;
  r.st[1] = (const float*)s2;
  r.st[2] = (const float*)ih;
  r.st[3] = (const float*)c;
  r.cold = (const int*)cold;
  return r;
}

// a checkpoint stride the group-end test can see: a multiple of 8
// dividing ND
bool ckpt_ok(int ND, int ckpt_steps) {
  return ckpt_steps > 0 && ckpt_steps % 8 == 0 && ND % ckpt_steps == 0;
}

}  // namespace

// clusters of K CTAs of MPC lanes (a split dispatch_table takes) the
// card runs at once; the host's launch plan keeps a call's rows within it
extern "C" int wave_cluster_capacity(int K, int MPC) {
  if (!(K >= 2 && K <= MAX_CTAS && MPC > 0 && MPC % 128 == 0 && MPC <= CL_MAX_LANES)) return 0;
  if (MPC <= 1024) return cluster_capacity<1>(K, MPC);
  if (MPC <= 1536) return cluster_capacity<2>(K, MPC);
  return cluster_capacity<4>(K, MPC);
}

extern "C" int wave_align_launch(const void* sig, const void* tmpl, const void* nact,
                                 const void* mrow, void* ptr, void* bottom,
                                 int B, int N, int MP, int tmpl_stride, int neg_h,
                                 float go_h, float go_v, float ge_h, float ge_v,
                                 float off, float dmin, float g, void* stream) {
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  return dispatch_pow<PTR>(sig, tmpl, nact, mrow, ptr, bottom, B, N + MP, N, MP, tmpl_stride,
                           p, Resume{}, stream);
}

extern "C" int wave_table_launch(const void* bins, const void* lut, const void* levels,
                                 const void* lidx, const void* nact, const void* mrow,
                                 void* ptr, void* bottom, int B, int N, int MP, int UP,
                                 int per_row, int ctas, int mpc, int neg_h, float go_h,
                                 float go_v, float ge_h, float ge_v, float off, float dmin,
                                 float g, void* stream) {
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  return dispatch_table<PTR>(bins, lut, levels, lidx, nact, mrow, ptr, bottom, B, N + MP, N,
                             MP, UP, per_row, ctas, mpc, p, Resume{}, stream);
}

extern "C" int wave_ckpt_launch(const void* sig, const void* tmpl, const void* nact,
                                const void* mrow, void* bottom, void* ck_s1, void* ck_s2,
                                void* ck_ih, void* ck_c, int B, int N, int MP, int tmpl_stride,
                                int ckpt_steps, int neg_h, float go_h, float go_v, float ge_h,
                                float ge_v, float off, float dmin, float g, void* stream) {
  if (!ckpt_ok(N + MP, ckpt_steps)) return (int)cudaErrorInvalidValue;
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  return dispatch_pow<CKPT>(sig, tmpl, nact, mrow, nullptr, bottom, B, N + MP, N, MP,
                            tmpl_stride, p, ckpt_resume(ck_s1, ck_s2, ck_ih, ck_c, ckpt_steps),
                            stream);
}

// bins (B, NB) read in place over ND >= NB + MP steps: 0.0 past the row
extern "C" int wave_ckpt_table_launch(const void* bins, const void* lut, const void* levels,
                                      const void* lidx, const void* nact, const void* mrow,
                                      void* bottom, void* ck_s1, void* ck_s2, void* ck_ih,
                                      void* ck_c, int B, int NB, int ND, int MP, int UP,
                                      int per_row, int ctas, int mpc, int ckpt_steps,
                                      int neg_h, float go_h,
                                      float go_v, float ge_h, float ge_v, float off, float dmin,
                                      float g, void* stream) {
  if (!ckpt_ok(ND, ckpt_steps) || ND < NB + MP) return (int)cudaErrorInvalidValue;
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  return dispatch_table<CKPT>(bins, lut, levels, lidx, nact, mrow, nullptr, bottom, B, ND, NB,
                              MP, UP, per_row, ctas, mpc, p,
                              ckpt_resume(ck_s1, ck_s2, ck_ih, ck_c, ckpt_steps), stream);
}

extern "C" int wave_window_launch(const void* sig_win, const void* r_init, const void* tmpl,
                                  const void* steps, const void* s1, const void* s2,
                                  const void* ih, const void* c, const void* cold, void* ptr,
                                  int B, int W, int MP, int tmpl_stride, int neg_h,
                                  float go_h, float go_v, float ge_h, float ge_v,
                                  float off, float dmin, float g, void* stream) {
  if (W % 8) return (int)cudaErrorInvalidValue;
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  return dispatch_pow<WINDOW>(sig_win, tmpl, steps, nullptr, ptr, nullptr, B, W, W, MP,
                              tmpl_stride, p,
                              window_resume(r_init, nullptr, s1, s2, ih, c, cold), stream);
}

// the window of row r reads its bins row (B, NB) from sample t0[r] on
extern "C" int wave_window_table_launch(const void* bins, const void* lut, const void* levels,
                                        const void* lidx, const void* t0, const void* steps,
                                        const void* s1, const void* s2, const void* ih,
                                        const void* c, const void* cold, void* ptr, int B,
                                        int NB, int W, int MP, int UP, int per_row, int ctas,
                                        int mpc, int neg_h, float go_h, float go_v, float ge_h,
                                        float ge_v,
                                        float off, float dmin, float g, void* stream) {
  if (W % 8) return (int)cudaErrorInvalidValue;
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  return dispatch_table<WINDOW>(bins, lut, levels, lidx, steps, nullptr, ptr, nullptr, B, W, NB,
                                MP, UP, per_row, ctas, mpc, p,
                                window_resume(nullptr, t0, s1, s2, ih, c, cold), stream);
}
