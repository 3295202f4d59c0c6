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
// Value contract (bit-identical to the reference's f32 stream, up to the
// measured 1-ulp pow difference): every expression tree of the Pallas
// body is kept, and the build uses -fmad=false so no a + b*c contracts
// into an FMA.  |d|^1.2 is (float)pow((double)d, (double)1.2f); the +1e30
// template pad still yields sc = dmin.  TABLE and POW share one score
// function, so a table entry is the value POW computes for its pair.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEGF = -1e30f;
constexpr double POW_EXP = 1.2000000476837158;  // (double)1.2f
constexpr int SCORE_COLS = 258;                 // 256 bins, NEG, 0.0
constexpr int BIN_NEG = 256;                    // before the read
constexpr int BIN_ZERO = 257;                   // 0.0: past the read (and around a window)
constexpr size_t SMEM_MAX = 232448;             // 227 KB: a block's dynamic shared memory

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
  const float* levels;   // (R, UP) distinct template values
  const int* lidx;       // (R, MP) lane -> index into its row's levels
  int up;                // UP
  int per_row;           // R == B (1) or R == 1 (0)
};

// a lane's running state
struct Lane {
  float S1, Ih, C, hS;   // S at t-1, Ih, column cummax, S of lane i-1 at t-2
  uint32_t acc;          // pointer codes of the current 8-step word
};

__device__ __forceinline__ float cell_score(float av, float tm, const Params& p) {
  const float diff = fabsf(av - tm);
  const float pw = (float)pow((double)diff, POW_EXP);
  return fmaxf(p.off - pw, p.dmin);
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
  float new_ih = fmaxf(ih_ext, ih_open);
  const float new_m = s2 + sc;
  float q_s = fmaxf(new_m, new_ih);
  if (!p.neg_h && i == 0) q_s = 0.0f;
  const float cvec = (q_s + p.go_v) - ((fi + 1.0f) * p.g);
  const float new_c = fmaxf(c_sh, cvec);
  const float new_iv = c_sh + fi * p.g;
  float new_s = fmaxf(q_s, new_iv);
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
// and tmpl.
template <int LPT, int MODE, int SCORE>
__global__ void __launch_bounds__(1024)
wave_align_kernel(const float* __restrict__ sig, const float* __restrict__ tmpl, Table tb,
                  const int* __restrict__ nact, const int* __restrict__ mrow,
                  int32_t* __restrict__ ptr, float* __restrict__ bottom,
                  int B, int ND, int NS, int MP, int tmpl_stride, Params p, Resume r) {
  // two buffers each of S and C, MP + 1 floats: index 0 holds lane -1's
  // fill, lane i lives at index i + 1; in TABLE mode the row's U x 258
  // scores follow
  extern __shared__ float smem[];
  const int W = MP + 1;
  float* T = smem + 4 * W;

  const int row = blockIdx.x;
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
    const int i = threadIdx.x + k * blockDim.x;
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
      smem[W + i + 1] = L[k].S1;      // S buffer 1 (step -1)
      smem[3 * W + i + 1] = L[k].C;   // C buffer 1
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
    const float* lv = tb.levels + (size_t)row * tb.per_row * tb.up;
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
  // group
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
        const int i = threadIdx.x + k * blockDim.x;
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
        dp_cell<MODE>(L[k], sc, s_prv[i], c_prv[i], i, t, s, p, m, n, cold, bot, dump, ck_row,
                      r);
        s_cur[i + 1] = L[k].S1;
        c_cur[i + 1] = L[k].C;
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
  if (MODE != WINDOW)
    for (int t = t_end + threadIdx.x; t < ND; t += blockDim.x) bot[t] = NEGF;
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
      sig, tmpl, tb, nact, mrow, ptr, bottom, B, ND, NS, MP, tmpl_stride, p, r);
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

// TABLE: one lane a thread (MP <= 1024)
template <int MODE>
int dispatch_table(const void* bins, const void* lut, const void* levels, const void* lidx,
                   const void* nact, const void* mrow, void* ptr, void* bottom, int B, int ND,
                   int NS, int MP, int UP, int per_row, Params p, const Resume& r,
                   void* stream) {
  if (MP > 1024) return (int)cudaErrorInvalidValue;
  const Table tb{(const uint8_t*)bins, (const float*)lut, (const float*)levels,
                 (const int*)lidx, UP, per_row ? 1 : 0};
  return (int)launch<1, MODE, TABLE>(nullptr, nullptr, tb, (const int*)nact, (const int*)mrow,
                                     (int32_t*)ptr, (float*)bottom, B, ND, NS, MP, 0, p, r,
                                     (cudaStream_t)stream);
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
                                 int per_row, int neg_h, float go_h, float go_v, float ge_h,
                                 float ge_v, float off, float dmin, float g, void* stream) {
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  return dispatch_table<PTR>(bins, lut, levels, lidx, nact, mrow, ptr, bottom, B, N + MP, N,
                             MP, UP, per_row, p, Resume{}, stream);
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
                                      int per_row, int ckpt_steps, int neg_h, float go_h,
                                      float go_v, float ge_h, float ge_v, float off, float dmin,
                                      float g, void* stream) {
  if (!ckpt_ok(ND, ckpt_steps) || ND < NB + MP) return (int)cudaErrorInvalidValue;
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  return dispatch_table<CKPT>(bins, lut, levels, lidx, nact, mrow, nullptr, bottom, B, ND, NB,
                              MP, UP, per_row, p,
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
                                        int NB, int W, int MP, int UP, int per_row, int neg_h,
                                        float go_h, float go_v, float ge_h, float ge_v,
                                        float off, float dmin, float g, void* stream) {
  if (W % 8) return (int)cudaErrorInvalidValue;
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  return dispatch_table<WINDOW>(bins, lut, levels, lidx, steps, nullptr, ptr, nullptr, B, W, NB,
                                MP, UP, per_row, p,
                                window_resume(nullptr, t0, s1, s2, ih, c, cold), stream);
}
