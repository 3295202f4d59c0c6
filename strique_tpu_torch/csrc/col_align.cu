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
// Value contract: the reference's expression trees, built with
// -fmad=false (no a + b*c contracts); |d|^1.2 is
// (float)pow((double)d, (double)1.2f), and the +1e30 template pad and
// lane 0 give sc = dmin through pow -> inf.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEGF = -1e30f;
constexpr double POW_EXP = 1.2000000476837158;  // (double)1.2f
constexpr int MAX_THREADS = 1024;
constexpr int SCORE_COLS = 258;      // 256 bins, NEG, 0.0 (the last two unread here)
constexpr int EXCH = 5 * 2 * 32;     // exchange floats: 5 slots x 2 parities x 32 warps
constexpr size_t SMEM_MAX = 232448;  // 227 KB: a block's dynamic shared memory
constexpr unsigned FULL = 0xffffffffu;

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
  const int* lidx;       // (1, MP) lane -> index into the levels
  int up;                // UP
};

// an int key whose order is the float order (and back): redux.sync
// takes integers
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
  return fmaxf(p.off - pw, p.dmin);
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

// TABLE mode runs MP <= 1024 lanes, so at most 1024 / LPT threads
template <int LPT, int SCORE>
__global__ void __launch_bounds__(SCORE == TABLE ? MAX_THREADS / LPT : MAX_THREADS)
col_align_kernel(const float* __restrict__ sig, const float* __restrict__ tmpl, Table tb,
                 const int* __restrict__ nact, int32_t* __restrict__ ptr,
                 float* __restrict__ bottom, int B, int N, int MP, int m, Params p) {
  // exchange slots [parity * 32 + warp]; TABLE: the U x 258 scores follow
  extern __shared__ float smem[];
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
    float* Tw = smem + EXCH;
    for (int e = x; e < tb.up * SCORE_COLS; e += blockDim.x) {
      const int u = e / SCORE_COLS;
      const int b = e - u * SCORE_COLS;
      const float xv = b < 256 ? lut[b] : (b == 256 ? NEGF : 0.0f);
      Tw[e] = cell_score(xv, tb.levels[u], p);
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
      float newM[LPT], Q[LPT], pre[LPT];
      int ihx[LPT];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const float fi = (float)(i0 + k);
        const float ih_ext = Ih[k] + p.ge_h;
        const float ih_open = S[k] + p.go_h;
        ihx[k] = ih_ext >= ih_open ? 4 : 0;
        Ih[k] = fmaxf(ih_ext, ih_open);
        const float left = k > 0 ? S[k - 1] : (lane > 0 ? s_up : fill_s);
        newM[k] = left + sc[k];
        float q = fmaxf(newM[k], Ih[k]);
        if (!p.neg_h && i0 + k == 0) q = 0.0f;
        if (k == 0 && edge) q = Ih[0];  // its M' waits for the warp below
        Q[k] = q;
        const float cv = (q + p.go_v) - ((fi + 1.0f) * p.g);
        pre[k] = k == 0 ? cv : fmaxf(pre[k - 1], cv);
      }
      float tot = active ? pre[LPT - 1] : NEGF;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float y = __shfl_up_sync(FULL, tot, d);
        if (lane >= d) tot = fmaxf(tot, y);
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
      // through warp-1: the warps below, each its total and first M' term
      const float wt = lane < warp ? fmaxf(x_tot[par + lane], x_ca[par + lane]) : -INFINITY;
      const float carry = key_value(__reduce_max_sync(FULL, order_key(wt)));
      const float base = fmaxf(carry, x_ca[par + warp]);  // ... and this warp's first M'
      const float inc = lane > 0 ? fmaxf(base, up) : base;  // through lane i0-1 (k > 0: i0)
      if (edge) {
        newM[0] = x_s[par + warp] + sc[0];
        Q[0] = fmaxf(newM[0], Q[0]);
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
        const float cm_k = k == 0 ? (lane > 0 ? inc : carry) : fmaxf(inc, pre[k - 1]);
        const float iv = (i0 + k == 0 ? NEGF : cm_k) + fi * p.g;
        const float s_new = fmaxf(Q[k], iv);
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

template <int LPT, int SCORE>
cudaError_t launch(const float* sig, const float* tmpl, const Table& tb, const int* nact,
                   int32_t* ptr, float* bottom, int B, int N, int MP, int m, Params p,
                   cudaStream_t stream) {
  const int threads = ((MP / LPT) + 31) / 32 * 32;
  const size_t table = SCORE == TABLE ? (size_t)tb.up * SCORE_COLS : 0;
  const size_t shmem = (EXCH + table) * sizeof(float);
  if (shmem > SMEM_MAX) return cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(col_align_kernel<LPT, SCORE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
    if (e != cudaSuccess) return e;
  }
  col_align_kernel<LPT, SCORE><<<B, threads, shmem, stream>>>(sig, tmpl, tb, nact, ptr, bottom,
                                                              B, N, MP, m, p);
  return cudaGetLastError();
}

bool shape_ok(int N, int MP, int m) { return MP % 128 == 0 && N % 8 == 0 && m > 0 && m < MP; }

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

// TABLE: 4 lanes a thread (MP <= 1024); bins (B, N) read in place
extern "C" int col_table_launch(const void* bins, const void* lut, const void* levels,
                                const void* lidx, const void* nact, void* ptr, void* bottom,
                                int B, int N, int MP, int UP, int m, int neg_h, float go_h,
                                float go_v, float ge_h, float ge_v, float off, float dmin,
                                float g, void* stream) {
  if (!shape_ok(N, MP, m) || MP > 1024) return (int)cudaErrorInvalidValue;
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  const Table tb{(const uint8_t*)bins, (const float*)lut, (const float*)levels,
                 (const int*)lidx, UP};
  return (int)launch<4, TABLE>(nullptr, nullptr, tb, (const int*)nact, (int32_t*)ptr,
                               (float*)bottom, B, N, MP, m, p, (cudaStream_t)stream);
}
