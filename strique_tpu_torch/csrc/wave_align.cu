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
// What bounds it on an H100: the serial chain of diagonal steps.  Step t
// of row r needs step t-1 of the neighbouring template lane (S, C) and
// step t-2 (S), so a row is ND = N + MP dependent steps (~25.5k at the
// bench shape, ~1.31M for an ultra-long read in pass 1) with a
// block-wide barrier between them.  The pointer plane (ND/8 x 64 x 896
// int32, ~0.73 GB per 64-row bench call) is written once, coalesced, and
// is not the limit; pass 1 writes none and its checkpoints are
// ND/ckpt_steps x 4 planes (~9 MB per 8 ultra-long rows).  Per step each
// lane also evaluates |d|^1.2 in double precision (below), which makes
// FP64 throughput the per-SM cost of a step.
//
// Design: one CTA per row (64 rows per call fill 64 of the 132 SMs; the
// two-pass route runs groups of 8 rows), one thread per template lane
// (LPT lanes per thread when MP > 1024).  A lane's running state (S at
// t-1, Ih, the column cummax C, and S of lane i-1 at t-2) lives in
// registers; the only cross-lane exchange is S and C of lane i-1 through
// a shared-memory double buffer, one __syncthreads per step.  Lane i
// reads its signal sample a[t-i] directly (NEG before the read, 0 past
// the padded end: the reference's reversed sliding window, indexed); in
// a window it reads sig_win[t-i], or r_init[i-t-1] before the window,
// both of which carry the reference window gather's 0.0 fill.  Eight
// steps of 4-bit codes pack into a register and store as one int32 word
// [t/8, row, i].  A row stops at its own last useful step,
// round_up(n + m, 8) (in a window: round_up(steps_needed, 8)), and fills
// the rest of its bottom taps with NEG.  The checkpoint's S2 is the
// lane's OWN S at t-1 (the registers keep only lane i-1's, for the
// diagonal move), so the dump takes the lane's S1 before the step's
// update; a resumed window seeds the i-1 register from S2 of lane i-1.
//
// Value contract (bit-identical to the reference's f32 stream, up to the
// measured 1-ulp pow difference): every expression tree of the Pallas
// body is kept, and the build uses -fmad=false so no a + b*c contracts
// into an FMA.  |d|^1.2 is (float)pow((double)d, (double)1.2f); the +1e30
// template pad still yields sc = dmin.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEGF = -1e30f;
constexpr double POW_EXP = 1.2000000476837158;  // (double)1.2f

enum Mode { PTR = 0, CKPT = 1, WINDOW = 2 };

struct Params {
  float go_h, go_v, ge_h, ge_v, off, dmin, g;
  int neg_h;
};

// what the CKPT and WINDOW modes read or write beyond the PTR mode's
struct Resume {
  const float* rinit;    // WINDOW: (B, MP), lane i holds a[t0-1-i]
  const float* st[4];    // WINDOW: S1, S2, Ih, C after step t0-1, (B, MP) each
  const int* cold;       // WINDOW: (B,), 1 = the window starts at the origin
  float* ck[4];          // CKPT: S1, S2, Ih, C planes, (ND/ckpt_steps, B, MP)
  int ckpt_steps;        // CKPT
};

// PTR, CKPT: sig (B, N), ND = N + MP steps, nact = n, mrow = m per row.
// WINDOW: sig = sig_win (B, N) with N = W = ND steps, nact = the steps a
// row needs, mrow unused.
template <int LPT, int MODE>
__global__ void __launch_bounds__(1024)
wave_align_kernel(const float* __restrict__ sig, const float* __restrict__ tmpl,
                  const int* __restrict__ nact, const int* __restrict__ mrow,
                  int32_t* __restrict__ ptr, float* __restrict__ bottom,
                  int B, int N, int MP, int tmpl_stride, Params p, Resume r) {
  // two buffers each of S and C, MP + 1 floats: index 0 holds lane -1's
  // fill, lane i lives at index i + 1
  extern __shared__ float smem[];
  const int W = MP + 1;

  const int row = blockIdx.x;
  const int ND = MODE == WINDOW ? N : N + MP;
  const int n = nact[row];
  const int m = MODE == WINDOW ? 0 : mrow[row];
  int t_end = (n + m + 7) & ~7;
  if (t_end > ND) t_end = ND;
  const float* a = sig + (size_t)row * N;
  const float* tm_row = tmpl + (size_t)row * tmpl_stride;
  float* bot = MODE == WINDOW ? nullptr : bottom + (size_t)row * ND;
  const float fill_s = p.neg_h ? -p.dmin : NEGF;
  const bool cold = MODE != WINDOW || r.cold[row] != 0;

  float S1[LPT], Ih[LPT], C[LPT], hS[LPT], tm[LPT];
  uint32_t acc[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (MODE == WINDOW && i < MP) {
      // resume: the state after step t0-1; hS is S of lane i-1 at t0-2
      const size_t o = (size_t)row * MP + i;
      S1[k] = r.st[0][o];
      Ih[k] = r.st[2][o];
      C[k] = r.st[3][o];
      hS[k] = (i == 0) ? fill_s : r.st[1][o - 1];
    } else {
      // step -1 state: only cell (0, 0) (S = 0) is ever read before the
      // wavefront pins a lane's column-0 boundary
      S1[k] = (i == 0) ? 0.0f : NEGF;
      Ih[k] = NEGF;
      C[k] = NEGF;
      hS[k] = (i == 0) ? fill_s : NEGF;  // S of lane i-1 at step -2
    }
    tm[k] = (i < MP) ? tm_row[i] : 1e30f;
    acc[k] = 0;
    if (i < MP) {
      smem[W + i + 1] = S1[k];      // S buffer 1 (step -1)
      smem[3 * W + i + 1] = C[k];   // C buffer 1
    }
  }
  if (threadIdx.x == 0) {
    smem[0] = fill_s;
    smem[W] = fill_s;
    smem[2 * W] = NEGF;
    smem[3 * W] = NEGF;
  }
  __syncthreads();

  for (int t = 0; t < t_end; ++t) {
    const int cur = t & 1;
    float* s_cur = smem + cur * W;
    float* c_cur = smem + (2 + cur) * W;
    const float* s_prv = smem + (cur ^ 1) * W;
    const float* c_prv = smem + (2 + (cur ^ 1)) * W;
    // CKPT: after step (g+1)*ckpt_steps - 1 the state goes to slot g
    const bool dump = MODE == CKPT && (t + 1) % r.ckpt_steps == 0;
    const size_t ck_row = dump ? ((size_t)((t + 1) / r.ckpt_steps - 1) * B + row) * MP : 0;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i >= MP) continue;
      const float fi = (float)i;
      const float s_prev = s_prv[i];  // S(i-1) at t-1
      const float c_sh = c_prv[i];    // C(i-1) at t-1
      const float s2 = hS[k];             // S(i-1) at t-2
      hS[k] = s_prev;
      const int ai = t - i;
      float av;
      if (MODE == WINDOW)
        av = ai >= 0 ? a[ai] : r.rinit[(size_t)row * MP + (i - t - 1)];
      else
        av = ai < 0 ? NEGF : (ai < N ? a[ai] : 0.0f);
      const float diff = fabsf(av - tm[k]);
      const float pw = (float)pow((double)diff, POW_EXP);
      const float sc = fmaxf(p.off - pw, p.dmin);
      const float ih_ext = Ih[k] + p.ge_h;
      const float ih_open = S1[k] + p.go_h;
      float new_ih = fmaxf(ih_ext, ih_open);
      const float new_m = s2 + sc;
      float q = fmaxf(new_m, new_ih);
      if (!p.neg_h && i == 0) q = 0.0f;
      const float cvec = (q + p.go_v) - ((fi + 1.0f) * p.g);
      const float new_c = fmaxf(c_sh, cvec);
      const float new_iv = c_sh + fi * p.g;
      float new_s = fmaxf(q, new_iv);
      if (MODE != CKPT) {
        const int which = new_m >= new_s ? 0 : (new_iv >= new_s ? 2 : 1);
        const uint32_t code = which | ((ih_ext >= ih_open) ? 4 : 0)
                            | (((new_iv + p.ge_v) >= (new_s + p.go_v)) ? 8 : 0);
        acc[k] |= code << (4 * (t & 7));
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
        r.ck[1][ck_row + i] = S1[k];  // the lane's own S at t-1
        r.ck[2][ck_row + i] = new_ih;
        r.ck[3][ck_row + i] = new_c;
      }
      S1[k] = new_s;
      Ih[k] = new_ih;
      C[k] = new_c;
      s_cur[i + 1] = new_s;
      c_cur[i + 1] = new_c;
      if (MODE != CKPT && (t & 7) == 7) {
        ptr[((size_t)(t >> 3) * B + row) * MP + i] = (int32_t)acc[k];
        acc[k] = 0;
      }
    }
    __syncthreads();
  }
  if (MODE != WINDOW)
    for (int t = t_end + threadIdx.x; t < ND; t += blockDim.x) bot[t] = NEGF;
}

template <int LPT, int MODE>
cudaError_t launch(const float* sig, const float* tmpl, const int* nact, const int* mrow,
                   int32_t* ptr, float* bottom, int B, int N, int MP, int tmpl_stride,
                   Params p, const Resume& r, cudaStream_t stream) {
  int threads = (MP + LPT - 1) / LPT;
  threads = (threads + 31) / 32 * 32;
  const size_t shmem = 4 * (size_t)(MP + 1) * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(wave_align_kernel<LPT, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
    if (e != cudaSuccess) return e;
  }
  wave_align_kernel<LPT, MODE><<<B, threads, shmem, stream>>>(
      sig, tmpl, nact, mrow, ptr, bottom, B, N, MP, tmpl_stride, p, r);
  return cudaGetLastError();
}

template <int MODE>
int dispatch(const void* sig, const void* tmpl, const void* nact, const void* mrow, void* ptr,
             void* bottom, int B, int N, int MP, int tmpl_stride, Params p, const Resume& r,
             void* stream) {
  auto s = (const float*)sig;
  auto tp = (const float*)tmpl;
  auto na = (const int*)nact;
  auto mr = (const int*)mrow;
  auto pt = (int32_t*)ptr;
  auto bt = (float*)bottom;
  auto st = (cudaStream_t)stream;
  if (MP <= 1024) return (int)launch<1, MODE>(s, tp, na, mr, pt, bt, B, N, MP, tmpl_stride, p, r, st);
  if (MP <= 2048) return (int)launch<2, MODE>(s, tp, na, mr, pt, bt, B, N, MP, tmpl_stride, p, r, st);
  if (MP <= 4096) return (int)launch<4, MODE>(s, tp, na, mr, pt, bt, B, N, MP, tmpl_stride, p, r, st);
  if (MP <= 8192) return (int)launch<8, MODE>(s, tp, na, mr, pt, bt, B, N, MP, tmpl_stride, p, r, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int wave_align_launch(const void* sig, const void* tmpl, const void* nact,
                                 const void* mrow, void* ptr, void* bottom,
                                 int B, int N, int MP, int tmpl_stride, int neg_h,
                                 float go_h, float go_v, float ge_h, float ge_v,
                                 float off, float dmin, float g, void* stream) {
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  Resume r{};
  return dispatch<PTR>(sig, tmpl, nact, mrow, ptr, bottom, B, N, MP, tmpl_stride, p, r, stream);
}

extern "C" int wave_ckpt_launch(const void* sig, const void* tmpl, const void* nact,
                                const void* mrow, void* bottom, void* ck_s1, void* ck_s2,
                                void* ck_ih, void* ck_c, int B, int N, int MP, int ckpt_steps,
                                int neg_h, float go_h, float go_v, float ge_h, float ge_v,
                                float off, float dmin, float g, void* stream) {
  if (ckpt_steps <= 0 || (N + MP) % ckpt_steps) return (int)cudaErrorInvalidValue;
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  Resume r{};
  r.ck[0] = (float*)ck_s1;
  r.ck[1] = (float*)ck_s2;
  r.ck[2] = (float*)ck_ih;
  r.ck[3] = (float*)ck_c;
  r.ckpt_steps = ckpt_steps;
  return dispatch<CKPT>(sig, tmpl, nact, mrow, nullptr, bottom, B, N, MP, 0, p, r, stream);
}

extern "C" int wave_window_launch(const void* sig_win, const void* r_init, const void* tmpl,
                                  const void* steps, const void* s1, const void* s2,
                                  const void* ih, const void* c, const void* cold, void* ptr,
                                  int B, int W, int MP, int neg_h,
                                  float go_h, float go_v, float ge_h, float ge_v,
                                  float off, float dmin, float g, void* stream) {
  if (W % 8) return (int)cudaErrorInvalidValue;
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  Resume r{};
  r.rinit = (const float*)r_init;
  r.st[0] = (const float*)s1;
  r.st[1] = (const float*)s2;
  r.st[2] = (const float*)ih;
  r.st[3] = (const float*)c;
  r.cold = (const int*)cold;
  return dispatch<WINDOW>(sig_win, tmpl, steps, nullptr, ptr, nullptr, B, W, MP, 0, p, r,
                          stream);
}
