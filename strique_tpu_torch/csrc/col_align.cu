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
// What bounds it on an H100: the serial chain of N column steps per row,
// each holding two block-wide barriers (one for the prefix max's
// cross-warp carry, one for the exchange of S and the extend bit with row
// i-1).  Per step each lane also evaluates |d|^1.2 in double precision,
// so FP64 throughput is the per-SM cost of a step.  The pointer plane
// (N/8 x B x MP int32, ~0.70 GB per 64-row bench call) is written once,
// coalesced, and is not the limit.
//
// Design: one CTA per row, template lanes on threads (LPT contiguous
// lanes a thread when MP > 1024).  A lane's S and Ih live in registers.
// The prefix max is a serial max over the thread's own lanes, a warp
// shfl_up scan of the thread totals, and a warp scan of the warp totals
// read back from shared memory; max is exact, so this association gives
// the reference's values (its two-level scan is a Mosaic layout choice).
// S and the extend bit of lane i-1 cross threads through shared memory.
// Lane i accumulates row i's codes for 8 columns in a register and
// stores them as one int32 word at [c/8, row, i-1] (row 0's at lane
// MP-1: the wrapped lane of the reference, never read).  A row stops at
// its own round_up(n, 8) (the reference skips 128-column chunks past the
// batch's longest read) and fills its remaining bottom taps with NEG.
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

struct Params {
  float go_h, go_v, ge_h, ge_v, off, dmin, g;
  int neg_h;
};

template <int LPT>
__global__ void __launch_bounds__(MAX_THREADS)
col_align_kernel(const float* __restrict__ sig, const float* __restrict__ tmpl,
                 const int* __restrict__ nact, int32_t* __restrict__ ptr,
                 float* __restrict__ bottom, int B, int N, int MP, int m, Params p) {
  // s_sh[x + 1]: S of thread x's last lane (index 0: the row -1 fill);
  // e_sh[x + 1]: that lane's extend test (index 0: 0)
  __shared__ float s_sh[MAX_THREADS + 1];
  __shared__ int e_sh[MAX_THREADS + 1];
  __shared__ float warp_tot[32];

  const int row = blockIdx.x;
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int i0 = x * LPT;  // first lane of this thread
  const bool active = i0 < MP;
  int n = nact[row];
  if (n > N) n = N;
  int c_end = (n + 7) & ~7;
  if (c_end > N) c_end = N;
  const float* a = sig + (size_t)row * N;
  float* bot = bottom + (size_t)row * N;
  const float fill_s = p.neg_h ? -p.dmin : NEGF;

  float S[LPT], Ih[LPT], tm[LPT];
  uint32_t acc[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int i = i0 + k;
    const float fi = (float)i;
    S[k] = (i == 0) ? 0.0f : p.go_v + p.ge_v * (fi - 1.0f);
    Ih[k] = NEGF;
    tm[k] = (i < MP) ? tmpl[i] : 1e30f;
    acc[k] = 0;
  }
  s_sh[x + 1] = S[LPT - 1];
  if (x == 0) {
    s_sh[0] = fill_s;
    e_sh[0] = 0;
  }
  __syncthreads();

  for (int c = 0; c < c_end; ++c) {
    const float av = a[c];
    float newM[LPT], Q[LPT], pre[LPT];
    int ihx[LPT];
    float left = s_sh[x];  // S of lane i0-1 at the previous column
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const float fi = (float)(i0 + k);
      const float diff = fabsf(av - tm[k]);
      const float pw = (float)pow((double)diff, POW_EXP);
      const float sc = fmaxf(p.off - pw, p.dmin);
      const float ih_ext = Ih[k] + p.ge_h;
      const float ih_open = S[k] + p.go_h;
      ihx[k] = ih_ext >= ih_open ? 4 : 0;
      Ih[k] = fmaxf(ih_ext, ih_open);
      newM[k] = left + sc;
      left = S[k];
      float q = fmaxf(newM[k], Ih[k]);
      if (!p.neg_h && i0 + k == 0) q = 0.0f;
      Q[k] = q;
      const float cv = (q + p.go_v) - ((fi + 1.0f) * p.g);
      pre[k] = k == 0 ? cv : fmaxf(pre[k - 1], cv);
    }
    // inclusive prefix max of the thread totals over the block
    float tot = active ? pre[LPT - 1] : NEGF;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, tot, d);
      if (lane >= d) tot = fmaxf(tot, y);
    }
    if (lane == 31) warp_tot[warp] = tot;
    __syncthreads();
    float wt = lane < n_warps ? warp_tot[lane] : NEGF;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, wt, d);
      if (lane >= d) wt = fmaxf(wt, y);
    }
    const float carry = __shfl_sync(0xffffffffu, wt, (warp + 31) & 31);  // through warp-1
    const float up = __shfl_up_sync(0xffffffffu, tot, 1);                // through thread x-1
    float cm_left;  // prefix max through lane i0-1
    if (lane > 0)
      cm_left = warp > 0 ? fmaxf(carry, up) : up;
    else
      cm_left = warp > 0 ? carry : NEGF;
    float newS[LPT];
    int ext[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const float fi = (float)(i0 + k);
      const float cm_k = (k == 0) ? cm_left : fmaxf(cm_left, pre[k - 1]);
      const float iv = (i0 + k == 0 ? NEGF : cm_k) + fi * p.g;
      const float s_new = fmaxf(Q[k], iv);
      const int which = newM[k] >= s_new ? 0 : (iv >= s_new ? 2 : 1);
      ext[k] = (iv + p.ge_v) >= (s_new + p.go_v) ? 1 : 0;
      acc[k] |= (uint32_t)(which | ihx[k]) << (4 * (c & 7));
      newS[k] = s_new;
      S[k] = s_new;
      if (i0 + k == m) bot[c] = (c + 1 <= n) ? s_new : NEGF;
    }
    s_sh[x + 1] = newS[LPT - 1];
    e_sh[x + 1] = ext[LPT - 1];
    __syncthreads();
    // bit 3 of row i tests lane i-1 (row 0: 0)
    int e_left = e_sh[x];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      acc[k] |= (uint32_t)(e_left << 3) << (4 * (c & 7));
      e_left = ext[k];
    }
    if ((c & 7) == 7) {
      int32_t* out = ptr + ((size_t)(c >> 3) * B + row) * MP;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int i = i0 + k;
        if (i < MP) out[i == 0 ? MP - 1 : i - 1] = (int32_t)acc[k];
        acc[k] = 0;
      }
    }
  }
  for (int c = c_end + x; c < N; c += blockDim.x) bot[c] = NEGF;
}

template <int LPT>
cudaError_t launch(const float* sig, const float* tmpl, const int* nact, int32_t* ptr,
                   float* bottom, int B, int N, int MP, int m, Params p, cudaStream_t stream) {
  const int threads = ((MP / LPT) + 31) / 32 * 32;
  col_align_kernel<LPT><<<B, threads, 0, stream>>>(sig, tmpl, nact, ptr, bottom, B, N, MP, m,
                                                   p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int col_align_launch(const void* sig, const void* tmpl, const void* nact, void* ptr,
                                void* bottom, int B, int N, int MP, int m, int neg_h,
                                float go_h, float go_v, float ge_h, float ge_v, float off,
                                float dmin, float g, void* stream) {
  if (MP % 128 || N % 8 || m <= 0 || m >= MP) return (int)cudaErrorInvalidValue;
  Params p{go_h, go_v, ge_h, ge_v, off, dmin, g, neg_h};
  auto s = (const float*)sig;
  auto tp = (const float*)tmpl;
  auto na = (const int*)nact;
  auto pt = (int32_t*)ptr;
  auto bt = (float*)bottom;
  auto st = (cudaStream_t)stream;
  if (MP <= 1024) return (int)launch<1>(s, tp, na, pt, bt, B, N, MP, m, p, st);
  if (MP <= 2048) return (int)launch<2>(s, tp, na, pt, bt, B, N, MP, m, p, st);
  if (MP <= 4096) return (int)launch<4>(s, tp, na, pt, bt, B, N, MP, m, p, st);
  if (MP <= 8192) return (int)launch<8>(s, tp, na, pt, bt, B, N, MP, m, p, st);
  return (int)cudaErrorInvalidValue;
}
