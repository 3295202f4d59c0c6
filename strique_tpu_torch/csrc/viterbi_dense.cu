// Dense max-plus Viterbi forward over the full transition matrix.
//
// Replaces the Pallas TPU kernel strique_tpu/ops/viterbi_pallas.py
// `_fwd_kernel_multi` (called by `viterbi_forward_pallas_multi`), the
// decode of HMMs that hmm/factor.py declines and of every HMM under
// STRIQUE_DENSE_VITERBI=1.  Per read and step t:
//   val[v] = max_u(st[u] + trans[u, v]) + emit(x_t)[v]   (t = 0: start + emit)
//   m = max_v val,  st = val - m,  acc += m (t < t_actual),
//   fin = st at t = t_actual - 1,  rows[t, read, :] = st.
// The emission is lsig - (0.5 z) z with z = (x - mu) / sigma (IEEE
// division), or luni for uniform states; lsig arrives from the host.
//
// What bounds it on an H100: the serial time chain and the transition
// reads.  Each step needs the previous row, and reads all SP x SP
// transitions (256 KB at SP 256: more than a block's 227 KB of shared
// memory) -- from L2, where the 50 MB cache holds the matrix for every
// read of the call.  The 2 SP^2 operations a step are far below the
// card's rate; the score-row stream (T x B x SP f32) is written once,
// coalesced.
//
// Design: one CTA per read, one thread per destination state v (VPT
// states a thread when SP > 1024).  The previous row sits in shared
// memory (a broadcast read per u); thread v walks u down its column of
// trans, whose reads coalesce across the warp.  Max is exact, so any
// order over u gives the reference's value (its row/column orientation
// switch is a Mosaic layout choice, not arithmetic).  The row max is a
// warp shfl_xor reduction plus a pass over the warp results; acc sums
// in f32, in step order, as the reference does.  A read stops at its
// own length: the reference keeps stepping (unfrozen) to the end of its
// 512-step chunk, rows nothing reads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEGF = -1e30f;
constexpr int MAX_THREADS = 1024;

template <int VPT>
__global__ void __launch_bounds__(MAX_THREADS)
viterbi_dense_kernel(const float* __restrict__ obs, const int* __restrict__ tact,
                     const float* __restrict__ trans, const float* __restrict__ start,
                     const float* __restrict__ mu, const float* __restrict__ sigma,
                     const int* __restrict__ uni, const float* __restrict__ luni,
                     const float* __restrict__ lsig, float* __restrict__ sc,
                     float* __restrict__ fin, float* __restrict__ acc_out, int B, int T,
                     int SP) {
  extern __shared__ float st_sh[];  // SP
  __shared__ float warp_red[32];
  const int b = blockIdx.x;
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int ta = min(tact[b], T);  // lengths past T would read past the row
  const float* x_row = obs + (size_t)b * T;

  float mu_v[VPT], sig_v[VPT], luni_v[VPT], lsig_v[VPT], start_v[VPT], st[VPT], fin_v[VPT];
  bool uni_v[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = x + k * blockDim.x;
    const bool live = v < SP;
    mu_v[k] = live ? mu[v] : 0.0f;
    sig_v[k] = live ? sigma[v] : 1.0f;
    luni_v[k] = live ? luni[v] : 0.0f;
    lsig_v[k] = live ? lsig[v] : 0.0f;
    start_v[k] = live ? start[v] : NEGF;
    uni_v[k] = live && uni[v] != 0;
    st[k] = 0.0f;
    fin_v[k] = 0.0f;
  }
  float acc = 0.0f;

  for (int t = 0; t < ta; ++t) {
    const float xt = x_row[t];
    float val[VPT];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int v = x + k * blockDim.x;
      const float z = (xt - mu_v[k]) / sig_v[k];
      const float emit = uni_v[k] ? luni_v[k] : (lsig_v[k] - (0.5f * z) * z);
      float best;
      if (t == 0) {
        best = start_v[k];
      } else if (v < SP) {
        float b0 = -INFINITY, b1 = -INFINITY, b2 = -INFINITY, b3 = -INFINITY;
        const float* col = trans + v;
        int u = 0;
        for (; u + 3 < SP; u += 4) {
          b0 = fmaxf(b0, st_sh[u] + col[(size_t)u * SP]);
          b1 = fmaxf(b1, st_sh[u + 1] + col[(size_t)(u + 1) * SP]);
          b2 = fmaxf(b2, st_sh[u + 2] + col[(size_t)(u + 2) * SP]);
          b3 = fmaxf(b3, st_sh[u + 3] + col[(size_t)(u + 3) * SP]);
        }
        for (; u < SP; ++u) b0 = fmaxf(b0, st_sh[u] + col[(size_t)u * SP]);
        best = fmaxf(fmaxf(b0, b1), fmaxf(b2, b3));
      } else {
        best = -INFINITY;
      }
      val[k] = best + emit;
      if (v < SP) mx = fmaxf(mx, val[k]);
    }
    // row max over the block
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
    if (lane == 0) warp_red[warp] = mx;
    __syncthreads();  // also: every thread is done reading st_sh for this step
    float m = warp_red[0];
    for (int w = 1; w < n_warps; ++w) m = fmaxf(m, warp_red[w]);
    acc = acc + m;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int v = x + k * blockDim.x;
      if (v >= SP) continue;
      st[k] = val[k] - m;
      if (t == ta - 1) fin_v[k] = st[k];
      st_sh[v] = st[k];
      sc[((size_t)t * B + b) * SP + v] = st[k];
    }
    __syncthreads();  // the new row is in st_sh; warp_red may be reused
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = x + k * blockDim.x;
    if (v < SP) fin[(size_t)b * SP + v] = fin_v[k];
  }
  if (x == 0) acc_out[b] = acc;
}

template <int VPT>
cudaError_t launch(const float* obs, const int* tact, const float* trans, const float* start,
                   const float* mu, const float* sigma, const int* uni, const float* luni,
                   const float* lsig, float* sc, float* fin, float* acc, int B, int T, int SP,
                   cudaStream_t stream) {
  const int threads = ((SP + VPT - 1) / VPT + 31) / 32 * 32;
  const size_t shmem = (size_t)SP * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(viterbi_dense_kernel<VPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return e;
  }
  viterbi_dense_kernel<VPT><<<B, threads, shmem, stream>>>(
      obs, tact, trans, start, mu, sigma, uni, luni, lsig, sc, fin, acc, B, T, SP);
  return cudaGetLastError();
}

}  // namespace

extern "C" int viterbi_dense_launch(const void* obs, const void* tact, const void* trans,
                                    const void* start, const void* mu, const void* sigma,
                                    const void* uni, const void* luni, const void* lsig,
                                    void* sc, void* fin, void* acc, int B, int T, int SP,
                                    void* stream) {
  if (SP <= 0 || SP % 128) return (int)cudaErrorInvalidValue;
  auto o = (const float*)obs;
  auto ta = (const int*)tact;
  auto tr = (const float*)trans;
  auto s0 = (const float*)start;
  auto m = (const float*)mu;
  auto sg = (const float*)sigma;
  auto un = (const int*)uni;
  auto lu = (const float*)luni;
  auto ls = (const float*)lsig;
  auto out = (float*)sc;
  auto fn = (float*)fin;
  auto ac = (float*)acc;
  auto st = (cudaStream_t)stream;
  if (SP <= 1024) return (int)launch<1>(o, ta, tr, s0, m, sg, un, lu, ls, out, fn, ac, B, T, SP, st);
  if (SP <= 2048) return (int)launch<2>(o, ta, tr, s0, m, sg, un, lu, ls, out, fn, ac, B, T, SP, st);
  if (SP <= 4096) return (int)launch<4>(o, ta, tr, s0, m, sg, un, lu, ls, out, fn, ac, B, T, SP, st);
  if (SP <= 8192) return (int)launch<8>(o, ta, tr, s0, m, sg, un, lu, ls, out, fn, ac, B, T, SP, st);
  return (int)cudaErrorInvalidValue;
}
