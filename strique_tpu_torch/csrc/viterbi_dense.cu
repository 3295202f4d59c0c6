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
// What bounds it on an H100: the serial time chain.  Each step needs the
// previous row whole and reads all SP x SP transitions; the 2 SP^2
// operations a step are far below the card's rate, and the score-row
// stream (T x B x SP f32) is written once, coalesced.  So a step's
// latency -- where the transitions sit, and how the row crosses the
// threads that share it -- sets the time.  Two modes, picked by
// viterbi_cuda.dense_mode (a rule on SP alone):
//
// RESIDENT (SP <= 512): a read is a thread-block cluster of K CTAs of 16
// warps (K = 1 at SP 128, 2 at 256, 6 at 384, 8 at 512), and the
// transitions stay on chip for the whole launch: each warp owns C = 8 or
// 4 destination columns and its lanes hold their transitions from all SP
// source rows in registers (R x C = 32 to 64 a lane).  A step crosses no
// barrier: each CTA receives the step's whole val row (SP floats) from
// the cluster by st.async into one of two row buffers (step parity),
// which completes bytes on that buffer's mbarrier, and waits on that
// mbarrier alone.  m is the row's max, st[u] = val[u] - m: the f32
// expression the streamed kernel stores, so the bits are equal.  (On an
// H100 a cluster barrier a step costs more than the st.async exchange,
// and the transitions read from shared memory cost more than from
// registers: tools/probe_dense_sync.py.)
//
// STREAMED (SP > 512, up to 8192): the transitions no longer fit the
// registers of 8 CTAs, so one CTA per read, one thread per destination
// state v (VPT states a thread when SP > 1024); the previous row sits in
// shared memory (a broadcast read per u) and thread v walks u down its
// column of trans in L2, whose reads coalesce across the warp.
//
// Max is exact, so any order over u and any grouping of the row max
// gives the reference's value (its row/column orientation switch is a
// Mosaic layout choice, not arithmetic); no entry is skipped (a NEG
// non-edge can win a column whose live sources sit near NEG).  acc sums
// in f32, in step order, as the reference does.  A read stops at its
// own length: the reference keeps stepping (unfrozen) to the end of its
// 512-step chunk, rows nothing reads.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

#include "cluster.cuh"

constexpr float NEGF = -1e30f;
constexpr int MAX_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr int RES_WARPS = 16;        // resident mode: warps a CTA
constexpr int RES_THREADS = 32 * RES_WARPS;

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

// ---------------------------------------------------------------------------
// RESIDENT mode: a cluster of K CTAs a read, the transitions in registers
// ---------------------------------------------------------------------------

// R = SP / 32 source rows a lane, C destination columns a warp (VC = 16 C
// a CTA, K = SP / VC CTAs a read).  Lane l of warp w in CTA r holds
// trans[l + 32 i, r VC + w C + c] for i < R, c < C in registers.  A step:
//   * wait for the step's val row (SP floats, from every CTA of the
//     cluster); each lane reads its R entries, m is their warp max, and
//     st[u] = val[u] - m;
//   * each lane takes its C column maxes over its rows; a reduce-scatter
//     over the warp's lanes (log2 C halving levels, then a max over the
//     lanes left) leaves column c = w C + cidx(l) in lane l;
//   * val = best + emit; lanes 4 GROUP q gather columns 4q..4q+3 and
//     st.async them (16 bytes) into the val row of the step's parity of
//     every CTA, completing bytes on that CTA's mbarrier of that parity.
// A CTA arms each mbarrier phase for SP x 4 bytes (thread 0's
// arrive.expect_tx) after the phase before it on that barrier completed;
// a row reaches a CTA only after its sender saw the previous row whole,
// which every CTA sends only after it read the row before, so two buffers
// by step parity carry the rows with no other synchronisation.
template <int R, int C>
__global__ void __launch_bounds__(RES_THREADS, 1)
viterbi_dense_resident_kernel(const float* __restrict__ obs, const int* __restrict__ tact,
                              const float* __restrict__ trans, const float* __restrict__ start,
                              const float* __restrict__ mu, const float* __restrict__ sigma,
                              const int* __restrict__ uni, const float* __restrict__ luni,
                              const float* __restrict__ lsig, float* __restrict__ sc,
                              float* __restrict__ fin, float* __restrict__ acc_out, int B,
                              int T) {
  constexpr int SP = 32 * R;
  constexpr int VC = 16 * C;
  constexpr int LC = C == 8 ? 3 : 2;  // log2 C
  constexpr int GROUP = 32 / C;      // lanes that end up holding one column
  constexpr uint32_t BYTES = 4 * SP;
  __shared__ __align__(16) float vbuf[2][SP];  // [parity][u]: the step's val row
  __shared__ __align__(8) uint64_t bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / K;
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int wcol0 = rank * VC + warp * C;
  const int ta = min(tact[b], T);  // lengths past T would read past the row
  const float* x_row = obs + (size_t)b * T;

  float tr[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) tr[i][c] = trans[(size_t)(lane + 32 * i) * SP + wcol0 + c];
  int cidx = 0;  // this lane's column after the reduce-scatter
#pragma unroll
  for (int lv = 0; lv < LC; ++lv) cidx |= ((lane >> (4 - lv)) & 1) << (LC - 1 - lv);
  const int v = wcol0 + cidx;
  const float mu_v = mu[v], sig_v = sigma[v], luni_v = luni[v], lsig_v = lsig[v];
  const float start_v = start[v];
  const bool uni_v = uni[v] != 0;
  const bool sender = lane % (4 * GROUP) == 0;  // holds columns 4q..4q+3 after the gather
  const int q4 = wcol0 + 4 * (lane / (4 * GROUP));
  const uint32_t bar0 = smem_addr(&bar[0]);
  if (x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (ta > 0) expect_tx(bar0, BYTES);
    if (ta > 1) expect_tx(bar0 + 8, BYTES);
  }
  float4 val4 = make_float4(0.f, 0.f, 0.f, 0.f);  // sender: its columns' val, last step
  float acc = 0.0f, m = 0.0f;
  float x_next = ta > 0 ? x_row[0] : 0.0f;
  // every CTA of the cluster runs, its barriers armed, before any row moves
  cluster.sync();

  for (int t = 0; t < ta; ++t) {
    const int p = t & 1;
    const float xt = x_next;
    if (t + 1 < ta) x_next = x_row[t + 1];
    const float z = (xt - mu_v) / sig_v;
    const float emit = uni_v ? luni_v : (lsig_v - (0.5f * z) * z);
    float best = start_v;
    if (t > 0) {
      wait_parity(bar0 + 8 * (p ^ 1), ((t - 1) >> 1) & 1);
      if (x == 0 && t + 1 < ta) expect_tx(bar0 + 8 * (p ^ 1), BYTES);  // row t + 1
      float vv[R];
      float lm = -INFINITY;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        vv[i] = vbuf[p ^ 1][lane + 32 * i];
        lm = fmaxf(lm, vv[i]);
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) lm = fmaxf(lm, __shfl_xor_sync(FULL, lm, d));
      m = lm;
      if (sender)
        *reinterpret_cast<float4*>(sc + ((size_t)(t - 1) * B + b) * SP + q4) =
            make_float4(val4.x - m, val4.y - m, val4.z - m, val4.w - m);
      acc = acc + m;
      float bc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) bc[c] = -INFINITY;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float s = vv[i] - m;
#pragma unroll
        for (int c = 0; c < C; ++c) bc[c] = fmaxf(bc[c], s + tr[i][c]);
      }
#pragma unroll
      for (int lv = 0; lv < LC; ++lv) {
        const int half = C >> (lv + 1);
        const bool hi = (lane >> (4 - lv)) & 1;
#pragma unroll
        for (int j = 0; j < half; ++j) {
          const float keep = hi ? bc[j + half] : bc[j];
          const float send = hi ? bc[j] : bc[j + half];
          bc[j] = fmaxf(keep, __shfl_xor_sync(FULL, send, 16 >> lv));
        }
      }
#pragma unroll
      for (int d = 16 >> LC; d > 0; d >>= 1)
        bc[0] = fmaxf(bc[0], __shfl_xor_sync(FULL, bc[0], d));
      best = bc[0];
    }
    const float val = best + emit;
    val4 = make_float4(val, __shfl_down_sync(FULL, val, GROUP),
                       __shfl_down_sync(FULL, val, 2 * GROUP),
                       __shfl_down_sync(FULL, val, 3 * GROUP));
    if (sender) {
      const uint32_t a = smem_addr(&vbuf[p][q4]);
      for (int r = 0; r < K; ++r) st_async_v4(a, val4, bar0 + 8 * p, r);
    }
  }
  if (ta > 0) {
    const int p = (ta - 1) & 1;
    wait_parity(bar0 + 8 * p, ((ta - 1) >> 1) & 1);
    float lm = -INFINITY;
#pragma unroll
    for (int i = 0; i < R; ++i) lm = fmaxf(lm, vbuf[p][lane + 32 * i]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) lm = fmaxf(lm, __shfl_xor_sync(FULL, lm, d));
    m = lm;
    acc = acc + m;
  }
  if (sender) {
    const float4 st = make_float4(val4.x - m, val4.y - m, val4.z - m, val4.w - m);
    if (ta > 0) *reinterpret_cast<float4*>(sc + ((size_t)(ta - 1) * B + b) * SP + q4) = st;
    *reinterpret_cast<float4*>(fin + (size_t)b * SP + q4) =
        ta > 0 ? st : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (rank == 0 && x == 0) acc_out[b] = acc;
  // no CTA leaves while a partner may still send into it
  cluster.sync();
}

template <int R, int C>
cudaError_t launch_resident(const float* obs, const int* tact, const float* trans,
                            const float* start, const float* mu, const float* sigma,
                            const int* uni, const float* luni, const float* lsig, float* sc,
                            float* fin, float* acc, int B, int T, int K, cudaStream_t stream) {
  auto kern = viterbi_dense_resident_kernel<R, C>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * K);
  cfg.blockDim = dim3(RES_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the cluster must fit the card: K CTAs of 512 threads on K SMs
  int clusters = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kern, obs, tact, trans, start, mu, sigma, uni, luni, lsig, sc,
                         fin, acc, B, T);
  if (e != cudaSuccess) return e;
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

// RESIDENT mode: K CTAs a read (viterbi_cuda.dense_mode); R = SP / 32
// rows a lane and C = SP / (16 K) columns a warp, as the rule picks them
extern "C" int viterbi_dense_resident_launch(const void* obs, const void* tact,
                                             const void* trans, const void* start,
                                             const void* mu, const void* sigma,
                                             const void* uni, const void* luni,
                                             const void* lsig, void* sc, void* fin, void* acc,
                                             int B, int T, int SP, int K, void* stream) {
  if (SP <= 0 || SP % 128 || K < 1 || K > 8 || SP % (16 * K)) return (int)cudaErrorInvalidValue;
  const int R = SP / 32;
  const int C = SP / (16 * K);
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
#define RESIDENT(r, c)                                                                        \
  if (R == r && C == c)                                                                       \
    return (int)launch_resident<r, c>(o, ta, tr, s0, m, sg, un, lu, ls, out, fn, ac, B, T, K, st);
  RESIDENT(4, 8)   // SP 128, K 1
  RESIDENT(8, 8)   // SP 256, K 2
  RESIDENT(12, 4)  // SP 384, K 6
  RESIDENT(16, 4)  // SP 512, K 8
#undef RESIDENT
  return (int)cudaErrorInvalidValue;
}
