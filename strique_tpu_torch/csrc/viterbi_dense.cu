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
// registers of 8 CTAs.  A read is still a cluster of K CTAs (up to 8)
// exchanging each step's row by st.async; each CTA computes its SP / K
// columns from L2 (or, where they fit, from its slice in shared memory),
// many float4 loads in flight over its 512 or 1024 threads.  A step's
// 4 SP^2 bytes thus stream through K SMs at once, not one.  (The one-CTA
// form it replaces, a thread a column walking trans in L2 with 4 loads
// in flight, is kept in tools/probe_viterbi_wide.cu, which times the
// two side by side, and 16 CTAs a read beside 8.)
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
constexpr int MAX_SP = 8192;               // viterbi_cuda.MAX_SP
constexpr int MAX_CLUSTER = 8;             // the portable cluster size
constexpr size_t MAX_SHMEM = 232448 - 64;  // an H100 CTA's, less the static mbarriers
constexpr unsigned FULL = 0xffffffffu;
constexpr int RES_WARPS = 16;        // resident mode: warps a CTA
constexpr int RES_THREADS = 32 * RES_WARPS;

// STREAMED mode: a cluster of K CTAs a read (K up to 8), CTA r computing
// the VC = SP / K destination columns [r VC, (r + 1) VC) with NT
// threads.  Thread i takes column quad q = i % Q (Q = VC / 4) and source
// rows u = g, g + G, ... (g = i / Q, G = NT / Q groups): a float4 of
// transitions a row, coalesced across the quads, several rows' loads in
// flight, from L2 (SLICE = false, read
// through the non-coherent path: the slice stays in L1 when it fits) or
// from the CTA's copy of its slice in shared memory (SLICE = true,
// loaded once).  The groups' column maxes meet in shared memory behind
// one CTA barrier; the thread owning column c folds them, adds the
// emission and sends val by st.async, 4 columns a 16-byte message, into
// the step parity's row of every CTA, with each warp's max, as the
// resident mode does.  m is the max of the K PW warp maxima.
template <bool SLICE>
__global__ void __launch_bounds__(MAX_THREADS, 1)
viterbi_dense_cluster_kernel(const float* __restrict__ obs, const int* __restrict__ tact,
                             const float* __restrict__ trans, const float* __restrict__ start,
                             const float* __restrict__ mu, const float* __restrict__ sigma,
                             const int* __restrict__ uni, const float* __restrict__ luni,
                             const float* __restrict__ lsig, float* __restrict__ sc,
                             float* __restrict__ fin, float* __restrict__ acc_out, int B,
                             int T, int SP) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int VC = SP / K;
  const int Q = VC >> 2;
  const int NT = blockDim.x;
  const int G = NT / Q;
  const int PW = (VC + 31) >> 5;  // warps owning columns
  const int NP = K * PW;
  const int NPP = (NP + 3) & ~3;
  const int b = blockIdx.x / K;
  const int col0 = rank * VC;
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int q = x % Q;
  const int g = x / Q;
  const bool active = g < G;
  const bool owner = x < VC;
  const int v = col0 + (owner ? x : 0);
  const int ta = min(tact[b], T);  // lengths past T would read past the row
  const float* x_row = obs + (size_t)b * T;
  float* vbuf = smem;                          // [2][SP]: the val rows
  float* pbuf = vbuf + 2 * SP;                 // [2][NPP]: their warp maxima
  float* comb = pbuf + 2 * NPP;                // [G][VC]: the groups' column maxes
  float* slice = comb + (size_t)G * VC;        // SLICE: [SP][VC]
  const uint32_t BYTES = 4u * (SP + NP);
  const uint32_t bar0 = smem_addr(&bar[0]);
  if (SLICE) {
    const int quads = Q * SP;
    for (int e = x; e < quads; e += NT) {
      const int u = e / Q;
      const int qq = e - u * Q;
      reinterpret_cast<float4*>(slice)[e] =
          __ldg(reinterpret_cast<const float4*>(trans + (size_t)u * SP + col0) + qq);
    }
  }
  if (x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (ta > 0) expect_tx(bar0, BYTES);
    if (ta > 1) expect_tx(bar0 + 8, BYTES);
  }
  const float mu_v = mu[v], sig_v = sigma[v], luni_v = luni[v], lsig_v = lsig[v];
  const float start_v = start[v];
  const bool uni_v = uni[v] != 0;
  auto emission = [&](float xt) {
    const float z = (xt - mu_v) / sig_v;
    return uni_v ? luni_v : (lsig_v - (0.5f * z) * z);
  };
  float emit = ta > 0 ? emission(x_row[0]) : 0.0f;
  float x_next = ta > 1 ? x_row[1] : 0.0f;
  float val = 0.0f, m = 0.0f, acc = 0.0f, fin_v = 0.0f;
  const float4* tq = SLICE ? reinterpret_cast<const float4*>(slice) + q
                           : reinterpret_cast<const float4*>(trans + col0) + q;
  const size_t tstride = SLICE ? Q : SP / 4;  // float4s a source row
  auto row_max = [&](int p) {
    float lm = -INFINITY;
    for (int i = lane; i < NP; i += 32) lm = fmaxf(lm, pbuf[p * NPP + i]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) lm = fmaxf(lm, __shfl_xor_sync(FULL, lm, d));
    return lm;
  };
  __syncthreads();
  // every CTA of the cluster runs, its barriers armed, before any row moves
  cluster.sync();

  for (int t = 0; t < ta; ++t) {
    const int p = t & 1;
    float best = start_v;
    if (t > 0) {
      wait_parity_cta(bar0 + 8 * (p ^ 1), ((t - 1) >> 1) & 1);
      if (x == 0 && t + 1 < ta) expect_tx(bar0 + 8 * (p ^ 1), BYTES);  // row t + 1
      m = row_max(p ^ 1);
      acc = acc + m;
      if (owner) sc[((size_t)(t - 1) * B + b) * SP + v] = val - m;
      if (active) {
        const float* vp = vbuf + (p ^ 1) * SP;
        float4 bm = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        int u = g;
        // four rows' loads in flight, then their maxes
        for (; u + 3 * G < SP; u += 4 * G) {
          float4 tr[4];
          float s[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            tr[r] = SLICE ? tq[(size_t)(u + r * G) * tstride]
                          : __ldg(tq + (size_t)(u + r * G) * tstride);
            s[r] = vp[u + r * G] - m;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            bm.x = fmaxf(bm.x, s[r] + tr[r].x);
            bm.y = fmaxf(bm.y, s[r] + tr[r].y);
            bm.z = fmaxf(bm.z, s[r] + tr[r].z);
            bm.w = fmaxf(bm.w, s[r] + tr[r].w);
          }
        }
        for (; u < SP; u += G) {
          const float4 tr = SLICE ? tq[(size_t)u * tstride] : __ldg(tq + (size_t)u * tstride);
          const float s = vp[u] - m;
          bm.x = fmaxf(bm.x, s + tr.x);
          bm.y = fmaxf(bm.y, s + tr.y);
          bm.z = fmaxf(bm.z, s + tr.z);
          bm.w = fmaxf(bm.w, s + tr.w);
        }
        reinterpret_cast<float4*>(comb)[g * Q + q] = bm;
      }
      __syncthreads();
      if (owner) {
        float b0 = comb[x], b1 = -INFINITY, b2 = -INFINITY, b3 = -INFINITY;
        int i = 1;
        for (; i + 2 < G; i += 3) {
          b1 = fmaxf(b1, comb[i * VC + x]);
          b2 = fmaxf(b2, comb[(i + 1) * VC + x]);
          b3 = fmaxf(b3, comb[(i + 2) * VC + x]);
        }
        for (; i < G; ++i) b0 = fmaxf(b0, comb[i * VC + x]);
        best = fmaxf(fmaxf(b0, b1), fmaxf(b2, b3));
      }
    }
    val = best + emit;
    // lanes 4k..4k+3's val as one 16-byte message to every CTA
    const float v1 = __shfl_down_sync(FULL, val, 1);
    const float v2 = __shfl_down_sync(FULL, val, 2);
    const float v3 = __shfl_down_sync(FULL, val, 3);
    if (owner && (lane & 3) == 0) {
      const float4 q4 = make_float4(val, v1, v2, v3);
      const uint32_t a = smem_addr(vbuf + p * SP + v);
      for (int r = 0; r < K; ++r) st_async_v4(a, q4, bar0 + 8 * p, r);
    }
    if (warp < PW) {
      float wm = owner ? val : -INFINITY;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) wm = fmaxf(wm, __shfl_xor_sync(FULL, wm, d));
      if (lane == 0) {
        const uint32_t a = smem_addr(pbuf + p * NPP + rank * PW + warp);
        for (int r = 0; r < K; ++r) st_async_b32(a, __float_as_uint(wm), bar0 + 8 * p, r);
      }
    }
    if (t + 1 < ta) {
      emit = emission(x_next);
      if (t + 2 < ta) x_next = x_row[t + 2];
    }
  }
  if (ta > 0) {
    const int p = (ta - 1) & 1;
    wait_parity_cta(bar0 + 8 * p, ((ta - 1) >> 1) & 1);
    m = row_max(p);
    acc = acc + m;
    fin_v = val - m;
    if (owner) sc[((size_t)(ta - 1) * B + b) * SP + v] = fin_v;
  }
  if (owner) fin[(size_t)b * SP + v] = fin_v;
  if (rank == 0 && x == 0) acc_out[b] = acc;
  // no CTA leaves while a partner may still send into it
  cluster.sync();
}

// the streamed mode's threads a CTA: at least 512, and one a column
__host__ __device__ constexpr int stream_threads(int VC) { return VC > 512 ? 1024 : 512; }

// shared bytes of the streamed mode at SP, K CTAs, a slice or not
inline size_t stream_shmem(int SP, int K, bool slice) {
  const int VC = SP / K;
  const int NP = K * ((VC + 31) / 32);
  const int G = stream_threads(VC) / (VC / 4);
  return (2 * (size_t)SP + 2 * ((NP + 3) & ~3) + (size_t)G * VC + (slice ? (size_t)SP * VC : 0)) *
         sizeof(float);
}

template <bool SLICE>
cudaError_t launch_stream(const float* obs, const int* tact, const float* trans,
                          const float* start, const float* mu, const float* sigma,
                          const int* uni, const float* luni, const float* lsig, float* sc,
                          float* fin, float* acc, int B, int T, int SP, int K,
                          cudaStream_t stream) {
  auto kern = viterbi_dense_cluster_kernel<SLICE>;
  const size_t shmem = stream_shmem(SP, K, SLICE);
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
  cfg.blockDim = dim3(stream_threads(SP / K));
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kern, obs, tact, trans, start, mu, sigma, uni, luni, lsig, sc,
                         fin, acc, B, T, SP);
  if (e != cudaSuccess) return e;
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

// STREAMED mode: K CTAs a read (viterbi_cuda.dense_mode: up to 8, VC =
// SP / K columns a CTA, a multiple of 4, at most 1024); slice: the CTA's
// transitions held in shared memory (they must fit beside the rows)
extern "C" int viterbi_dense_stream_launch(const void* obs, const void* tact, const void* trans,
                                           const void* start, const void* mu,
                                           const void* sigma, const void* uni,
                                           const void* luni, const void* lsig, void* sc,
                                           void* fin, void* acc, int B, int T, int SP, int K,
                                           int slice, void* stream) {
  if (SP <= 0 || SP % 128 || SP > MAX_SP || K < 1 || K > MAX_CLUSTER || SP % (4 * K) ||
      SP / K > MAX_THREADS || (slice && stream_shmem(SP, K, true) > MAX_SHMEM))
    return (int)cudaErrorInvalidValue;
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
  if (slice)
    return (int)launch_stream<true>(o, ta, tr, s0, m, sg, un, lu, ls, out, fn, ac, B, T, SP, K, st);
  return (int)launch_stream<false>(o, ta, tr, s0, m, sg, un, lu, ls, out, fn, ac, B, T, SP, K, st);
}

// RESIDENT mode: K CTAs a read (viterbi_cuda.dense_mode); R = SP / 32
// rows a lane and C = SP / (16 K) columns a warp, as the rule picks them
extern "C" int viterbi_dense_resident_launch(const void* obs, const void* tact,
                                             const void* trans, const void* start,
                                             const void* mu, const void* sigma,
                                             const void* uni, const void* luni,
                                             const void* lsig, void* sc, void* fin, void* acc,
                                             int B, int T, int SP, int K, void* stream) {
  if (SP <= 0 || SP % 128 || K < 1 || K > MAX_CLUSTER || SP % (16 * K))
    return (int)cudaErrorInvalidValue;
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
