// Probe kernels for tools/probe_dense_sync.py: the dense Viterbi forward's
// resident mode with the transitions' column slice in shared memory, the
// layout strique_tpu_torch/csrc/viterbi_dense.cu does not ship (it keeps
// them in registers), bit-equal to its plain twin, to time beside it.
// Warps split the source rows and fold their column maxes behind a
// __syncthreads; the step's val row and partial maxes cross the cluster
//   SA = false  by DSMEM stores and ONE cluster barrier a step;
//   SA = true   by st.async into two mbarrier-guarded buffers (the
//               shipped kernel's exchange, no cluster barrier).
// The shipped kernel's helpers and constants come from including its
// source.  Not part of the package; built by the probe with nvcc.
#include "../strique_tpu_torch/csrc/viterbi_dense.cu"

namespace {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// one float into CTA `rank`'s copy of shared address `addr`, completing
// 4 bytes on that CTA's copy of mbarrier `bar`
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 ra, rb;\n"
      " mapa.shared::cluster.u32 ra, %0, %3;\n"
      " mapa.shared::cluster.u32 rb, %2, %3;\n"
      " st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [ra], %1, [rb];\n}\n" ::"r"(addr),
      "f"(v), "r"(bar), "r"(rank)
      : "memory");
}

__host__ __device__ constexpr size_t slice_floats(int SP, int VC) {
  return (size_t)SP * VC + (size_t)RES_WARPS * (32 / (VC / 4)) * VC + 2 * (size_t)SP +
         2 * (size_t)(SP / 32);
}

template <int VC, bool SA>
__global__ void __launch_bounds__(RES_THREADS, 1)
slice_kernel(const float* __restrict__ obs, const int* __restrict__ tact,
             const float* __restrict__ trans, const float* __restrict__ start,
             const float* __restrict__ mu, const float* __restrict__ sigma,
             const int* __restrict__ uni, const float* __restrict__ luni,
             const float* __restrict__ lsig, float* __restrict__ sc, float* __restrict__ fin,
             float* __restrict__ acc_out, int B, int T, int SP) {
  constexpr int LPR = VC / 4;   // lanes a source row (4 columns a lane)
  constexpr int RPI = 32 / LPR;  // source rows a warp reads at once
  constexpr int PW = VC / 32;    // partial maxes a CTA sends
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) uint64_t bar[2];
  float* trs = reinterpret_cast<float*>(smem4);  // [u][VC]
  float* comb = trs + (size_t)SP * VC;            // the warps' column maxes
  float* vbuf = comb + RES_WARPS * RPI * VC;      // [parity][SP]
  float* pbuf = vbuf + 2 * SP;                    // [parity][SP / 32]
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / K;
  const int col0 = rank * VC;
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int NP = SP / 32;
  const uint32_t BYTES = 4u * (SP + NP);
  const int ta = min(tact[b], T);
  const float* x_row = obs + (size_t)b * T;
  for (int e = x; e < SP * LPR; e += RES_THREADS) {
    const int u = e / LPR;
    const int q = e - u * LPR;
    cp_async16(trs + (size_t)u * VC + 4 * q, trans + (size_t)u * SP + col0 + 4 * q);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  const uint32_t bar0 = smem_addr(&bar[0]);
  if (SA && x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (ta > 0) expect_tx(bar0, BYTES);
    if (ta > 1) expect_tx(bar0 + 8, BYTES);
  }
  const bool owner = x < VC;
  const int v = col0 + (owner ? x : 0);
  const float mu_v = mu[v], sig_v = sigma[v], luni_v = luni[v], lsig_v = lsig[v];
  const float start_v = start[v];
  const bool uni_v = uni[v] != 0;
  const int RW = SP / RES_WARPS;
  const int sub = lane / LPR;
  const int q4 = 4 * (lane - sub * LPR);
  const int u_lo = warp * RW + sub * (RW / RPI);
  const int u_hi = u_lo + RW / RPI;
  float val = 0.0f, acc = 0.0f, m = 0.0f;
  float x_next = ta > 0 ? x_row[0] : 0.0f;
  __syncthreads();
  cluster.sync();
  for (int t = 0; t < ta; ++t) {
    const int p = t & 1;
    const float xt = x_next;
    if (t + 1 < ta) x_next = x_row[t + 1];
    float emit = 0.0f;
    if (owner) {
      const float z = (xt - mu_v) / sig_v;
      emit = uni_v ? luni_v : (lsig_v - (0.5f * z) * z);
    }
    float best = start_v;
    if (t > 0) {
      if (SA) {
        wait_parity(bar0 + 8 * (p ^ 1), ((t - 1) >> 1) & 1);
        if (x == 0 && t + 1 < ta) expect_tx(bar0 + 8 * (p ^ 1), BYTES);  // step t + 1
      }
      const float* pp = pbuf + (p ^ 1) * NP;
      m = pp[0];
      for (int i = 1; i < NP; ++i) m = fmaxf(m, pp[i]);
      if (owner) sc[((size_t)(t - 1) * B + b) * SP + v] = val - m;
      acc = acc + m;
      const float* vp = vbuf + (p ^ 1) * SP;
      float4 bm = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
#pragma unroll 2
      for (int u = u_lo; u < u_hi; u += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vp + u);
        const float sv[4] = {vv.x - m, vv.y - m, vv.z - m, vv.w - m};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 tr = *reinterpret_cast<const float4*>(trs + (size_t)(u + r) * VC + q4);
          bm.x = fmaxf(bm.x, sv[r] + tr.x);
          bm.y = fmaxf(bm.y, sv[r] + tr.y);
          bm.z = fmaxf(bm.z, sv[r] + tr.z);
          bm.w = fmaxf(bm.w, sv[r] + tr.w);
        }
      }
      *reinterpret_cast<float4*>(comb + (warp * RPI + sub) * VC + q4) = bm;
      __syncthreads();
      if (owner) {
        best = comb[x];
#pragma unroll 8
        for (int r = 1; r < RES_WARPS * RPI; ++r) best = fmaxf(best, comb[r * VC + x]);
      }
    }
    if (owner) {
      val = best + emit;
      float pm = val;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) pm = fmaxf(pm, __shfl_xor_sync(FULL, pm, d));
      if (SA) {
        const uint32_t va = smem_addr(vbuf + p * SP + v);
        const uint32_t pa = smem_addr(pbuf + p * NP + rank * PW + warp);
        for (int r = 0; r < K; ++r) {
          st_async(va, val, bar0 + 8 * p, r);
          if (lane == 0) st_async(pa, pm, bar0 + 8 * p, r);
        }
      } else {
        for (int r = 0; r < K; ++r) {
          cluster.map_shared_rank(vbuf, r)[p * SP + v] = val;
          if (lane == 0) cluster.map_shared_rank(pbuf, r)[p * NP + rank * PW + warp] = pm;
        }
      }
    }
    if (!SA) cluster.sync();
  }
  if (ta > 0) {
    const int p = (ta - 1) & 1;
    if (SA) wait_parity(bar0 + 8 * p, ((ta - 1) >> 1) & 1);
    const float* pp = pbuf + p * NP;
    m = pp[0];
    for (int i = 1; i < NP; ++i) m = fmaxf(m, pp[i]);
    acc = acc + m;
  }
  if (owner) {
    const float st = val - m;
    if (ta > 0) sc[((size_t)(ta - 1) * B + b) * SP + v] = st;
    fin[(size_t)b * SP + v] = ta > 0 ? st : 0.0f;
  }
  if (rank == 0 && x == 0) acc_out[b] = acc;
  cluster.sync();
}

template <int VC, bool SA>
int launch_slice(const float* obs, const int* tact, const float* trans, const float* start,
                 const float* mu, const float* sigma, const int* uni, const float* luni,
                 const float* lsig, float* sc, float* fin, float* acc, int B, int T, int SP,
                 int K, cudaStream_t stream) {
  auto kern = slice_kernel<VC, SA>;
  const size_t shmem = slice_floats(SP, VC) * sizeof(float);
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * K);
  cfg.blockDim = dim3(RES_THREADS);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kern, obs, tact, trans, start, mu, sigma, uni, luni, lsig, sc,
                         fin, acc, B, T, SP);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// VC = SP / K columns a CTA, 128 or 64; sa: st.async (1) or a cluster
// barrier (0) a step
extern "C" int probe_slice_launch(const void* obs, const void* tact, const void* trans,
                                  const void* start, const void* mu, const void* sigma,
                                  const void* uni, const void* luni, const void* lsig, void* sc,
                                  void* fin, void* acc, int B, int T, int SP, int K, int sa,
                                  void* stream) {
  if (K < 1 || SP % K) return (int)cudaErrorInvalidValue;
  const int VC = SP / K;
#define SLICE(vc, s)                                                                           \
  if (VC == vc && (sa != 0) == s)                                                              \
    return launch_slice<vc, s>((const float*)obs, (const int*)tact, (const float*)trans,       \
                               (const float*)start, (const float*)mu, (const float*)sigma,     \
                               (const int*)uni, (const float*)luni, (const float*)lsig,        \
                               (float*)sc, (float*)fin, (float*)acc, B, T, SP, K,              \
                               (cudaStream_t)stream);
  SLICE(128, false)
  SLICE(128, true)
  SLICE(64, false)
  SLICE(64, true)
#undef SLICE
  return (int)cudaErrorInvalidValue;
}
