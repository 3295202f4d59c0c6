// The parent of tools/probe_viterbi_narrow.py's sweep, kept verbatim as
// the yardstick of the narrow factored forward that replaced it in the
// package: one CTA of SP threads a read, one state a thread, every warp
// taking the row max from the whole published row (NV float4 reads a
// lane).  Beside it, strique_tpu_torch/csrc/viterbi_fwd.cu's
// viterbi_fwd_kernel<NV, L, W> at every W the probe sweeps (S = 4 NV / W
// states a lane: 1, 2, 4, and 8 where it divides).  Both give the plain
// twin's bits.  Not part of the package; the probe builds one library a
// SP / 128 with nvcc, -DPROBE_NV=<SP / 128>.
#include <cuda_runtime.h>

#ifdef PROBE_HOOK
// -DPROBE_HOOK: the swept kernel's step phases (csrc/viterbi_fwd.cu
// FWD_HOOK's marks) in clock64 cycles summed over read 0's steps, by warp
// (lane 0 of each), then the steps counted
__device__ long long g_phase[32][9];
struct PhaseHook {
  long long last, acc[8], steps;
  __device__ __forceinline__ void start() {
    for (int i = 0; i < 8; ++i) acc[i] = 0;
    steps = 0;
    last = clock64();
  }
  __device__ __forceinline__ void mark(int i) {
    const long long now = clock64();
    acc[i] += now - last;
    last = now;
    steps += i == 7;
  }
  __device__ __forceinline__ void finish(int b) {
    if (b != 0 || (threadIdx.x & 31) != 0) return;
    for (int i = 0; i < 8; ++i) g_phase[threadIdx.x >> 5][i] = acc[i];
    g_phase[threadIdx.x >> 5][8] = steps;
  }
};
#define FWD_HOOK PhaseHook
#endif
#define VITERBI_FWD_KERNELS_ONLY
#include "../strique_tpu_torch/csrc/viterbi_fwd.cu"

#ifndef PROBE_NV
#error "build with -DPROBE_NV=<SP / 128>"
#endif

namespace {

// SP = 128 NV states, one thread each, every slot of layout L held in
// registers
template <int NV, class L>
__global__ void __launch_bounds__(128 * NV)
parent_fwd_kernel(const float* __restrict__ obs, const int* __restrict__ tact,
                   const float* __restrict__ start, const float* __restrict__ mu,
                   const float* __restrict__ sigma, const int* __restrict__ uni,
                   const float* __restrict__ luni, const float* __restrict__ lsig,
                   const int* __restrict__ src, const float* __restrict__ wts,
                   const float* __restrict__ ramp, int n_chain, float* __restrict__ sc,
                   float* __restrict__ fin, float* __restrict__ acc_out, int B, int T) {
  constexpr int SP = 128 * NV;
  constexpr int ROW = SP * 4;  // bytes of a row
  constexpr int DIAG_SLOTS = L::DIAG;
  constexpr int NC = L::CHAIN;
  constexpr int NCA = L::CHAIN_ARR;
  extern __shared__ __align__(16) float smem[];
  float* val_sh = smem;                     // 2 x SP: the rows, by step parity
  float* h_sh = val_sh + 2 * SP;            // NC x SP
  float* emit_sh = h_sh + NC * SP;          // OBS_CHUNK x SP: a column a thread
  __shared__ __align__(16) float wtot[NCA][32];
  __shared__ float obs_sh[2][OBS_CHUNK];

  const int b = blockIdx.x;
  const int v = threadIdx.x;
  const int lane = v & 31;
  const int warp = v >> 5;
  const int ta = min(tact[b], T);  // lengths past T would read past the row
  const float* x_row = obs + (size_t)b * T;

  // shared byte addresses of every gather: a row (parity 0) and the h rows
  const uint32_t val0 = (uint32_t)__cvta_generic_to_shared(val_sh);
  const uint32_t h0 = (uint32_t)__cvta_generic_to_shared(h_sh);
  uint32_t ad[DIAG_SLOTS], ae[NCA][ENTRY_SLOTS], ax[NCA][EXIT_SLOTS];
  float wd[DIAG_SLOTS], we[NCA][ENTRY_SLOTS], wx[NCA][EXIT_SLOTS], rp[NCA];
#pragma unroll
  for (int d = 0; d < DIAG_SLOTS; ++d) {
    ad[d] = val0 + 4 * src[d * SP + v];
    wd[d] = wts[d * SP + v];
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    rp[c] = ramp[c * SP + v];
    const int base = DIAG_SLOTS + c * CHAIN_SLOTS;
#pragma unroll
    for (int e = 0; e < ENTRY_SLOTS; ++e) {
      ae[c][e] = val0 + 4 * src[(base + e) * SP + v];
      we[c][e] = wts[(base + e) * SP + v];
    }
#pragma unroll
    for (int e = 0; e < EXIT_SLOTS; ++e) {
      ax[c][e] = h0 + c * ROW + 4 * src[(base + ENTRY_SLOTS + e) * SP + v];
      wx[c][e] = wts[(base + ENTRY_SLOTS + e) * SP + v];
    }
  }
  const float mu_v = mu[v], sig_v = sigma[v], luni_v = luni[v], lsig_v = lsig[v];
  const float start_v = start[v];
  const bool uni_v = uni[v] != 0;

  // obs chunk 0 now, chunk 1 in flight
  if (v < OBS_CHUNK) {
    if (v < ta) obs_sh[0][v] = x_row[v];
    if (OBS_CHUNK + v < ta) cp_async4(&obs_sh[1][v], x_row + OBS_CHUNK + v);
    cp_async_commit();
  }
  float fin_v = 0.0f, acc = 0.0f, m = 0.0f;
  float* sc_v = sc + (size_t)b * SP + v;  // row t at sc_v + t * B * SP
  const size_t sc_step = (size_t)B * SP;
  __syncthreads();

  // one step; parity P picks the row buffers at compile time
  auto step = [&](auto parity, int t) {
    constexpr int P = decltype(parity)::value;
    const int jc = t % OBS_CHUNK;
    if (P == 0 && jc == 0) {  // a chunk starts on an even step
      const int chunk = t / OBS_CHUNK;
      if (chunk > 0 && v < OBS_CHUNK) {
        // the buffer of chunk+1 last held chunk-1, read before the last barrier
        const int tn = (chunk + 1) * OBS_CHUNK + v;
        if (tn < ta) cp_async4(&obs_sh[(chunk + 1) & 1][v], x_row + tn);
        cp_async_commit();
      }
      const float* x_chunk = obs_sh[chunk & 1];
#pragma unroll 8
      for (int j = 0; j < OBS_CHUNK; ++j) {
        const float x = t + j < ta ? x_chunk[j] : mu_v;
        const float z = (x - mu_v) / sig_v;
        emit_sh[j * SP + v] = uni_v ? luni_v : (lsig_v - (0.5f * z) * z);
      }
    }
    const float emit = emit_sh[jc * SP + v];
    float val;
    if (P == 0 && t == 0) {
      val = start_v + emit;
    } else {
      constexpr int PREV = (P ^ 1) * ROW;  // the previous row: st = val - m
      float out = NEGF;
#pragma unroll
      for (int d = 0; d < DIAG_SLOTS; ++d) out = fmaxf(out, (lds<PREV>(ad[d]) - m) + wd[d]);
      if (NC > 0 && n_chain > 0) {
        float xs[NCA];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float inj = NEGF;
#pragma unroll
          for (int e = 0; e < ENTRY_SLOTS; ++e) inj = fmaxf(inj, (lds<PREV>(ae[c][e]) - m) + we[c][e]);
          xs[c] = inj - rp[c];
        }
        // inclusive scans; a lane below d gets its own value back
#pragma unroll
        for (int d = 1; d < 32; d <<= 1)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            xs[c] = fmaxf(xs[c], __shfl_up_sync(FULL, xs[c], d));
        if (lane == 31) {
#pragma unroll
          for (int c = 0; c < NC; ++c) wtot[c][warp] = xs[c];
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          // the totals of the warps below this one: NV broadcast float4 reads
          const float4* tot4 = reinterpret_cast<const float4*>(wtot[c]);
          float below = -INFINITY;
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const float4 q = tot4[k];
            below = fmaxf(below, fmaxf(fmaxf(4 * k < warp ? q.x : -INFINITY,
                                             4 * k + 1 < warp ? q.y : -INFINITY),
                                       fmaxf(4 * k + 2 < warp ? q.z : -INFINITY,
                                             4 * k + 3 < warp ? q.w : -INFINITY)));
          }
          h_sh[c * SP + v] = fmaxf(xs[c], below) + rp[c];
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < EXIT_SLOTS; ++e) out = fmaxf(out, lds<0>(ax[c][e]) + wx[c][e]);
      }
      val = out + emit;
    }
    val_sh[P * SP + v] = val;
    if (P == 1 && jc == OBS_CHUNK - 1 && v < OBS_CHUNK) cp_async_wait_all();  // chunk+1 lands
    __syncthreads();
    const float4* row4 = reinterpret_cast<const float4*>(val_sh + P * SP) + lane;
    float lm = -INFINITY;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const float4 q = row4[32 * k];
      lm = fmaxf(lm, fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w)));
    }
    m = warp_max(lm);
    const float stn = val - m;
    acc = acc + m;
    if (t == ta - 1) fin_v = stn;
    __stcs(sc_v, stn);
    sc_v += sc_step;
  };
  for (int t = 0; t < ta; t += 2) {
    step(std::integral_constant<int, 0>{}, t);
    if (t + 1 < ta) step(std::integral_constant<int, 1>{}, t + 1);
  }
  if (v < OBS_CHUNK) cp_async_wait_all();
  fin[(size_t)b * SP + v] = fin_v;
  if (v == 0) acc_out[b] = acc;
}

template <int NV, class L>
int parent_launch(const void* obs, const void* tact, const void* start, const void* mu,
                  const void* sigma, const void* uni, const void* luni, const void* lsig,
                  const void* src, const void* wts, const void* ramp, int n_chain, void* sc,
                  void* fin, void* acc, int B, int T, cudaStream_t stream) {
  constexpr int SP = 128 * NV;
  auto kernel = parent_fwd_kernel<NV, L>;
  const size_t shmem = (size_t)(2 + L::CHAIN + OBS_CHUNK) * SP * sizeof(float);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, SP, shmem, stream>>>(
      (const float*)obs, (const int*)tact, (const float*)start, (const float*)mu,
      (const float*)sigma, (const int*)uni, (const float*)luni, (const float*)lsig,
      (const int*)src, (const float*)wts, (const float*)ramp, n_chain, (float*)sc, (float*)fin,
      (float*)acc, B, T);
  return (int)cudaGetLastError();
}

template <int NV, class L, int W>
int swept_launch(const void* obs, const void* tact, const void* start, const void* mu,
                 const void* sigma, const void* uni, const void* luni, const void* lsig,
                 const void* src, const void* wts, const void* ramp, int n_chain, void* sc,
                 void* fin, void* acc, int B, int T, cudaStream_t stream) {
  constexpr int SP = 128 * NV;
  auto kernel = viterbi_fwd_kernel<NV, L, W>;
  const size_t shmem = narrow_shmem(SP, L::CHAIN);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, 32 * W, shmem, stream>>>(
      (const float*)obs, (const int*)tact, (const float*)start, (const float*)mu,
      (const float*)sigma, (const int*)uni, (const float*)luni, (const float*)lsig,
      (const int*)src, (const float*)wts, (const float*)ramp, n_chain, (float*)sc, (float*)fin,
      (float*)acc, B, T);
  return (int)cudaGetLastError();
}

// W = 0: the parent; else the swept kernel on W warps a read
template <class L>
int probe_launch(const void* obs, const void* tact, const void* start, const void* mu,
                 const void* sigma, const void* uni, const void* luni, const void* lsig,
                 const void* src, const void* wts, const void* ramp, const int* h, void* sc,
                 void* fin, void* acc, int B, int T, int SP, int W, cudaStream_t stream) {
  constexpr int NV = PROBE_NV;
  if (SP != 128 * NV || !counts_fit<L>(h)) return (int)cudaErrorInvalidValue;
  const int n_chain = h[1];
#define FWD_ARGS obs, tact, start, mu, sigma, uni, luni, lsig, src, wts, ramp, n_chain, sc, fin, \
                 acc, B, T, stream
  switch (W) {
    case 0: return parent_launch<NV, L>(FWD_ARGS);
    case 4 * NV: return swept_launch<NV, L, 4 * NV>(FWD_ARGS);
    case 2 * NV: return swept_launch<NV, L, 2 * NV>(FWD_ARGS);
    case NV: return swept_launch<NV, L, NV>(FWD_ARGS);
#if PROBE_NV % 2 == 0
    case NV / 2: return swept_launch<NV, L, NV / 2>(FWD_ARGS);
#endif
    default: return (int)cudaErrorInvalidValue;
  }
#undef FWD_ARGS
}

}  // namespace

// viterbi_fwd_launch's arguments, then W (0: the parent); SP must be
// 128 PROBE_NV
extern "C" int probe_fwd_launch(const void* obs, const void* tact, const void* start,
                                const void* mu, const void* sigma, const void* uni,
                                const void* luni, const void* lsig, const void* src,
                                const void* wts, const void* ramp, const void* counts, void* sc,
                                void* fin, void* acc, int B, int T, int SP, int layout, int W,
                                void* stream) {
  const int* h = (const int*)counts;
  cudaStream_t s = (cudaStream_t)stream;
  if (layout == 0)
    return probe_launch<Chained>(obs, tact, start, mu, sigma, uni, luni, lsig, src, wts, ramp, h,
                                 sc, fin, acc, B, T, SP, W, s);
  if (layout == 1)
    return probe_launch<DiagOnly>(obs, tact, start, mu, sigma, uni, luni, lsig, src, wts, ramp,
                                  h, sc, fin, acc, B, T, SP, W, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef PROBE_HOOK
// the last hooked launch's g_phase (32 x 9 int64) into host memory
extern "C" int probe_phase_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
#endif
