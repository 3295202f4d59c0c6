// Probe build of strique_tpu_torch/csrc/viterbi_bwd.cu for
// tools/probe_viterbi_bwd_wide.py: the package's kernels and entry points,
// plus
//   * the parent of the wide backward (the first viterbi_bwd_wide_kernel,
//     kept here verbatim as parent_bwd_wide_kernel): ceil(SP / 1024) warps
//     of 1024 states, 32 a lane, two 32-wide trees and a serial scan of
//     the warp maxima a step;
//   * probe_bwd_wide_launch: the package's wide kernel at 4, 8 or 16
//     states a thread (the package takes WIDE_SPT), with or without the
//     hook;
//   * the LIST candidate the probe measured and the package does not ship
//     (probe_bwd_list_launch, viterbi_bwd_list_kernel): one warp a read
//     for an HMM each of whose states has at most LIST_MAX predecessors
//     above NEG (every mod HMM: at most 5), given as ascending (u,
//     transT[s, u]) lists.  A step gathers its state's listed candidates
//     from the ring (lane j the j-th), with no barrier and no transT row.
//     An unlisted candidate is sc[u] + w with w <= NEG, so by monotone
//     rounding it is at most fl(max_u sc[u] + NEG); the warp takes the
//     row's max from the ring off the step's chain.  Where the listed best
//     is strictly above that bound the first listed state holding it is
//     the twin's answer; elsewhere the step scans the whole row, one warp
//     over SP states.  Bit-equal to the twin, and slower than the wide
//     kernel at every shape the probe ran (PERF.md).
// The hook (ClockHook, thread 0 of each read's CTA) writes into the
// (B, 6) int64 buffer set by probe_bwd_hook_buffer: [0] the walk's
// clock64 cycles, [1] a step's candidates (the ring wait, the transT row
// or the list and its gather, the adds; the previous step's path store
// too), [2] the warp's first max (LIST: and the row max), [3] the
// cross-warp exchange (LIST: the dense scan, where taken), [4] LIST's
// scans, [5] the steps.  Not part of the package; built by the probe with
// nvcc.
#include "../strique_tpu_torch/csrc/viterbi_bwd.cu"

namespace {

constexpr int NCOL = 6;
__device__ long long* g_hook = nullptr;

constexpr int LIST_MAX = 8;  // listed predecessors a state (the probe's bwd_lists)
constexpr float NEGF = -1e30f;  // the pad and clamp of transT (ops/viterbi_cuda.py NEG)

__device__ __forceinline__ float max4(float4 v) { return fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)); }

// NoHook with LIST's scan count
struct ListNoHook : NoHook {
  __device__ __forceinline__ void scan() {}
};

struct ClockHook {
  long long t0 = 0, tm = 0, ph[4] = {0, 0, 0, 0}, scans = 0;
  __device__ __forceinline__ void start() { tm = t0 = clock64(); }
  __device__ __forceinline__ void mark(int k) {
    const long long now = clock64();
    ph[k] += now - tm;
    tm = now;
  }
  __device__ __forceinline__ void scan() { ++scans; }
  __device__ __forceinline__ void finish(int n) {
    if (threadIdx.x != 0) return;
    long long* o = g_hook + NCOL * (size_t)blockIdx.x;
    o[0] = clock64() - t0;
    o[1] = ph[1];
    o[2] = ph[2];
    o[3] = ph[3];
    o[4] = scans;
    o[5] = n;
  }
};

// SP up to 8192: blockDim.x / 32 = ceil(SP / 1024) warps of 1024 states
template <int RING_W>
__global__ void __launch_bounds__(256)
parent_bwd_wide_kernel(const float* __restrict__ sc, const float* __restrict__ transT,
                        const int* __restrict__ last, const int* __restrict__ tact,
                        int32_t* __restrict__ path, int B, int T, int SP) {
  constexpr int NV = 8;        // float4 a lane
  constexpr int PER = 4 * NV;  // states a lane holds
  extern __shared__ float4 ring[];  // RING_W rows of sc
  __shared__ float wmx[2][8];       // each warp's max and first hit, by step parity
  __shared__ int wix[2][8];
  const int SP4 = SP / 4;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warp = blockDim.x >> 5;
  const int u0 = warp * 32 * PER + lane * PER;  // this lane's first state
  const bool live = u0 < SP;  // SP is a multiple of PER: all PER states or none
  const float4* tT4 = reinterpret_cast<const float4*>(transT) + u0 / 4;
  const int ta = min(tact[b], T);
  const int n = max(ta - 1, 0);  // steps: step i reads row n-1-i, writes path[n-1-i]
  const size_t rstride = (size_t)B * SP4;
  const float4* row_src = reinterpret_cast<const float4*>(sc) +
                          (size_t)max(n - 1, 0) * rstride + (size_t)b * SP4 + u0 / 4;
  float4* my_ring = ring + u0 / 4;  // slot j at my_ring[j * SP4 + k]
  for (int j = 0; j < RING_W; ++j) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      cp_async16_if(my_ring + j * SP4 + k, row_src - (size_t)j * rstride + k, live && j < n);
    cp_async_commit();
  }

  int32_t* prow = path + (size_t)b * T;
  int st = last[b];
  if (warp == 0)
    for (int t = n + lane; t < T; t += 32) prow[t] = st;
  int held = st;
  for (int i = 0; i < n; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING_W - 2) : "memory");
    const float4* srow = my_ring + (i & (RING_W - 1)) * SP4;
    float c[PER];
    if (live) {
      float4 sv[NV], tv[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) sv[k] = srow[k];
#pragma unroll
      for (int k = 0; k < NV; ++k) tv[k] = __ldg(tT4 + (size_t)st * SP4 + k);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        c[4 * k + 0] = sv[k].x + tv[k].x;
        c[4 * k + 1] = sv[k].y + tv[k].y;
        c[4 * k + 2] = sv[k].z + tv[k].z;
        c[4 * k + 3] = sv[k].w + tv[k].w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < PER; ++j) c[j] = -INFINITY;
    }
    const int ahead = i - 1 + RING_W;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      cp_async16_if(my_ring + ((i - 1) & (RING_W - 1)) * SP4 + k,
                    row_src - (size_t)ahead * rstride + k, live && i > 0 && ahead < n);
    cp_async_commit();
    float mt[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) mt[j] = c[j];
#pragma unroll
    for (int w = 1; w < PER; w <<= 1)
#pragma unroll
      for (int j = 0; j + w < PER; j += 2 * w) mt[j] = fmaxf(mt[j], mt[j + w]);
    const float mx = key_value(__reduce_max_sync(FULL, order_key(mt[0])));
    int ft[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) ft[j] = c[j] >= mx ? j : PER;
#pragma unroll
    for (int w = 1; w < PER; w <<= 1)
#pragma unroll
      for (int j = 0; j + w < PER; j += 2 * w) ft[j] = min(ft[j], ft[j + w]);
    // every warp holds a live lane, so its maximum is finite and hit
    const int owner = __ffs(__ballot_sync(FULL, ft[0] < PER)) - 1;
    const int first = warp * 32 * PER + owner * PER + __shfl_sync(FULL, ft[0], owner);
    const int p = i & 1;
    if (lane == 0) {
      wmx[p][warp] = mx;
      wix[p][warp] = first;
    }
    __syncthreads();
    float gm = wmx[p][0];
    for (int w = 1; w < n_warp; ++w) gm = fmaxf(gm, wmx[p][w]);
    int w = 0;
    while (!(wmx[p][w] >= gm)) ++w;
    st = wix[p][w];
    if ((i & 31) == lane) held = st;
    if (warp == 0 && (i & 31) == 31) prow[n - 1 - (i - 31) - lane] = held;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  const int rem = n & 31;
  if (warp == 0 && lane < rem) prow[rem - 1 - lane] = held;
}

template <int RING_W>
int parent_launch(const void* sc, const void* transT, const void* last, const void* tact,
                void* path, int B, int T, int SP, cudaStream_t stream) {
  const size_t shmem = (size_t)RING_W * SP * sizeof(float);  // 128 KB at SP 8192
  cudaError_t e = cudaFuncSetAttribute(parent_bwd_wide_kernel<RING_W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  const int warps = (SP + 1023) / 1024;
  parent_bwd_wide_kernel<RING_W><<<B, 32 * warps, shmem, stream>>>(
      (const float*)sc, (const float*)transT, (const int*)last, (const int*)tact,
      (int32_t*)path, B, T, SP);
  return (int)cudaGetLastError();
}

// LIST: one warp a read; pu, pw (SP, LIST_MAX) each state's listed
// predecessors and their transitions, ascending, -1 past the list
template <int RING_W, class Hook>
__global__ void __launch_bounds__(32)
viterbi_bwd_list_kernel(const float* __restrict__ sc, const float* __restrict__ transT,
                        const int* __restrict__ pu, const float* __restrict__ pw,
                        const int* __restrict__ last, const int* __restrict__ tact,
                        int32_t* __restrict__ path, int B, int T, int SP) {
  extern __shared__ float4 ring[];  // RING_W rows of sc, slot j at ring[j * SP4]
  const float* ringf = reinterpret_cast<const float*>(ring);
  const int SP4 = SP / 4;
  const int NQ = SP4 / 32;  // float4s a lane: lane + 32 k
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float4* tT4 = reinterpret_cast<const float4*>(transT) + lane;
  const int ta = min(tact[b], T);
  const int n = max(ta - 1, 0);
  const size_t rstride = (size_t)B * SP4;
  const float4* row_src = reinterpret_cast<const float4*>(sc) +
                          (size_t)max(n - 1, 0) * rstride + (size_t)b * SP4 + lane;
  float4* my_ring = ring + lane;
  for (int j = 0; j < RING_W; ++j) {
    for (int k = 0; k < NQ; ++k)
      cp_async16_if(my_ring + j * SP4 + 32 * k, row_src - (size_t)j * rstride + 32 * k, j < n);
    cp_async_commit();
  }

  int32_t* prow = path + (size_t)b * T;
  int st = last[b];
  for (int t = n + lane; t < T; t += 32) prow[t] = st;
  int held = st;
  int lst = -1, u = -1;  // the list of state lst (reloaded only on a move)
  float w = 0.0f;
  Hook hook;
  hook.start();
  for (int i = 0; i < n; ++i) {
    if (st != lst) {  // the list's loads in flight first
      u = lane < LIST_MAX ? __ldg(pu + (size_t)st * LIST_MAX + lane) : -1;
      w = lane < LIST_MAX ? __ldg(pw + (size_t)st * LIST_MAX + lane) : 0.0f;
      lst = st;
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING_W - 2) : "memory");
    __syncwarp();  // every lane's part of this step's row, and last step's reads done
    const int slot = i % RING_W;
    const float4* srow = my_ring + slot * SP4;
    // the row's max, which bounds every unlisted candidate (off the chain)
    float r0 = -INFINITY, r1 = -INFINITY, r2 = -INFINITY, r3 = -INFINITY;
    int k = 0;
    for (; k + 4 <= NQ; k += 4) {  // four loads in flight, four chains
      r0 = fmaxf(r0, max4(srow[32 * k]));
      r1 = fmaxf(r1, max4(srow[32 * (k + 1)]));
      r2 = fmaxf(r2, max4(srow[32 * (k + 2)]));
      r3 = fmaxf(r3, max4(srow[32 * (k + 3)]));
    }
    for (; k < NQ; ++k) r0 = fmaxf(r0, max4(srow[32 * k]));
    const float rm = fmaxf(fmaxf(r0, r1), fmaxf(r2, r3));
    const int ahead = i - 1 + RING_W;
#pragma unroll 4
    for (int k = 0; k < NQ; ++k)
      cp_async16_if(my_ring + ((i + RING_W - 1) % RING_W) * SP4 + 32 * k,
                    row_src - (size_t)ahead * rstride + 32 * k, i > 0 && ahead < n);
    cp_async_commit();
    const int key = u >= 0 ? fkey(ringf[slot * SP + u] + w) : INT_MIN;
    hook.mark(1);
    const int lk = __reduce_max_sync(FULL, key);
    const float rmax = key_value(__reduce_max_sync(FULL, order_key(rm)));
    hook.mark(2);
    if (lk > fkey(rmax + NEGF)) {
      st = __reduce_min_sync(FULL, key == lk ? u : INT_MAX);
    } else {  // the dense scan: lane + 32 k's float4s against st's transT row
      hook.scan();
      int bk = INT_MIN, bi = INT_MAX;
      for (int k = 0; k < NQ; ++k) {
        const float4 sv = srow[32 * k];
        const float4 tv = __ldg(tT4 + (size_t)st * SP4 + 32 * k);
        const float c[4] = {sv.x + tv.x, sv.y + tv.y, sv.z + tv.z, sv.w + tv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = fkey(c[j]);
          if (kj > bk) {
            bk = kj;
            bi = 4 * (lane + 32 * k) + j;
          }
        }
      }
      const int wk = __reduce_max_sync(FULL, bk);
      st = __reduce_min_sync(FULL, bk == wk ? bi : INT_MAX);
    }
    hook.mark(3);
    if ((i & 31) == lane) held = st;
    if ((i & 31) == 31) prow[n - 1 - (i - 31) - lane] = held;
  }
  hook.finish(n);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  const int rem = n & 31;
  if (lane < rem) prow[rem - 1 - lane] = held;
}


template <int RING_W, class Hook>
int launch_list_ring(const void* sc, const void* transT, const void* pu, const void* pw,
                     const void* last, const void* tact, void* path, int B, int T, int SP,
                     cudaStream_t stream) {
  auto kern = viterbi_bwd_list_kernel<RING_W, Hook>;
  const size_t shmem = (size_t)RING_W * SP * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)shmem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B, 32, shmem, stream>>>((const float*)sc, (const float*)transT, (const int*)pu,
                                 (const float*)pw, (const int*)last, (const int*)tact,
                                 (int32_t*)path, B, T, SP);
  return (int)cudaGetLastError();
}

template <class Hook>
int launch_list(const void* sc, const void* transT, const void* pu, const void* pw,
                const void* last, const void* tact, void* path, int B, int T, int SP,
                cudaStream_t stream) {
  switch (ring_rows(SP)) {
    case 16:
      return launch_list_ring<16, Hook>(sc, transT, pu, pw, last, tact, path, B, T, SP, stream);
    case 8:
      return launch_list_ring<8, Hook>(sc, transT, pu, pw, last, tact, path, B, T, SP, stream);
    default:
      return launch_list_ring<4, Hook>(sc, transT, pu, pw, last, tact, path, B, T, SP, stream);
  }
}

}  // namespace

extern "C" int probe_bwd_hook_buffer(void* p) {
  return (int)cudaMemcpyToSymbol(g_hook, &p, sizeof(p));
}

// the parent: SP a multiple of 128 in (1024, 8192]
extern "C" int parent_bwd_wide_launch(const void* sc, const void* transT, const void* last,
                                      const void* tact, void* path, int B, int T, int SP,
                                      void* stream) {
  if (!wide_ok(SP)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (SP <= 3072) return parent_launch<16>(sc, transT, last, tact, path, B, T, SP, s);
  if (SP <= 6144) return parent_launch<8>(sc, transT, last, tact, path, B, T, SP, s);
  return parent_launch<4>(sc, transT, last, tact, path, B, T, SP, s);
}

// the wide kernel at spt (4, 8 or 16) states a thread; hook != 0: the
// clock hook
extern "C" int probe_bwd_wide_launch(const void* sc, const void* transT, const void* last,
                                     const void* tact, void* path, int B, int T, int SP,
                                     int spt, int hook, void* stream) {
  if (!wide_ok(SP)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PROBE_WIDE(SPT)                                                              \
  (hook ? launch_wide<SPT, ClockHook>(sc, transT, last, tact, path, B, T, SP, s)     \
        : launch_wide<SPT, NoHook>(sc, transT, last, tact, path, B, T, SP, s))
  switch (spt) {
    case 4: return PROBE_WIDE(4);
    case 8: return PROBE_WIDE(8);
    case 16: return PROBE_WIDE(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PROBE_WIDE
}

extern "C" int probe_bwd_list_launch(const void* sc, const void* transT, const void* pu,
                                     const void* pw, const void* last, const void* tact,
                                     void* path, int B, int T, int SP, int hook, void* stream) {
  if (!wide_ok(SP)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return hook ? launch_list<ClockHook>(sc, transT, pu, pw, last, tact, path, B, T, SP, s)
              : launch_list<ListNoHook>(sc, transT, pu, pw, last, tact, path, B, T, SP, s);
}
