// Viterbi backward walk that recomputes each visited backpointer.
//
// Replaces the Pallas TPU kernel strique_tpu/ops/viterbi_pallas.py
// `_bwd_batch_kernel` (called by `viterbi_backward_batch`).  From the
// final state, each step t (1 <= t < t_actual) picks
//   bp = min{ u : sc[t-1, u] + trans[u, path[t]] == max_u(...) },
// the first maximum, over the same f32 sums the forward maxed over;
// path[t] = last for t >= t_actual - 1 (the walk is frozen there).
//
// What bounds it on an H100: latency of the serial walk -- each step
// needs the previous step's state to pick its transT row.  The bytes
// (one 1 KB score row a step and read at SP 256) are far below the
// card's bandwidth.
//
// Design: one CTA of one warp per read; the step's chain waits on no
// score row, only on its transition row (an L1 hit, mostly):
//   * score rows: the walk visits sc[ta-2], ..., sc[0] whatever the path
//     is, so each lane copies its part of a row RING - 1 steps ahead
//     into a shared ring of RING rows by cp.async, one commit group a
//     step, and waits on the group of the current step
//     (cp.async.wait_group RING-2); it reads back only what it copied,
//     so no barrier is needed, and never a row at or past t_actual - 1;
//   * transition rows: the row of the state just chosen, read through
//     the read-only path (__ldg); a read's walk revisits a few states, so
//     its rows stay in the SM's L1 (transT of SP 256 is 256 KB);
//   * lane l holds the 4 NV states u = 4 NV l + j (NV = SP / 128 float4
//     reads); the max is one __reduce_max_sync on an order-preserving
//     int key of the lane's f32 max, converted back and compared >= in
//     f32 (-0.0 and +0.0 compare equal, so the key need not fold them);
//     the first index is the first lane holding a hit (a ballot) and its
//     first hit (one shuffle);
//   * path entries are held one a lane and stored 32 at a time.
// One read a CTA: the split path's 64 reads (the ultra routes' 8) leave
// SMs to spare, and each read has an SM's L1 to itself.
//
// Past SP 1024 (up to 8192) a read takes the wide variant
// (viterbi_bwd_wide_kernel<SPT>): one CTA a read of SP / SPT threads,
// SPT = WIDE_SPT states a thread (ops/viterbi_cuda.py BWD_WIDE_SPT).
// Thread x owns the float4s x + k * blockDim.x of a row, so a step's
// transT row is SPT / 4 coalesced float4 loads a thread, the ring's reads
// are conflict-free and a thread's first max is one pass over its
// candidates.  transT (5.3 MB at SP 1152, 268 MB at 8192) leaves L1, but
// a walk stays in a state for most steps (a state emits ~8 samples), so
// the row is reloaded only when the state moves.  The first max is keyed:
// the order key of a candidate with -0.0 folded onto +0.0 (`fkey`: equal
// keys are equal floats, so the largest key's holders are the twin's `>=
// max` hits), a warp's largest key by one redux.sync and the least state
// holding it by another; each warp publishes its pair, one barrier, and
// every warp folds the pairs the same way.  The ring is the narrow
// kernel's: each thread copies its own part of the score row RING_W - 1
// steps ahead by cp.async (RING_W = 16, 8 or 4 rows: SP up to 3072, 6144,
// 8192; at most 192 KB).  Fewer, wider threads make the step's barrier
// and exchange cheaper (tools/probe_viterbi_bwd_wide.py on an H100).
#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RING = 16;  // score rows in flight (a power of two)
constexpr unsigned FULL = 0xffffffffu;

// f32 -> int whose signed order is the float order (NaN never occurs)
__device__ __forceinline__ int order_key(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// 16-byte cp.async, issued only where `on` (no branch around it)
__device__ __forceinline__ void cp_async16_if(float4* dst, const float4* src, bool on) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.cg.shared.global [%0], [%1], 16;\n}\n" ::"r"(d),
      "l"(src), "r"((int)on));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// NV = SP / 128 float4 a lane
template <int NV>
__global__ void __launch_bounds__(32)
viterbi_bwd_kernel(const float* __restrict__ sc, const float* __restrict__ transT,
                   const int* __restrict__ last, const int* __restrict__ tact,
                   int32_t* __restrict__ path, int B, int T) {
  constexpr int SP = 128 * NV;
  constexpr int SP4 = SP / 4;
  constexpr int PER = 4 * NV;  // states a lane holds
  extern __shared__ float4 ring[];  // RING rows of sc
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float4* tT4 = reinterpret_cast<const float4*>(transT) + lane * NV;
  const int ta = min(tact[b], T);
  const int n = max(ta - 1, 0);  // steps: step i reads row n-1-i, writes path[n-1-i]
  const size_t rstride = (size_t)B * SP4;
  // this lane's float4s of read b's row of step i: row_src - i * rstride
  const float4* row_src = reinterpret_cast<const float4*>(sc) +
                          (size_t)max(n - 1, 0) * rstride + (size_t)b * SP4 + lane * NV;
  float4* my_ring = ring + lane * NV;  // slot j at my_ring[j * SP4 + k]
  // one group a step: rows of steps 0 .. RING-1
  for (int j = 0; j < RING; ++j) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      cp_async16_if(my_ring + j * SP4 + k, row_src - (size_t)j * rstride + k, j < n);
    cp_async_commit();
  }

  int32_t* prow = path + (size_t)b * T;
  int st = last[b];
  for (int t = n + lane; t < T; t += 32) prow[t] = st;
  int held = st;  // this lane's path entry of the current 32-step group
  for (int i = 0; i < n; ++i) {
    // step i's row: committed RING-1 steps ago (or in the prologue), and
    // at most RING-2 younger groups are in flight
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 2) : "memory");
    const float4* srow = my_ring + (i & (RING - 1)) * SP4;
    float4 sv[NV], tv[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) sv[k] = srow[k];
#pragma unroll
    for (int k = 0; k < NV; ++k) tv[k] = __ldg(tT4 + (size_t)st * SP4 + k);
    // refill the slot step i-1 read with the row of step i-1+RING (in
    // the loads' shadow; that slot's reads were consumed last step)
    const int ahead = i - 1 + RING;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      cp_async16_if(my_ring + ((i - 1) & (RING - 1)) * SP4 + k,
                    row_src - (size_t)ahead * rstride + k, i > 0 && ahead < n);
    cp_async_commit();
    float c[PER];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      c[4 * k + 0] = sv[k].x + tv[k].x;
      c[4 * k + 1] = sv[k].y + tv[k].y;
      c[4 * k + 2] = sv[k].z + tv[k].z;
      c[4 * k + 3] = sv[k].w + tv[k].w;
    }
    // the lane's max and, after the warp's, its first hit: trees, exact
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
    const int owner = __ffs(__ballot_sync(FULL, ft[0] < PER)) - 1;
    st = owner * PER + __shfl_sync(FULL, ft[0], owner);
    if ((i & 31) == lane) held = st;
    if ((i & 31) == 31) prow[n - 1 - (i - 31) - lane] = held;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  const int rem = n & 31;
  if (lane < rem) prow[rem - 1 - lane] = held;
}

// a candidate's order key with -0.0 folded onto +0.0: equal keys are
// equal floats (NaN never reaches the walk of a read whose path is kept)
__device__ __forceinline__ int fkey(float x) { return order_key(x + 0.0f); }

// What a probe reads of a wide walk (tools/probe_viterbi_bwd_wide.cu
// instantiates the kernel with a counting hook): the walk's start and
// end and a step's phases (mark 1: its candidates formed, the ring and
// the transT row waited on; 2: the warp's first max; 3: the cross-warp
// exchange).  The kernels built here take NoHook, whose calls vanish.
struct NoHook {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void finish(int) {}
};

constexpr int WIDE_SPT = 8;  // states a thread past SP 1024 (ops/viterbi_cuda.py BWD_WIDE_SPT)

// SPT states a thread (a multiple of 4), RING_W score rows in the ring
template <int SPT, int RING_W, class Hook>
__global__ void __launch_bounds__(1024)
viterbi_bwd_wide_kernel(const float* __restrict__ sc, const float* __restrict__ transT,
                        const int* __restrict__ last, const int* __restrict__ tact,
                        int32_t* __restrict__ path, int B, int T, int SP) {
  constexpr int NV = SPT / 4;       // float4 a thread
  extern __shared__ float4 ring[];  // RING_W rows of sc, slot j at ring[j * SP4]
  __shared__ int2 xch[2][32];       // each warp's (key, first state), by step parity
  const int SP4 = SP / 4;
  const int b = blockIdx.x;
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int n_warp = blockDim.x >> 5;
  int q[NV];  // this thread's float4s of a row
  bool live[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    q[k] = x + k * (int)blockDim.x;
    live[k] = q[k] < SP4;
  }
  const float4* tT4 = reinterpret_cast<const float4*>(transT);
  const int ta = min(tact[b], T);
  const int n = max(ta - 1, 0);  // steps: step i reads row n-1-i, writes path[n-1-i]
  const size_t rstride = (size_t)B * SP4;
  const float4* row_src =
      reinterpret_cast<const float4*>(sc) + (size_t)max(n - 1, 0) * rstride + (size_t)b * SP4;
  for (int j = 0; j < RING_W; ++j) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      cp_async16_if(ring + j * SP4 + q[k], row_src - (size_t)j * rstride + q[k],
                    live[k] && j < n);
    cp_async_commit();
  }

  int32_t* prow = path + (size_t)b * T;
  int st = last[b];
  if (warp == 0)
    for (int t = n + lane; t < T; t += 32) prow[t] = st;
  int held = st;
  // the transT row of state tst: a walk stays in a state for most steps
  // (52-79% of them on the VITERBI_WIDE cases), so only a move reloads it
  int tst = -1;
  float4 tv[NV];
  Hook hook;
  hook.start();
  for (int i = 0; i < n; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING_W - 2) : "memory");
    const int slot = i % RING_W;
    float4 sv[NV];
    if (st != tst) {  // uniform: every thread holds the same st
#pragma unroll
      for (int k = 0; k < NV; ++k)
        tv[k] = live[k] ? __ldg(tT4 + (size_t)st * SP4 + q[k]) : make_float4(0.f, 0.f, 0.f, 0.f);
      tst = st;
    }
#pragma unroll
    for (int k = 0; k < NV; ++k)
      sv[k] = live[k] ? ring[slot * SP4 + q[k]] : make_float4(0.f, 0.f, 0.f, 0.f);
    // refill the slot step i-1 read with the row of step i-1+RING_W (this
    // thread's own float4s, read last step)
    const int ahead = i - 1 + RING_W;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      cp_async16_if(ring + ((i + RING_W - 1) % RING_W) * SP4 + q[k],
                    row_src - (size_t)ahead * rstride + q[k], live[k] && i > 0 && ahead < n);
    cp_async_commit();
    // the thread's first max: a strict > over ascending states keeps the first
    int bk = INT_MIN, bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!live[k]) continue;
      const float c[4] = {sv[k].x + tv[k].x, sv[k].y + tv[k].y, sv[k].z + tv[k].z,
                          sv[k].w + tv[k].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = fkey(c[j]);
        if (key > bk) {
          bk = key;
          bi = 4 * q[k] + j;
        }
      }
    }
    hook.mark(1);
    const int wk = __reduce_max_sync(FULL, bk);
    const int wi = __reduce_min_sync(FULL, bk == wk ? bi : INT_MAX);
    hook.mark(2);
    const int p = i & 1;
    if (lane == 0) xch[p][warp] = make_int2(wk, wi);
    __syncthreads();
    const int2 e = lane < n_warp ? xch[p][lane] : make_int2(INT_MIN, INT_MAX);
    const int gk = __reduce_max_sync(FULL, e.x);
    st = __reduce_min_sync(FULL, e.x == gk ? e.y : INT_MAX);
    hook.mark(3);
    if ((i & 31) == lane) held = st;
    if (warp == 0 && (i & 31) == 31) prow[n - 1 - (i - 31) - lane] = held;
  }
  hook.finish(n);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  const int rem = n & 31;
  if (warp == 0 && lane < rem) prow[rem - 1 - lane] = held;
}

// the ring's rows at SP: 16, 8 or 4 (at most 192 KB)
constexpr int ring_rows(int SP) { return SP <= 3072 ? 16 : SP <= 6144 ? 8 : 4; }

template <int SPT, int RING_W, class Hook>
int launch_wide_ring(const void* sc, const void* transT, const void* last, const void* tact,
                     void* path, int B, int T, int SP, cudaStream_t stream) {
  auto kern = viterbi_bwd_wide_kernel<SPT, RING_W, Hook>;
  const size_t shmem = (size_t)RING_W * SP * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)shmem);
  if (e != cudaSuccess) return (int)e;
  const int threads = (SP / SPT + 31) / 32 * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  kern<<<B, threads, shmem, stream>>>((const float*)sc, (const float*)transT, (const int*)last,
                                      (const int*)tact, (int32_t*)path, B, T, SP);
  return (int)cudaGetLastError();
}

// SPT states a thread, the ring's rows by SP
template <int SPT, class Hook = NoHook>
int launch_wide(const void* sc, const void* transT, const void* last, const void* tact,
                void* path, int B, int T, int SP, cudaStream_t stream) {
  switch (ring_rows(SP)) {
    case 16: return launch_wide_ring<SPT, 16, Hook>(sc, transT, last, tact, path, B, T, SP, stream);
    case 8: return launch_wide_ring<SPT, 8, Hook>(sc, transT, last, tact, path, B, T, SP, stream);
    default: return launch_wide_ring<SPT, 4, Hook>(sc, transT, last, tact, path, B, T, SP, stream);
  }
}

// a shape the wide variant takes: SP a multiple of 128 in (1024, 8192]
bool wide_ok(int SP) { return SP % 128 == 0 && SP > 1024 && SP <= 8192; }

template <int NV>
int launch_nv(const void* sc, const void* transT, const void* last, const void* tact,
              void* path, int B, int T, cudaStream_t stream) {
  const size_t shmem = (size_t)RING * NV * 128 * sizeof(float);  // 64 KB at SP 1024
  cudaError_t e = cudaFuncSetAttribute(viterbi_bwd_kernel<NV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  viterbi_bwd_kernel<NV><<<B, 32, shmem, stream>>>(
      (const float*)sc, (const float*)transT, (const int*)last, (const int*)tact,
      (int32_t*)path, B, T);
  return (int)cudaGetLastError();
}

}  // namespace

// SP a multiple of 128 up to 1024.
extern "C" int viterbi_bwd_launch(const void* sc, const void* transT, const void* last,
                                  const void* tact, void* path, int B, int T, int SP,
                                  void* stream) {
  if (SP % 128 != 0 || SP > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (SP / 128) {
    case 1: return launch_nv<1>(sc, transT, last, tact, path, B, T, s);
    case 2: return launch_nv<2>(sc, transT, last, tact, path, B, T, s);
    case 3: return launch_nv<3>(sc, transT, last, tact, path, B, T, s);
    case 4: return launch_nv<4>(sc, transT, last, tact, path, B, T, s);
    case 5: return launch_nv<5>(sc, transT, last, tact, path, B, T, s);
    case 6: return launch_nv<6>(sc, transT, last, tact, path, B, T, s);
    case 7: return launch_nv<7>(sc, transT, last, tact, path, B, T, s);
    default: return launch_nv<8>(sc, transT, last, tact, path, B, T, s);
  }
}

// SP a multiple of 128 in (1024, 8192]: WIDE_SPT states a thread
extern "C" int viterbi_bwd_wide_launch(const void* sc, const void* transT, const void* last,
                                       const void* tact, void* path, int B, int T, int SP,
                                       void* stream) {
  if (!wide_ok(SP)) return (int)cudaErrorInvalidValue;
  return launch_wide<WIDE_SPT>(sc, transT, last, tact, path, B, T, SP, (cudaStream_t)stream);
}
