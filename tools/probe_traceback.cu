// Probe kernel for tools/probe_traceback.py: the walk of
// strique_tpu_torch/csrc/traceback.cu (its walk_row, included) with a
// hook that reads clock64 after every step and sums the cycles per row by
// what the step did:
//   fast     the next word was in the slot's window (the step chain alone)
//   group    entered the next word group (the slow road's request, wait,
//            __syncwarp and shuffle)
//   reload   left its window (a synchronous reload of the slot)
//   other    column 0, a chunk stored (the slow road)
// and the setup (kernel entry to the first step: the first requests, the
// fill, the wait for the first groups), and the walk in cycles and in
// globaltimer ns.  Its outputs are the shipped kernel's.  Not part of the
// package; built by the probe with nvcc.
#include "../strique_tpu_torch/csrc/traceback.cu"

namespace {

enum { SETUP, N_FAST, C_FAST, N_GROUP, C_GROUP, N_RELOAD, C_RELOAD, N_OTHER, C_OTHER, C_WALK,
       NS_WALK, N_STATS };

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct CountHook {
  long long* out;
  long long entry, prev, walk0, ns0;
  long long n0 = 0, c0 = 0, n1 = 0, c1 = 0, n2 = 0, c2 = 0, n3 = 0, c3 = 0;
  __device__ __forceinline__ void start() {
    prev = walk0 = clock64();
    ns0 = global_ns();
  }
  __device__ __forceinline__ void step(int kind) {
    const long long now = clock64(), d = now - prev;
    prev = now;
    if (kind == STEP_FAST) {
      ++n0;
      c0 += d;
    } else if (kind == STEP_GROUP) {
      ++n1;
      c1 += d;
    } else if (kind == STEP_RELOAD) {
      ++n2;
      c2 += d;
    } else {
      ++n3;
      c3 += d;
    }
  }
  __device__ __forceinline__ void finish() {
    const long long now = clock64(), ns = global_ns();
    if (threadIdx.x == 0) {
      const long long v[N_STATS] = {walk0 - entry, n0, c0, n1, c1, n2, c2, n3, c3, now - walk0,
                                    ns - ns0};
      for (int k = 0; k < N_STATS; ++k) out[k] = v[k];
    }
  }
};

template <bool COL>
__global__ void __launch_bounds__(32) probe_walk_kernel(
    const int32_t* __restrict__ ptr, const int* __restrict__ j_end,
    const int* __restrict__ m_start, uint8_t* __restrict__ is_gap, int32_t* __restrict__ jpos,
    int32_t* __restrict__ j_begin, long long* __restrict__ stats, int B, int MP, int m_out) {
  CountHook hook;
  hook.entry = clock64();
  hook.out = stats + (size_t)blockIdx.x * N_STATS;
  walk_row<COL>(ptr, j_end, m_start, is_gap, jpos, j_begin, B, MP, m_out, hook);
}

}  // namespace

// stats: (B, 11) int64 -- setup cycles; fast, group, reload and other
// steps, each a count and its cycles; the walk's cycles and ns
extern "C" int probe_walk_launch(const void* ptr, const void* j_end, const void* m_start,
                                 void* is_gap, void* jpos, void* j_begin, void* stats, int B,
                                 int MP, int m_out, int col, void* stream) {
  auto p = (const int32_t*)ptr;
  auto je = (const int*)j_end;
  auto ms = (const int*)m_start;
  auto st = (cudaStream_t)stream;
  if (col)
    probe_walk_kernel<true><<<B, 32, 0, st>>>(p, je, ms, (uint8_t*)is_gap, (int32_t*)jpos,
                                              (int32_t*)j_begin, (long long*)stats, B, MP, m_out);
  else
    probe_walk_kernel<false><<<B, 32, 0, st>>>(p, je, ms, (uint8_t*)is_gap, (int32_t*)jpos,
                                               (int32_t*)j_begin, (long long*)stats, B, MP,
                                               m_out);
  return (int)cudaGetLastError();
}
