// Probe build of strique_tpu_torch/csrc/wave_align.cu for
// tools/probe_wave_cluster.py: the same kernels and C entry points, the
// cluster instances with a hook that writes, for every CTA of a row,
//   [0] the step loop's clock64 cycles (thread 0),
//   [1] cycles thread 0 waited for the CTA ring's slot to fill (CTAs 1..K-1),
//   [2] cycles the CTA's last thread waited for a CTA ring slot to empty
//       (CTAs 0..K-2),
//   [3] the 8-step groups the CTA ran,
//   [4] cycles warp 1's first thread waited for its warp ring to fill,
//   [5] cycles warp 0's last thread waited for warp 1's ring to empty,
//   [6..9] warp 1's first thread's cycles in a group's phases: from the
//       last group's steps to the group's start (the group-end ring
//       work), reading its scores, its ring waits, its 8 steps,
//   [10..13] the same of warp 0 (the CTA ring's receiver),
//   [14..17] the same of the last warp (the CTA ring's sender),
// into the (B x K, 18) int64 buffer set by probe_ring_buffer.  While a
// warp's first thread waits, its warp waits, so [1] / [0] is the share of
// the step a CTA boundary's wait takes, [4] / [0] a warp boundary's.  Not
// part of the package; built by the probe with nvcc.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NCOL = 18;
__device__ long long* g_ring = nullptr;

struct RingHook {
  long long t0 = 0, tw = 0, tm = 0, wait[4] = {0, 0, 0, 0}, phase[4] = {0, 0, 0, 0};
  __device__ __forceinline__ void start() { tm = t0 = clock64(); }
  __device__ __forceinline__ void mark(int k) {
    const long long now = clock64();
    phase[k] += now - tm;
    tm = now;
  }
  __device__ __forceinline__ void wait_begin() { tw = clock64(); }
  __device__ __forceinline__ void wait_end(int which) { wait[which] += clock64() - tw; }
  __device__ __forceinline__ void finish(int groups) {
    long long* o = g_ring + NCOL * (size_t)blockIdx.x;
    if (threadIdx.x == 0) {
      o[0] = clock64() - t0;
      o[1] = wait[0];
      o[3] = groups;
    }
    if (threadIdx.x == blockDim.x - 1) o[2] = wait[1];
    if (threadIdx.x == 32) {
      o[4] = wait[2];
      for (int k = 0; k < 4; ++k) o[6 + k] = phase[k];
    }
    if (threadIdx.x == 0)
      for (int k = 0; k < 4; ++k) o[10 + k] = phase[k];
    if (threadIdx.x == blockDim.x - 32)
      for (int k = 0; k < 4; ++k) o[14 + k] = phase[k];
    if (threadIdx.x == 31) o[5] = wait[3];
  }
};

}  // namespace

#define WAVE_HOOK RingHook
#include "../strique_tpu_torch/csrc/wave_align.cu"

extern "C" int probe_ring_buffer(void* p) {
  return (int)cudaMemcpyToSymbol(g_ring, &p, sizeof(p));
}
