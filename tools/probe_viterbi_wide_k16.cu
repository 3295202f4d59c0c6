// The dense forward's SLICE and STREAMED modes on a non-portable cluster
// of 16 CTAs a read, for tools/probe_viterbi_wide.py: the package's
// kernel (csrc/viterbi_dense.cu, included whole), launched past the
// portable 8 CTAs that its own entry takes.  Not part of the package;
// built by the probe with nvcc beside tools/probe_viterbi_wide.cu.
#include "../strique_tpu_torch/csrc/viterbi_dense.cu"

// viterbi_dense_stream_launch's arguments, K fixed at 16
extern "C" int probe_dense_stream16_launch(const void* obs, const void* tact, const void* trans,
                                           const void* start, const void* mu,
                                           const void* sigma, const void* uni,
                                           const void* luni, const void* lsig, void* sc,
                                           void* fin, void* acc, int B, int T, int SP,
                                           int slice, void* stream) {
  constexpr int K = 16;
  if (SP <= 0 || SP % 128 || SP > MAX_SP || SP % (4 * K) || SP / K > MAX_THREADS ||
      (slice && stream_shmem(SP, K, true) > MAX_SHMEM))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      slice ? (const void*)viterbi_dense_cluster_kernel<true>
            : (const void*)viterbi_dense_cluster_kernel<false>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
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
