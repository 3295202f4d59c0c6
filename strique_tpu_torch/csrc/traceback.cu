// Traceback of the wave kernel's diagonal-major pointer plane, and of the
// column kernel's column-major one.
//
// Replaces the XLA while_loop traceback of strique_tpu/ops/align.py
// `traceback_pointers` (align.py:198-237) in both layouts the port's
// kernels write: packed='diag' (the wave kernel) and packed=True (the
// column kernel).  The TPU path runs it vmapped over the rows of each
// forward call (not a Pallas kernel, but on the device side all the
// same).
//
// What bounds it on an H100: latency.  A walk is a chain of dependent
// 4-byte loads, one per step (about m + the template's signal span, ~2k
// steps for a 870-sample flank), each a scattered read of the ~0.7 GB
// plane that mostly misses L1 and often L2; bytes and arithmetic are
// negligible.
//
// Design: one thread walks one row, with the reference's step rule
// exactly -- M > V > H codes in bits 0-1, Ih-extend in bit 2, V-extend in
// bit 3, column 0 reads as "V, extend".  The layouts differ in two places:
//   diag  cell (i, j) at word [(i+j-1)/8, row, i], nibble (i+j-1)%8; the
//         V-extend bit sits at its source cell, so the walk reads it from
//         the cell it steps to;
//   col   cell (i, j) at word [(j-1)/8, row, i-1], nibble (j-1)%8; the
//         V-extend bit is read from the current cell.  Row 0's lane i-1
//         is -1, which the reference's index wraps to MP-1: the walk
//         reads that lane too (in bounds), and never uses the byte, as
//         the walk ends at i = 0.
// Each thread first zeroes its row's outputs, so entries past a per-row
// template length read 0 as in the reference.  Rows are independent, so
// 64 rows run as 64 concurrent chains; the walk is short next to the
// forward.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool COL>
__device__ __forceinline__ int lookup(const int32_t* __restrict__ ptr, int B, int MP,
                                      int row, int jc, int ic) {
  if (jc <= 0) return 2 | 8;  // column 0: vertical, extending
  const int t = COL ? jc - 1 : ic + jc - 1;
  const int lane = COL ? (ic > 0 ? ic - 1 : MP - 1) : ic;
  const int32_t word = ptr[((size_t)(t >> 3) * B + row) * MP + lane];
  return (word >> (4 * (t & 7))) & 15;
}

template <bool COL>
__global__ void traceback_kernel(const int32_t* __restrict__ ptr, const int* __restrict__ j_end,
                                 const int* __restrict__ m_start, uint8_t* __restrict__ is_gap,
                                 int32_t* __restrict__ jpos, int32_t* __restrict__ j_begin,
                                 int B, int MP, int m_out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  uint8_t* gap_row = is_gap + (size_t)row * m_out;
  int32_t* pos_row = jpos + (size_t)row * m_out;
  int j = j_end[row];
  const uint8_t gap0 = j < 0 ? 1 : 0;
  for (int k = 0; k < m_out; ++k) {
    gap_row[k] = gap0;
    pos_row[k] = 0;
  }
  int i = m_start[row];
  int byte = lookup<COL>(ptr, B, MP, row, j, i);
  int cur = byte & 3;
  while (i > 0) {
    const bool is_m = cur == 0, is_h = cur == 1, is_v = cur == 2;
    if ((is_m || is_v) && i - 1 < m_out) {  // template element i-1 consumed
      gap_row[i - 1] = is_v ? 1 : 0;
      pos_row[i - 1] = j - 1;
    }
    const int ni = is_h ? i : i - 1;
    const int nj = is_v ? j : j - 1;
    const int nbyte = lookup<COL>(ptr, B, MP, row, nj, ni);
    const int ext = is_h ? (byte >> 2) & 1 : ((COL ? byte : nbyte) >> 3) & 1;
    const bool stay = !is_m && ext == 1;
    cur = stay ? cur : (ni > 0 ? (nbyte & 3) : 0);
    i = ni;
    j = nj;
    byte = nbyte;
  }
  j_begin[row] = j;
}

}  // namespace

// col = 0: the diagonal layout; col = 1: the column layout
extern "C" int traceback_launch(const void* ptr, const void* j_end, const void* m_start,
                                void* is_gap, void* jpos, void* j_begin,
                                int B, int MP, int m_out, int col, void* stream) {
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  auto p = (const int32_t*)ptr;
  auto je = (const int*)j_end;
  auto ms = (const int*)m_start;
  auto st = (cudaStream_t)stream;
  if (col)
    traceback_kernel<true><<<blocks, threads, 0, st>>>(p, je, ms, (uint8_t*)is_gap,
                                                       (int32_t*)jpos, (int32_t*)j_begin, B, MP,
                                                       m_out);
  else
    traceback_kernel<false><<<blocks, threads, 0, st>>>(p, je, ms, (uint8_t*)is_gap,
                                                        (int32_t*)jpos, (int32_t*)j_begin, B,
                                                        MP, m_out);
  return (int)cudaGetLastError();
}
