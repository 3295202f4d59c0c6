// Traceback of the wave kernel's diagonal-major pointer plane, and of the
// column kernel's column-major one.
//
// Replaces the XLA while_loop traceback of strique_tpu/ops/align.py
// `traceback_pointers` (the while_loop at align.py:235) in both layouts
// the port's kernels write: packed='diag' (the wave kernel) and
// packed=True (the column kernel).  The TPU path runs it vmapped over the
// rows of each forward call (not a Pallas kernel, but on the device side
// all the same).
//
// The step rule is the reference's, exactly: M > V > H codes in bits 0-1,
// Ih-extend in bit 2, V-extend in bit 3, column 0 reads as "V, extend".
// The layouts differ in two places:
//   diag  cell (i, j) at word [(i+j-1)/8, row, i], nibble (i+j-1)%8; the
//         V-extend bit sits at its source cell, so the walk reads it from
//         the cell it steps to;
//   col   cell (i, j) at word [(j-1)/8, row, i-1], nibble (j-1)%8; the
//         V-extend bit is read from the current cell.  Row 0's lane is
//         -1, which the reference wraps to MP-1; the walk ends on reaching
//         row 0 and never uses that cell's code, so it is not read.
//
// What bounds it on an H100: latency.  A walk is a chain of ~m + (j_end -
// j_begin) - (diagonal moves) dependent steps (~870-1300 at the bench
// shapes), each picking the next cell from the current cell's code; bytes
// and arithmetic are negligible (the byte bound is ~200x below the walk's
// time).  Read straight from the plane, each step waits on a global load,
// and a walk enters a new 8-step word group every 4-8 steps, B x MP x 4
// bytes (458 KB at the bench shape) from the last: a fresh L2 miss.
//
// Design: one warp walks one row (one warp a block, so the rows spread
// over the SMs), every lane redundantly, from a ring in shared memory.
//   * The ring holds RING word groups: the current one and the next
//     RING-1 the walk will enter, each as a window of WIN lanes ending at
//     the walk's lane when the group was requested.  Entering a group,
//     the warp requests the group RING-1 further on by cp.async (4 words
//     a lane, coalesced) into the slot it just left and waits for the
//     group after the one it entered (cp.async.wait_group RING-2), so the
//     loads of ~15 groups (60-120 steps) are in flight behind the walk
//     and the step that enters a group never waits.  In the diagonal
//     layout a step lowers t by 1 or 2 and the lane by at most 1 per
//     diagonal, so k groups on the walk needs lanes in [L - 8k - 7, L]:
//     windows of 128 lanes hold every word of 15 groups ahead.  In the
//     column layout a V run lowers the lane without leaving the group; a
//     lane outside the window reloads the current slot ending at that
//     lane (a stall, never another answer).
//   * The step chain: a step moves the word index w in the ring by 0 or
//     -1 and t by 0, 1 or 2, so the next word is read from shared memory
//     (a broadcast, 32-bit shared addresses) as soon as the code is known,
//     before the checks that it stayed in its slot's window and that no
//     output chunk closes; the ring has a word in front of it, so the
//     read is in bounds either way.  Everything else (a group entered, a
//     window left, a chunk stored, column 0, the end) is one branch off
//     the chain.  (tools/probe_traceback.py sums the cycles of each
//     kind of step through the walk's Hook.)
//   * Outputs: element i-1 is written on every M or V step, in descending
//     i, so lane k keeps the entry of the 32-element chunk it owns and the
//     warp stores a chunk (32 bytes of gaps, 128 of positions) when the
//     walk passes its lowest element; entries the walk does not write (at
//     or past m_start, or a code-3 step's) keep the initial values, and
//     chunks past m_start's are filled coalesced before the walk starts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RING = 16;  // word groups held (a power of two)
constexpr int WIN = 128;  // lanes of a group's window: 4 words a thread
constexpr int RING_WORDS = RING * WIN;
constexpr unsigned FULL = 0xffffffffu;

// what a step of the walk did (for a probe's hook)
enum StepKind { STEP_FAST, STEP_GROUP, STEP_RELOAD, STEP_OTHER };

struct NoHook {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void step(int) {}
  __device__ __forceinline__ void finish() {}
};

// 4-byte cp.async to a shared address, issued only where `on`
__device__ __forceinline__ void cp_async4_if(unsigned dst, const int32_t* src, bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n" ::"r"(dst),
      "l"(src), "r"((int)on));
}

__device__ __forceinline__ int ld_shared(unsigned addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared(unsigned addr, int v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// one warp walks row blockIdx.x
template <bool COL, class Hook>
__device__ __forceinline__ void walk_row(const int32_t* __restrict__ ptr,
                                         const int* __restrict__ j_end,
                                         const int* __restrict__ m_start,
                                         uint8_t* __restrict__ is_gap,
                                         int32_t* __restrict__ jpos,
                                         int32_t* __restrict__ j_begin, int B, int MP,
                                         int m_out, Hook& hook) {
  __shared__ int32_t ring_mem[RING_WORDS + 1];  // a word in front: w - 1 stays inside
  const unsigned ring = (unsigned)__cvta_generic_to_shared(ring_mem + 1);
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t gstride = (size_t)B * MP;  // words from one group to the next
  const int32_t* base = ptr + (size_t)row * MP;
  uint8_t* gap_row = is_gap + (size_t)row * m_out;
  int32_t* pos_row = jpos + (size_t)row * m_out;

  int i = m_start[row];
  int j = j_end[row];
  const int gap0 = j < 0 ? 1 : 0;

  // group g's lanes [lo, lo + WIN), lo from the walk's lane L, into slot
  // g % RING as one commit group (empty for a group before the plane);
  // lane (g % RING) keeps lo
  int my_lo = 0;
  auto request = [&](int g, int L) {
    const int lo = max(0, L - (WIN - 1));
    const int32_t* src = base + (size_t)max(g, 0) * gstride + lo + lane;
    const unsigned dst = ring + 4u * ((g & (RING - 1)) * WIN + lane);
#pragma unroll
    for (int q = 0; q < WIN / 32; ++q)
      cp_async4_if(dst + 128u * q, src + 32 * q, g >= 0 && lo + lane + 32 * q < MP);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (lane == (g & (RING - 1))) my_lo = lo;
  };

  // the walk's group, its slot's first word and its window's first lane,
  // the next group's window's first lane; the current cell's t and the
  // ring index w of its word (a cell of the plane)
  int g_cur = 0, slot = 0, lo_cur = 0, lo_next = 0, t = 0, w = 0;
  const bool reads = i > 0 && j > 0;  // else every code the walk uses is column 0's
  if (reads) {
    g_cur = (COL ? j - 1 : i + j - 1) >> 3;
    for (int k = 0; k < RING; ++k) request(g_cur - k, COL ? i - 1 : i);
  }
  // entries of the chunks past m_start's, while the first groups load
  for (int e = (i + 31) / 32 * 32 + lane; e < m_out; e += 32) {
    gap_row[e] = (uint8_t)gap0;
    pos_row[e] = 0;
  }
  if (reads) {  // the first two groups in
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 2) : "memory");
    __syncwarp();
    slot = (g_cur & (RING - 1)) * WIN;
    lo_cur = __shfl_sync(FULL, my_lo, g_cur & (RING - 1));
    lo_next = __shfl_sync(FULL, my_lo, (g_cur - 1) & (RING - 1));
  }

  // a cell's code by the slow road: column 0; entering the next group
  // (its window was complete one group ago), then requesting the group
  // RING-1 past it and waiting for the one after it; leaving the window
  int kind = STEP_OTHER;
  auto lookup = [&](int jc, int ic) -> int {
    if (jc <= 0) return 2 | 8;  // column 0: vertical, extending
    const int tc = COL ? jc - 1 : ic + jc - 1;
    const int L = COL ? ic - 1 : ic;
    const int g = tc >> 3;
    const bool enter = g != g_cur;  // always g_cur - 1: a step lowers t by at most 2
    if (enter) {
      g_cur = g;
      slot = (g & (RING - 1)) * WIN;
      lo_cur = lo_next;
      kind = STEP_GROUP;
    }
    int k = L - lo_cur;
    if ((unsigned)k >= (unsigned)WIN) {  // outside the window: reload it ending at L
      __syncwarp();
      lo_cur = max(0, L - (WIN - 1));
      const int32_t* src = base + (size_t)g * gstride + lo_cur;
#pragma unroll
      for (int q = 0; q < WIN / 32; ++q) {
        const int kk = lane + 32 * q;
        if (lo_cur + kk < MP) st_shared(ring + 4u * (slot + kk), __ldg(src + kk));
      }
      __syncwarp();
      k = L - lo_cur;
      kind = STEP_RELOAD;
    }
    t = tc;
    w = slot + k;
    const int word = ld_shared(ring + 4u * w);
    if (enter) {
      __syncwarp();  // every lane is done with the slot the request overwrites
      request(g - (RING - 1), L);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 2) : "memory");
      __syncwarp();
      lo_next = __shfl_sync(FULL, my_lo, (g - 1) & (RING - 1));
    }
    return (word >> (4 * (tc & 7))) & 15;
  };

  int byte = reads ? lookup(j, i) : 2 | 8;
  int cur = byte & 3;
  int st_gap = gap0, st_pos = 0;  // this lane's entry of the chunk being walked
  hook.start();
  if (i > 0) {
    for (;;) {
      const bool is_m = cur == 0, is_h = cur == 1, is_v = cur == 2;
      const int di = is_h ? 0 : 1;                // M, V and code 3 lower i
      const int dj = is_v ? 0 : 1;                // M, H and code 3 lower j
      const int dt = COL ? dj : di + dj;
      if ((is_m || is_v) && lane == ((i - 1) & 31)) {  // template element i-1 consumed
        st_gap = is_v ? 1 : 0;
        st_pos = j - 1;
      }
      const int ni = i - di, nj = j - dj;
      const int word = ld_shared(ring + 4u * (w - di));
      int nbyte;
      if ((t & 7) >= dt && (w & (WIN - 1)) >= di && nj > 0 && (di == 0 || ((i - 1) & 31) != 0)) {
        t -= dt;  // the next cell's word is the one read
        w -= di;
        nbyte = (word >> (4 * (t & 7))) & 15;
        hook.step(STEP_FAST);
      } else {
        if (di == 1 && ((i - 1) & 31) == 0) {  // past the chunk's lowest element: store it
          const int e = i - 1 + lane;
          if (e < m_out) {
            gap_row[e] = (uint8_t)st_gap;
            pos_row[e] = st_pos;
          }
          st_gap = gap0;
          st_pos = 0;
        }
        j = nj;
        if (ni == 0) break;  // the walk ends: row 0's code is never used
        kind = STEP_OTHER;
        nbyte = lookup(nj, ni);
        hook.step(kind);
      }
      const int ext = is_h ? (byte >> 2) & 1 : ((COL ? byte : nbyte) >> 3) & 1;
      cur = (!is_m && ext == 1) ? cur : (nbyte & 3);
      i = ni;
      j = nj;
      byte = nbyte;
    }
  }
  hook.finish();
  if (lane == 0) j_begin[row] = j;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool COL>
__global__ void __launch_bounds__(32) traceback_kernel(
    const int32_t* __restrict__ ptr, const int* __restrict__ j_end,
    const int* __restrict__ m_start, uint8_t* __restrict__ is_gap, int32_t* __restrict__ jpos,
    int32_t* __restrict__ j_begin, int B, int MP, int m_out) {
  NoHook hook;
  walk_row<COL>(ptr, j_end, m_start, is_gap, jpos, j_begin, B, MP, m_out, hook);
}

}  // namespace

// col = 0: the diagonal layout; col = 1: the column layout.  One warp a row.
extern "C" int traceback_launch(const void* ptr, const void* j_end, const void* m_start,
                                void* is_gap, void* jpos, void* j_begin,
                                int B, int MP, int m_out, int col, void* stream) {
  auto p = (const int32_t*)ptr;
  auto je = (const int*)j_end;
  auto ms = (const int*)m_start;
  auto st = (cudaStream_t)stream;
  if (col)
    traceback_kernel<true><<<B, 32, 0, st>>>(p, je, ms, (uint8_t*)is_gap, (int32_t*)jpos,
                                             (int32_t*)j_begin, B, MP, m_out);
  else
    traceback_kernel<false><<<B, 32, 0, st>>>(p, je, ms, (uint8_t*)is_gap, (int32_t*)jpos,
                                              (int32_t*)j_begin, B, MP, m_out);
  return (int)cudaGetLastError();
}
