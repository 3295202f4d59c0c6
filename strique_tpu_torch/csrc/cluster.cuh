// Device helpers shared by the kernel files, included inside each file's
// anonymous namespace: the NaN-propagating max of the alignment kernels,
// and the mbarrier / st.async primitives of the kernels that run a row on
// a thread-block cluster (viterbi_dense.cu's resident mode, the TABLE
// cluster forms of wave_align.cu and col_align.cu).
#pragma once

// max of jnp.maximum / torch.maximum: NaN if either operand is NaN (the
// canonical NaN 0x7fffffff), else fmaxf's bits
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// arm mbarrier `bar` for one phase: one arrival (this thread's) and
// `bytes` of st.async data
__device__ __forceinline__ void expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait for the phase of parity `parity` of `bar` to complete; a phase
// that never completes (a broken exchange) traps instead of hanging
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred P;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P, [%1], %2;\n"
        " selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 26)) __trap();
  }
}

// wait_parity with CTA-scope acquire: for a phase completed by this
// CTA's own threads or by bytes st.async delivered into this CTA's shared
// memory, and for the slot-free arrivals of a peer that only reads its
// own copy.  A cluster-scope acquire also invalidates the SM's L1 (CCTL.IVALL),
// which costs the other warps their cached global reads.
__device__ __forceinline__ void wait_parity_cta(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred P;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        " selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 26)) __trap();
  }
}

// 16 bytes into CTA `rank`'s copy of shared address `addr`, completing
// 16 bytes on that CTA's copy of mbarrier `bar`
__device__ __forceinline__ void st_async_v4(uint32_t addr, float4 v, uint32_t bar,
                                            uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 ra, rb;\n"
      " mapa.shared::cluster.u32 ra, %0, %5;\n"
      " mapa.shared::cluster.u32 rb, %6, %5;\n"
      " st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [ra], {%1, %2, %3, %4}, "
      "[rb];\n}\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(rank), "r"(bar)
      : "memory");
}

// 8 bytes, as st_async_v4
__device__ __forceinline__ void st_async_v2(uint32_t addr, float x, float y, uint32_t bar,
                                            uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 ra, rb;\n"
      " mapa.shared::cluster.u32 ra, %0, %3;\n"
      " mapa.shared::cluster.u32 rb, %4, %3;\n"
      " st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [ra], {%1, %2}, [rb];\n"
      "}\n" ::"r"(addr),
      "f"(x), "f"(y), "r"(rank), "r"(bar)
      : "memory");
}

// 4 bytes, as st_async_v4
__device__ __forceinline__ void st_async_b32(uint32_t addr, uint32_t x, uint32_t bar,
                                             uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 ra, rb;\n"
      " mapa.shared::cluster.u32 ra, %0, %2;\n"
      " mapa.shared::cluster.u32 rb, %3, %2;\n"
      " st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [ra], %1, [rb];\n"
      "}\n" ::"r"(addr),
      "r"(x), "r"(rank), "r"(bar)
      : "memory");
}

// one arrival on this CTA's mbarrier `bar`, after this thread's earlier
// shared-memory writes
__device__ __forceinline__ void arrive_local(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival on CTA `rank`'s copy of mbarrier `bar` after this thread's
// earlier shared-memory reads: a CTA-scope fence, then a relaxed
// cluster-scope arrive.  For a consumer freeing a ring slot it has read;
// the slot lies in this CTA's shared memory, and the producer `rank`
// writes it again by st.async only once its wait on `bar` has seen this
// arrival.  That the slot's last reads (wave_align.cu: rs[14], rs[15],
// loaded just before) are done by then rests on the SM, not on the PTX
// memory model: the CTA-scope fence is relied on to hold the arrival
// behind this thread's earlier loads, which read the one physical copy
// of the slot that the st.async writes, and the producer's write starts
// only after the arrival has crossed to it and its store has crossed
// back.  The model orders these reads before
// another CTA's write only through a release at cluster scope
// (arrive_remote), which compiles to MEMBAR.ALL.GPU and waits for every
// global store the thread has in flight (its pointer words): a group's
// end 850 against 230 cycles at 128 lanes.  The tests hold every cluster
// size the launch plan can pick bit-equal to the twins.
__device__ __forceinline__ void arrive_remote_after_reads(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 rb;\n"
      " fence.acq_rel.cta;\n"
      " mapa.shared::cluster.u32 rb, %0, %1;\n"
      " mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [rb];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// one arrival on CTA `rank`'s copy of mbarrier `bar`
__device__ __forceinline__ void arrive_remote(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 rb;\n"
      " mapa.shared::cluster.u32 rb, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [rb];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}
