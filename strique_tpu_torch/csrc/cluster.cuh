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

// one arrival on CTA `rank`'s copy of mbarrier `bar`
__device__ __forceinline__ void arrive_remote(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 rb;\n"
      " mapa.shared::cluster.u32 rb, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [rb];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}
