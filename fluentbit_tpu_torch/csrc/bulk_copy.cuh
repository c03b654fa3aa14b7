// bulk_copy.cuh — a block's one-shot table copy from global to shared
// memory on Hopper (cp.async.bulk with completion on an mbarrier), shared
// by the grep kernels (grep_dfa.cu, grep_assoc.cu).
//
// Use: thread 0 calls table_copy, every thread then passes a
// __syncthreads, and every thread that reads the table calls table_wait
// first. The mbarrier is initialised inside table_copy and completes one
// phase, so one copy a block.

#pragma once

#include <cstdint>

namespace bulk_copy {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Thread 0 starts one bulk copy of `bytes` (a multiple of 16, both
// addresses 16 B aligned) from global to shared memory, its completion
// counted on the mbarrier `bar`. Every thread must then pass a
// __syncthreads before table_wait.
__device__ __forceinline__ void table_copy(void* dst, const void* src,
                                           unsigned bytes, uint64_t* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Wait until the mbarrier's first phase completes (the copy has landed).
__device__ __forceinline__ void table_wait(uint64_t* bar) {
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(b), "r"(0)
        : "memory");
  }
}

}  // namespace bulk_copy
