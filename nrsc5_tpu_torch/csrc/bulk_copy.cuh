// Bulk copies from global to shared memory by the tensor memory
// accelerator, with their mbarriers: what K6 (fec_gather.cu) and K9
// (coarse_timing.cu) use to bring a CTA's input into shared memory with one
// instruction a contiguous run, so that the copy proceeds at the memory
// system's rate while the CTA's threads only wait.
//
// A copy's source, destination and size must be multiples of 16 bytes.
// Each mbarrier is used once, for one phase: init with one arrival, one
// thread's arrive_expect with the phase's bytes, the copies, and every
// thread that reads the data waiting for phase 0 to complete.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// by one thread, before a __syncthreads that precedes any use
__device__ __forceinline__ void init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the one arrival of the phase, which will also wait for `bytes`
__device__ __forceinline__ void expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// `bytes` from global `src` to this CTA's shared `dst`, counted on `bar`
__device__ __forceinline__ void copy(void* dst, const void* src,
                                     uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// until the barrier's first phase has completed
__device__ __forceinline__ void wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT;\n"
      "}" ::"r"(smem_addr(bar))
      : "memory");
}

}  // namespace bulk
