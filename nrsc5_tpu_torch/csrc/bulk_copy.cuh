// Bulk copies from global to shared memory by the tensor memory
// accelerator, with their mbarriers: what K6 (fec_gather.cu), K9
// (coarse_timing.cu), K11 (px_deinterleave.cu) and K15 (am_gather.cu) use
// to bring a CTA's input into shared memory with one instruction a
// contiguous run, so that the copy proceeds at the memory system's rate
// while the CTA's threads only wait; and bulk stores back to global memory.
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

// Stores the other way, from shared to global memory, in the calling
// thread's bulk group: fence_shared once after the bytes landed, the
// stores, one commit, and wait_read before the CTA may leave or reuse the
// source.

// orders this CTA's shared memory before the async proxy's reads of it
__device__ __forceinline__ void fence_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` of this CTA's shared `src` to global `dst`
__device__ __forceinline__ void store(void* dst, const void* src,
                                      uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until the calling thread's committed stores have read their sources
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

}  // namespace bulk
