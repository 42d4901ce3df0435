// Bulk asynchronous copies from device memory to shared memory (Hopper's
// cp.async.bulk) that report completion to an mbarrier in shared memory.
//
// One thread initialises the barrier, announces the bytes it expects and
// starts the copies; the copy engine computes the addresses, so no thread
// spends registers or instructions on the transfer. Every thread that reads
// the data waits on the barrier's phase first. Source, destination and size
// must be multiples of 16 bytes.

#pragma once

#include <stdint.h>

namespace async_copy {

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Call from one thread, then __syncthreads() before any thread waits.
__device__ __forceinline__ void barrier_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_address(bar)), "r"(arrivals) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces `bytes` of copies to come in this phase.
__device__ __forceinline__ void barrier_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(shared_address(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst_shared, const void* src_global, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   shared_address(dst_shared)),
               "l"(src_global), "r"(bytes), "r"(shared_address(bar))
               : "memory");
}

// Blocks until the barrier's phase of the given parity has completed: the
// n-th phase (from 0) has parity n & 1.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(shared_address(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

}  // namespace async_copy
