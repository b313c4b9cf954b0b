// Shared device code of the kernels that copy between global and shared
// memory asynchronously (probe_rows.cu, probe_gather.cu, probe_onchip.cu):
// mbarriers, the bulk copies of the Tensor Memory Accelerator's 1-D form
// (global to shared, completing on an mbarrier; shared to global,
// completing in bulk groups) and the 16-byte cp.async of sm_80.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t ingp_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Initialise an mbarrier that completes a phase after `count` arrivals;
// the caller fences (fence.mbarrier_init) and syncs before anyone uses it.
__device__ __forceinline__ void ingp_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   ingp_smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void ingp_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   ingp_smem_addr(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void ingp_mbar_wait(uint64_t* bar,
                                               uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(ingp_smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory: arrives on `bar` expecting the
// bytes, which complete the phase when they have landed.
__device__ __forceinline__ void ingp_bulk_copy(void* dst, const void* src,
                                               uint32_t bytes,
                                               uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          ingp_smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(ingp_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(ingp_smem_addr(bar))
      : "memory");
}

// 16 bytes of shared memory in one 128-bit load (the compiler may
// otherwise split an int4 whose lanes are then selected into 4 loads).
__device__ __forceinline__ int4 ingp_lds128(const int4* p) {
  int4 v;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(ingp_smem_addr(p))
               : "memory");
  return v;
}

// 16 bytes from global to shared memory (both 16-byte aligned), through
// the L2 only; complete after ingp_cp_async_wait_all().
__device__ __forceinline__ void ingp_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   ingp_smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to
// the async proxy (a bulk copy that reads them next).
__device__ __forceinline__ void ingp_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from shared to global memory, in this thread's open bulk
// group; ingp_bulk_commit() closes the group.
__device__ __forceinline__ void ingp_bulk_store(void* dst, const void* src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(ingp_smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void ingp_bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read their
// shared-memory source (their buffers before that may be refilled).
template <int N>
__device__ __forceinline__ void ingp_bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until all of this thread's bulk groups have completed.
__device__ __forceinline__ void ingp_bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Commit this thread's cp.async copies and wait for all of them.
__device__ __forceinline__ void ingp_cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
