// Row-gather probe: out[j] = table[idx[j]] for rows of 512 B to 6 KB, by
// one bulk asynchronous copy (the 1-D form of the Tensor Memory
// Accelerator) per row into shared memory.
//
// Replaces benchmarking/probe_row_layouts.py pallas_probe (the Pallas
// kernel of its `run`): a per-row DMA gather from HBM with 8 copies in
// flight and 512 rows per grid step. Here a block takes 512 rows; one
// thread keeps 8 `cp.async.bulk` copies in flight, each completing on
// its own mbarrier in a ring of 8 row buffers; the block writes each
// arrived row back to `out` with coalesced 16-byte stores, then reuses
// its buffer for the row 8 further on. An id outside [0, n_rows) gives
// a zero row and copies nothing.
//
// Bound on the H100: bytes (the ids, each row read once and written
// once, over 3.35 TB/s). A block of 512-byte rows is one warp, so that
// many blocks (and their copies in flight) share an SM.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStages = 8;
constexpr int kRowsPerBlock = 512;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy_row(void* dst, const void* src,
                                              uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__global__ void row_gather_kernel(const unsigned char* __restrict__ table,
                                  int64_t n_rows,
                                  const int* __restrict__ idx,
                                  unsigned char* __restrict__ out,
                                  int64_t n, int row_bytes) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) uint64_t bar[kStages];
  const int64_t base = (int64_t)blockIdx.x * kRowsPerBlock;
  const int rows = (int)min((int64_t)kRowsPerBlock, n - base);
  const int words = row_bytes / 16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int j) {  // thread 0 only
    const int s = j % kStages;
    const int r = idx[base + j];
    if (r >= 0 && r < n_rows)
      bulk_copy_row(buf + s * row_bytes, table + (int64_t)r * row_bytes,
                    row_bytes, &bar[s]);
    else
      mbar_arrive(&bar[s]);
  };
  if (threadIdx.x == 0)
    for (int j = 0; j < min(kStages, rows); ++j) issue(j);
  for (int j = 0; j < rows; ++j) {
    const int s = j % kStages;
    mbar_wait(&bar[s], (j / kStages) & 1);
    const int r = idx[base + j];
    const bool ok = r >= 0 && r < n_rows;
    const uint4* src = reinterpret_cast<const uint4*>(buf + s * row_bytes);
    uint4* dst = reinterpret_cast<uint4*>(out + (base + j) * row_bytes);
    for (int w = threadIdx.x; w < words; w += blockDim.x)
      dst[w] = ok ? src[w] : make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();  // every thread is done with buffer s
    if (threadIdx.x == 0 && j + kStages < rows) {
      // the generic-proxy reads of buffer s before the async-proxy write
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(j + kStages);
    }
  }
}

}  // namespace

// table (n_rows, row_bytes) of any type; idx (n,) int32; out
// (n, row_bytes). row_bytes: a multiple of 16, at most 6144 (8 buffers
// in the 48 KB of shared memory a block gets without opting in); table
// and out 16-byte aligned. Returns cudaGetLastError() (0 = success).
extern "C" int ingp_probe_row_gather(const void* table, int64_t n_rows,
                                     int row_bytes, const void* idx,
                                     void* out, int64_t n, void* stream) {
  if (n == 0) return 0;
  if (row_bytes <= 0 || row_bytes % 16 || row_bytes > 6144)
    return (int)cudaErrorInvalidValue;
  const int threads = row_bytes / 16 >= 256 ? 256
                      : (row_bytes / 16 + 31) / 32 * 32;
  const unsigned blocks =
      (unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock);
  row_gather_kernel<<<blocks, threads, kStages * row_bytes,
                      (cudaStream_t)stream>>>(
      (const unsigned char*)table, n_rows, (const int*)idx,
      (unsigned char*)out, n, row_bytes);
  return (int)cudaGetLastError();
}
