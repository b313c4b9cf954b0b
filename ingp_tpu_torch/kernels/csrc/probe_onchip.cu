// On-chip gather probe: out[j] = table[idx[j]] for f32 rows read from a
// table that stays on the chip.
//
// Replaces benchmarking/probe_vmem_gather.py (loop_kernel2 of its
// `vmem_loop`): 196,608 row reads, 256 per grid step, from an (8192, 256)
// f32 table resident in the TPU's VMEM. An SM's shared memory holds at
// most 227 KB a block, so the 8 MiB table cannot sit in it; the Hopper
// forms are
//
//   L2    (`rows_tma_kernel`) the table in device memory, where the 50 MB
//         L2 keeps it after the first reads. Persistent blocks of one
//         warp (3 an SM) each walk tiles of up to 8 rows (8 KB of 1 KiB
//         rows) through a ring of 8 shared-memory stages: one 1-D bulk
//         copy (TMA) per row, table to stage, completing on the stage's
//         mbarrier, then one bulk copy of the whole tile, stage to
//         `out`, whose rows are contiguous. Up to 7 tiles' reads and
//         the writes behind them are in flight a block, and no register
//         holds a byte of them;
//   SMEM  (`rows_smem_kernel`) a table small enough for one block's
//         shared memory (at most 227 rows of 256 f32): one persistent
//         block per SM copies it in once, then walks tiles of 256 rows
//         as the TPU's sequential grid does, reading rows from shared
//         memory.
//
// The ring replaced a body that copied a row a warp at a time with
// 16-byte __ldg loads and coalesced stores; both take the same time from
// a CUDA graph, 1.45 times a zero_() of the same output (PERF.md, row 9).
//
// An id outside [0, n_rows) gives a zero row. Bound on the H100: bytes
// (ids, the table once, the rows written); the writes, 201 MB at the
// probe's shapes, are most of it.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kTile = 256;  // rows per tile, as the probe's TILE
constexpr int kRing = 8;                 // stages of the L2 form's ring
constexpr int kRingStageBytes = 8192;    // bytes a stage holds (rows fit)
constexpr int kRingBlocksPerSm = 3;

__device__ __forceinline__ void copy_row(const float4* __restrict__ src,
                                         float4* __restrict__ dst, int words,
                                         bool ok, int lane) {
  for (int w = lane; w < words; w += 32)
    dst[w] = ok ? src[w] : make_float4(0.f, 0.f, 0.f, 0.f);
}

// One warp. Turn j of block x takes tile x + j * gridDim.x: rows
// [tile * rps, tile * rps + rps) into stage j % kRing.
__global__ void __launch_bounds__(32)
    rows_tma_kernel(const unsigned char* __restrict__ table, int n_rows,
                    const int* __restrict__ idx,
                    unsigned char* __restrict__ out, int64_t n,
                    int row_bytes, int rps) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bar[kRing];
  const int lane = threadIdx.x;
  const int stage_bytes = rps * row_bytes;
  const int64_t n_tiles = (n + rps - 1) / rps;
  if (lane == 0) {
    for (int s = 0; s < kRing; ++s) ingp_mbar_init(&bar[s], rps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // lane l < rps fetches row l of turn j's tile and arrives once on its
  // stage's mbarrier: with the row's bytes, or after writing a zero row
  // (an id outside the table, or a row past n) into the stage
  auto fetch = [&](int64_t j) {
    const int64_t tile = blockIdx.x + j * gridDim.x;
    if (tile >= n_tiles || lane >= rps) return;
    const int s = (int)(j % kRing);
    unsigned char* dst =
        ring + (size_t)s * stage_bytes + (size_t)lane * row_bytes;
    const int64_t o = tile * rps + lane;
    const int r = o < n ? idx[o] : -1;
    if (r >= 0 && r < n_rows) {
      ingp_bulk_copy(dst, table + (int64_t)r * row_bytes, row_bytes,
                     &bar[s]);
    } else {
      for (int w = 0; w < row_bytes; w += 16)
        *reinterpret_cast<uint4*>(dst + w) = make_uint4(0u, 0u, 0u, 0u);
      ingp_fence_proxy_async();
      ingp_mbar_arrive(&bar[s]);
    }
  };
  for (int j = 0; j < kRing; ++j) fetch(j);
  for (int64_t j = 0; blockIdx.x + j * gridDim.x < n_tiles; ++j) {
    const int s = (int)(j % kRing);
    ingp_mbar_wait(&bar[s], (uint32_t)((j / kRing) & 1));
    if (lane == 0) {
      const int64_t tile = blockIdx.x + j * gridDim.x;
      const int64_t rows = min((int64_t)rps, n - tile * rps);
      ingp_fence_proxy_async();
      ingp_bulk_store(out + tile * rps * row_bytes,
                      ring + (size_t)s * stage_bytes,
                      (uint32_t)(rows * row_bytes));
      ingp_bulk_commit();
      // turn j - 1's write has read its stage: refill that stage
      if (j > 0) ingp_bulk_wait_read<1>();
    }
    __syncwarp();
    if (j > 0) fetch(j - 1 + kRing);
  }
  if (lane == 0) ingp_bulk_wait_all();
}

__global__ void __launch_bounds__(1024)
    rows_smem_kernel(const float4* __restrict__ table, int n_rows,
                     const int* __restrict__ idx, float4* __restrict__ out,
                     int64_t n, int words) {
  extern __shared__ float4 tab[];
  for (int w = threadIdx.x; w < n_rows * words; w += blockDim.x)
    tab[w] = table[w];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    for (int j = warp; j < kTile; j += blockDim.x / 32) {
      const int64_t o = t * kTile + j;
      if (o >= n) break;
      const int r = idx[o];
      const bool ok = r >= 0 && r < n_rows;
      copy_row(tab + (ok ? r : 0) * words, out + o * words, words, ok, lane);
    }
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

}  // namespace

// table (n_rows, W) f32 (W a multiple of 4, 16-byte aligned); idx (n,)
// int32; out (n, W) f32, 16-byte aligned. where: 0 = L2 form (the TMA
// ring; W * 4 <= 28,672 bytes, 8 stages of a row in a block's shared
// memory), 1 = shared-memory form (n_rows * W * 4 <= 232,448 bytes).
// Returns cudaGetLastError().
extern "C" int ingp_probe_onchip_gather(int where, const void* table,
                                        int n_rows, int W, const void* idx,
                                        void* out, int64_t n,
                                        void* stream) {
  if (n == 0) return 0;
  if (W <= 0 || W % 4) return (int)cudaErrorInvalidValue;
  const int words = W / 4;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned tiles = (unsigned)((n + kTile - 1) / kTile);
  int sms = 0;
  if (where == 0) {
    const int row_bytes = W * 4;
    if (row_bytes > 28672) return (int)cudaErrorInvalidValue;
    int rps = kRingStageBytes / row_bytes;
    rps = rps < 1 ? 1 : rps > 32 ? 32 : rps;
    const int smem = kRing * rps * row_bytes;
    cudaError_t e = (cudaError_t)sm_count(&sms);
    if (e == cudaSuccess && smem > 48 * 1024)
      e = cudaFuncSetAttribute(rows_tma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (e != cudaSuccess) return (int)e;
    const int64_t n_tiles = (n + rps - 1) / rps;
    const int64_t cap = (int64_t)kRingBlocksPerSm * sms;
    const unsigned blocks = (unsigned)(n_tiles < cap ? n_tiles : cap);
    rows_tma_kernel<<<blocks, 32, smem, s>>>(
        (const unsigned char*)table, n_rows, (const int*)idx,
        (unsigned char*)out, n, row_bytes, rps);
    return (int)cudaGetLastError();
  }
  if (where != 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)n_rows * W * 4;
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = (cudaError_t)sm_count(&sms);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rows_smem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = tiles < (unsigned)sms ? tiles : (unsigned)sms;
  rows_smem_kernel<<<blocks, 1024, bytes, s>>>(
      (const float4*)table, n_rows, (const int*)idx, (float4*)out, n,
      words);
  return (int)cudaGetLastError();
}
