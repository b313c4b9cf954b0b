// On-chip gather probe: out[j] = table[idx[j]] for f32 rows read from a
// table that stays on the chip.
//
// Replaces benchmarking/probe_vmem_gather.py (loop_kernel2 of its
// `vmem_loop`): 196,608 row reads, 256 per grid step, from an (8192, 256)
// f32 table resident in the TPU's VMEM. An SM's shared memory holds at
// most 227 KB a block, so the 8 MiB table cannot sit in it; the two
// Hopper forms are
//
//   L2    (`rows_l2_kernel`) the table in device memory, where the 50 MB
//         L2 keeps it after the first reads; a block takes 256 rows,
//         each warp 32 of them, each row read with 16-byte __ldg loads
//         and written back coalesced;
//   SMEM  (`rows_smem_kernel`) a table small enough for one block's
//         shared memory (at most 227 rows of 256 f32): one persistent
//         block per SM copies it in once, then walks tiles of 256 rows
//         as the TPU's sequential grid does, reading rows from shared
//         memory.
//
// An id outside [0, n_rows) gives a zero row. Bound on the H100: bytes
// (ids, the table once, the rows written).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // rows per tile, as the probe's TILE

__device__ __forceinline__ void copy_row(const float4* __restrict__ src,
                                         float4* __restrict__ dst, int words,
                                         bool ok, int lane) {
  for (int w = lane; w < words; w += 32)
    dst[w] = ok ? src[w] : make_float4(0.f, 0.f, 0.f, 0.f);
}

__global__ void __launch_bounds__(256)
    rows_l2_kernel(const float4* __restrict__ table, int n_rows,
                   const int* __restrict__ idx, float4* __restrict__ out,
                   int64_t n, int words) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t t0 = (int64_t)blockIdx.x * kTile;
  for (int j = warp; j < kTile; j += blockDim.x / 32) {
    const int64_t o = t0 + j;
    if (o >= n) return;
    const int r = idx[o];
    const bool ok = r >= 0 && r < n_rows;
    const float4* src = table + (int64_t)(ok ? r : 0) * words;
    float4* dst = out + o * words;
    for (int w = lane; w < words; w += 32)
      dst[w] = ok ? __ldg(src + w) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
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

}  // namespace

// table (n_rows, W) f32 (W a multiple of 4, 16-byte aligned); idx (n,)
// int32; out (n, W) f32. where: 0 = L2 form, 1 = shared-memory form
// (n_rows * W * 4 <= 232,448 bytes). Returns cudaGetLastError().
extern "C" int ingp_probe_onchip_gather(int where, const void* table,
                                        int n_rows, int W, const void* idx,
                                        void* out, int64_t n,
                                        void* stream) {
  if (n == 0) return 0;
  if (W <= 0 || W % 4) return (int)cudaErrorInvalidValue;
  const int words = W / 4;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned tiles = (unsigned)((n + kTile - 1) / kTile);
  if (where == 0) {
    rows_l2_kernel<<<tiles, 256, 0, s>>>(
        (const float4*)table, n_rows, (const int*)idx, (float4*)out, n,
        words);
    return (int)cudaGetLastError();
  }
  if (where != 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)n_rows * W * 4;
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
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
