// In-block gather probe: the four int32 gathers of
// benchmarking/probe_gather_layouts.py, which asked whether Mosaic
// lowers a gather inside a TPU kernel (k_sub at :123 and :137, k_lane
// at :157, k_take at :179). On Hopper each is a question of where the
// table sits on the chip:
//
//   AXIS0    out[s, c] = table[idx[s, c], c], table (R, C), C a multiple
//            of 32. The (512, 128) i32 table is 256 KiB, above the
//            227 KB a block may hold, but a column needs only its own R
//            entries: a block copies a 32-column slab (R x 32) into
//            shared memory and gathers a chunk of 256 output rows from
//            it, lane c of a warp on column c (no bank conflicts: the
//            slab's row stride is 32 words).
//   AXIS1    out[s, c] = table[s, idx[s, c]], C = 128: a warp holds a
//            row in 4 registers per lane and gathers it with __shfl_sync.
//   FLAT_CLUSTER  out[j] = table[idx[j]] from a flat table of up to
//            2 x 58,112 entries (the probe's 65,536 = 256 KiB): a
//            cluster of 2 blocks holds one half each in shared memory
//            and reads the other's half through distributed shared
//            memory (sm_90).
//   FLAT_GLOBAL   the same, read from device memory with __ldg: the
//            yardstick of the cluster form.
//
// An id outside the table gives 0. Bound on the H100: bytes (the table
// once, ids and outputs); at these sizes the launch dominates.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

enum Op { AXIS0 = 0, AXIS1 = 1, FLAT_CLUSTER = 2, FLAT_GLOBAL = 3 };
constexpr int kSlabCols = 32;
constexpr int kRowsPerBlock = 256;
constexpr int kClusterThreads = 1024;

__global__ void __launch_bounds__(256)
    axis0_kernel(const int* __restrict__ table, int R, int C,
                 const int* __restrict__ idx, int* __restrict__ out,
                 int64_t S) {
  extern __shared__ int slab[];  // (R, 32)
  const int c0 = blockIdx.x * kSlabCols;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int e = threadIdx.x; e < R * kSlabCols; e += blockDim.x)
    slab[e] = table[(int64_t)(e / kSlabCols) * C + c0 + e % kSlabCols];
  __syncthreads();
  const int64_t s0 = (int64_t)blockIdx.y * kRowsPerBlock;
  for (int j = warp; j < kRowsPerBlock; j += blockDim.x / 32) {
    const int64_t s = s0 + j;
    if (s >= S) return;
    const int64_t o = s * C + c0 + lane;
    const int v = idx[o];
    out[o] = (v >= 0 && v < R) ? slab[v * kSlabCols + lane] : 0;
  }
}

__global__ void __launch_bounds__(256)
    axis1_kernel(const int* __restrict__ table,
                 const int* __restrict__ idx, int* __restrict__ out,
                 int64_t S) {
  constexpr int C = 128, kRegs = C / 32;
  const int lane = threadIdx.x % 32;
  const int64_t s =
      (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (s >= S) return;  // a whole warp leaves together
  int reg[kRegs];
#pragma unroll
  for (int j = 0; j < kRegs; ++j) reg[j] = table[s * C + j * 32 + lane];
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    const int v = idx[s * C + j * 32 + lane];
    int res = 0;
#pragma unroll
    for (int jj = 0; jj < kRegs; ++jj) {
      const int x = __shfl_sync(0xffffffffu, reg[jj], v & 31);
      if ((v >> 5) == jj) res = x;
    }
    out[s * C + j * 32 + lane] = (v >= 0 && v < C) ? res : 0;
  }
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(1024)
    flat_cluster_kernel(const int* __restrict__ table, int half,
                        const int* __restrict__ idx, int* __restrict__ out,
                        int64_t M) {
  extern __shared__ int part[];  // this block's half of the table
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  for (int e = threadIdx.x; e < half; e += blockDim.x)
    part[e] = table[(int64_t)rank * half + e];
  cluster.sync();  // both halves are in place
  const int* lo = cluster.map_shared_rank(part, 0);
  const int* hi = cluster.map_shared_rank(part, 1);
  for (int64_t j = (int64_t)rank * blockDim.x + threadIdx.x; j < M;
       j += 2 * blockDim.x) {
    const int v = idx[j];
    const bool ok = v >= 0 && v < 2 * half;
    out[j] = !ok ? 0 : v < half ? lo[v] : hi[v - half];
  }
  cluster.sync();  // keep this half alive while the other block reads it
}

__global__ void __launch_bounds__(256)
    flat_global_kernel(const int* __restrict__ table, int64_t T,
                       const int* __restrict__ idx, int* __restrict__ out,
                       int64_t M) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M) return;
  const int v = idx[j];
  out[j] = (v >= 0 && v < T) ? __ldg(table + v) : 0;
}

}  // namespace

// op: Op. table (t_rows, t_cols) int32 (the flat ops read it as
// t_rows * t_cols entries); idx and out (i_rows, i_cols) int32.
// AXIS0: t_cols == i_cols, a multiple of 32, t_rows * 32 * 4 bytes of
// shared memory; AXIS1: t_cols == i_cols == 128, t_rows == i_rows;
// FLAT_CLUSTER: an even table of at most 2 x 58,112 entries.
// Returns cudaGetLastError() (0 = success).
extern "C" int ingp_probe_gather(int op, const void* table, int64_t t_rows,
                                 int t_cols, const void* idx, void* out,
                                 int64_t i_rows, int i_cols, void* stream) {
  const int64_t M = i_rows * (int64_t)i_cols;
  const int64_t T = t_rows * (int64_t)t_cols;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* tb = (const int*)table;
  const int* ix = (const int*)idx;
  int* o = (int*)out;
  cudaError_t e = cudaSuccess;
  switch (op) {
    case AXIS0: {
      if (t_cols != i_cols || t_cols % kSlabCols)
        return (int)cudaErrorInvalidValue;
      const size_t bytes = (size_t)t_rows * kSlabCols * sizeof(int);
      if (bytes > 232448) return (int)cudaErrorInvalidValue;
      e = cudaFuncSetAttribute(axis0_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
      if (e != cudaSuccess) return (int)e;
      const dim3 grid(t_cols / kSlabCols,
                      (unsigned)((i_rows + kRowsPerBlock - 1) /
                                 kRowsPerBlock));
      axis0_kernel<<<grid, 256, bytes, s>>>(tb, (int)t_rows, t_cols, ix, o,
                                            i_rows);
      break;
    }
    case AXIS1: {
      if (t_cols != 128 || i_cols != 128 || t_rows != i_rows)
        return (int)cudaErrorInvalidValue;
      axis1_kernel<<<(unsigned)((i_rows + 7) / 8), 256, 0, s>>>(tb, ix, o,
                                                                 i_rows);
      break;
    }
    case FLAT_CLUSTER: {
      if (T % 2 || (T / 2) * sizeof(int) > 232448)
        return (int)cudaErrorInvalidValue;
      const int half = (int)(T / 2);
      e = cudaFuncSetAttribute(flat_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               half * (int)sizeof(int));
      if (e != cudaSuccess) return (int)e;
      flat_cluster_kernel<<<2, kClusterThreads, half * sizeof(int), s>>>(
          tb, half, ix, o, M);
      break;
    }
    case FLAT_GLOBAL:
      flat_global_kernel<<<(unsigned)((M + 255) / 256), 256, 0, s>>>(
          tb, T, ix, o, M);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
