// In-block gather probe: the four int32 gathers of
// benchmarking/probe_gather_layouts.py, which asked whether Mosaic
// lowers a gather inside a TPU kernel (k_sub at :123 and :137, k_lane
// at :157, k_take at :179). On Hopper each is a question of where the
// table sits on the chip: in the L2, in a block's shared memory, or
// across a cluster's. The bound is bytes (the table once, ids and
// outputs over 3.35 TB/s); at the probe's sizes a launch's own cost,
// ~0.0012-0.0014 ms from a CUDA graph, is most of it.
//
//   AXIS0    out[s, c] = table[idx[s, c], c], table (R, C), C a multiple
//            of 32, R <= 3120. A thread takes 4 adjacent columns of one
//            row: a 16-byte id load, four 4-byte reads, a 16-byte store.
//            Below kSlabFromRows output rows it reads the table straight
//            from the L2 (at the probe's 256 rows the (512, 128) table's
//            256 KiB outweigh the 128 KiB of output), a grid of S * C /
//            1024 blocks. From there on a block (slab x, chunk y) stages
//            a slab of kSlabCols columns (R x 16) and its chunk's ids
//            (kSlabRows x 16) in shared memory as one group of 16-byte
//            cp.async copies, then writes the chunk. At the probe's R =
//            512 the slab holds as many bytes as the chunk writes; at
//            8192 rows the grid is 8 x 16 = 128 blocks of 64 KiB. On an
//            H100 the 16-column slab beat 32- and 8-column ones at 8192
//            rows and overtook the L2 at 2048 rows; reading a group's 4
//            columns in an order rotated by the lane's row, which spreads
//            a warp's reads over the banks, gained nothing there.
//   AXIS1    out[s, c] = table[s, idx[s, c]], C = 128: a warp holds a
//            row in 4 registers per lane and gathers it with __shfl_sync.
//   FLAT_CLUSTER  out[j] = table[idx[j]] from a flat table of up to
//            kFlatCluster x 58,108 entries (the probe's 65,536 = 256 KiB):
//            clusters of kFlatCluster blocks each hold the whole table,
//            a part per block loaded by one bulk copy on an mbarrier;
//            the ids are split over blocks of 64 threads (128 at the
//            probe's 32,768 ids), a thread taking 4 ids with 16-byte
//            loads and stores and reading its local or a remote part
//            through distributed shared memory. On an H100 clusters of 8
//            tied clusters of 16 and beat those of 2 and 4.
//   FLAT_GLOBAL   the same, read from device memory with __ldg: the
//            yardstick of the cluster form.
//   AXIS0_BEFORE, FLAT_CLUSTER_BEFORE  the first bodies, kept to time
//            beside the new ones: 4-byte slab loads by a grid of (C / 32,
//            S / 256), 4 blocks at (256, 128), R <= 1816; one cluster of
//            2 blocks x 1024 threads holding half the table each.
//
// An id outside the table gives 0. AXIS0 and FLAT_CLUSTER read their
// table and ids with 16-byte copies and loads, so they take both only
// 16-byte aligned; the other ops take any int32 pointers.
#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

enum Op {
  AXIS0 = 0,
  AXIS1 = 1,
  FLAT_CLUSTER = 2,
  FLAT_GLOBAL = 3,
  AXIS0_BEFORE = 4,
  FLAT_CLUSTER_BEFORE = 5,
};
constexpr int kSmemMax = 232448;  // shared bytes a block may hold
constexpr int kSlabCols = 16;     // AXIS0's slab width
constexpr int kBeforeCols = 32;   // AXIS0_BEFORE's slab width
constexpr int kL2Threads = 256;
constexpr int kSlabThreads = 512;
constexpr int kSlabRows = 512;    // output rows of a slab block
// AXIS0's limit on R: its slab beside its chunk's ids (3120)
constexpr int kAxis0MaxRows =
    (kSmemMax - kSlabRows * kSlabCols * 4) / (kSlabCols * 4);
// AXIS0_BEFORE's: its 32-column slab alone (1816)
constexpr int kBeforeMaxRows = kSmemMax / (kBeforeCols * 4);
// AXIS0 reads the L2 below this many output rows and the slab from it on
constexpr int64_t kSlabFromRows = 2048;
constexpr int kFlatThreads = 64;  // 256 ids a block
constexpr int kFlatCluster = 8;   // FLAT_CLUSTER's blocks per cluster
constexpr int kFlatPartMax = (kSmemMax - 16) / 4;  // the mbarrier's 8 B
constexpr int kFlatMaxBlocks = 1056;
constexpr int kRowsPerBlockBefore = 256;
constexpr int kClusterThreadsBefore = 1024;

__device__ __forceinline__ int l2_at(const int* __restrict__ t, int R,
                                     int C, int id, int c) {
  return (id >= 0 && id < R) ? __ldg(t + (int64_t)id * C + c) : 0;
}

// G = S * C / 4 groups of 4 columns, a thread each.
__global__ void __launch_bounds__(kL2Threads)
    axis0_l2_kernel(const int* __restrict__ table, int R, int C,
                    const int4* __restrict__ idx, int4* __restrict__ out,
                    int64_t G) {
  const int64_t g = (int64_t)blockIdx.x * kL2Threads + threadIdx.x;
  if (g >= G) return;
  const int c = (int)(g % (C / 4)) * 4;
  const int4 v = idx[g];
  out[g] = make_int4(l2_at(table, R, C, v.x, c),
                     l2_at(table, R, C, v.y, c + 1),
                     l2_at(table, R, C, v.z, c + 2),
                     l2_at(table, R, C, v.w, c + 3));
}

// The 4 columns of group q at rows v from the slab. No branch: an id
// outside [0, R) reads row 0 and gives 0, so the 4 reads go out back
// to back.
__device__ __forceinline__ int4 slab_pick(const int* slab, int R, int q,
                                          const int4& v) {
  const int id[4] = {v.x, v.y, v.z, v.w};
  int got[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool ok = (unsigned)id[j] < (unsigned)R;
    const int x = slab[(ok ? id[j] : 0) * kSlabCols + 4 * q + j];
    got[j] = ok ? x : 0;
  }
  return make_int4(got[0], got[1], got[2], got[3]);
}

// A block (slab x, chunk y) copies its chunk's ids (kSlabRows x
// kSlabCols) and its slab (R x kSlabCols) into shared memory as one
// group of 16-byte cp.async copies, so that both are in flight together
// (ids loaded into registers were moved below the wait by the
// compiler), then writes the chunk's outputs: lane l of a warp on column
// group l % kG of row l / kG of the warp's rows, a step of the block
// covering kSlabThreads / kG rows.
__global__ void __launch_bounds__(kSlabThreads)
    axis0_slab_kernel(const int* __restrict__ table, int R, int C,
                      const int4* __restrict__ idx, int4* __restrict__ out,
                      int64_t S) {
  constexpr int kG = kSlabCols / 4;  // 16-byte groups of a slab row
  constexpr int kStepRows = kSlabThreads / kG;
  extern __shared__ __align__(16) int4 staged[];  // ids, then the slab
  int* slab = reinterpret_cast<int*>(staged + kSlabRows * kG);
  const int c0 = blockIdx.x * kSlabCols;
  const int64_t gC = C / 4, g0 = c0 / 4;
  const int64_t s0 = (int64_t)blockIdx.y * kSlabRows;
  const int rows = (int)min((int64_t)kSlabRows, S - s0);
  for (int e = threadIdx.x; e < R * kG; e += kSlabThreads)
    ingp_cp_async16(slab + e * 4,
                    table + (int64_t)(e / kG) * C + c0 + (e % kG) * 4);
  for (int e = threadIdx.x; e < rows * kG; e += kSlabThreads)
    ingp_cp_async16(staged + e, idx + (s0 + e / kG) * gC + g0 + e % kG);
  ingp_cp_async_wait_all();
  __syncthreads();
  const int q = threadIdx.x % kG, sub = threadIdx.x / kG;
#pragma unroll
  for (int k = 0; k < kSlabRows / kStepRows; ++k) {
    const int r = sub + k * kStepRows;
    if (r < rows)
      out[(s0 + r) * gC + g0 + q] =
          slab_pick(slab, R, q, ingp_lds128(staged + r * kG + q));
  }
}

// No branch: an id outside [0, T) reads entry 0 and gives 0, so a
// thread's 4 reads of (remote) shared memory are in flight together.
__device__ __forceinline__ int flat_at(cg::cluster_group& cluster,
                                       int* part_smem, int part, int T,
                                       int v) {
  const bool ok = (unsigned)v < (unsigned)T;
  const int vv = ok ? v : 0;
  const int r = vv / part;
  const int x = cluster.map_shared_rank(part_smem, r)[vv - r * part];
  return ok ? x : 0;
}

// Block rank r of a cluster holds entries [r * part, r * part + part) of
// the table; block b serves the id groups b * 64 + t (+ the grid's
// threads), group g being ids [4g, 4g + 4), and block 0 the last M % 4
// ids.
static_assert(kFlatCluster == 8, "flat_cluster_kernel's __cluster_dims__");
__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(kFlatThreads)
        flat_cluster_kernel(const int* __restrict__ table, int T, int part,
                            const int* __restrict__ idx,
                            int* __restrict__ out, int64_t M) {
  extern __shared__ __align__(16) int slice[];
  __shared__ __align__(8) uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int lo = (int)cluster.block_rank() * part;
  const int n = max(0, min(part, T - lo));
  const int nb = n & ~3;  // the bulk copy's entries: whole 16-byte words
  if (threadIdx.x == 0) {
    ingp_mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (nb > 0)
      ingp_bulk_copy(slice, table + lo, (uint32_t)nb * 4u, &bar);
    else
      ingp_mbar_arrive(&bar);
  }
  for (int e = nb + threadIdx.x; e < n; e += kFlatThreads)
    slice[e] = table[lo + e];
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  const int64_t G = M / 4, stride = (int64_t)gridDim.x * kFlatThreads;
  int64_t g = (int64_t)blockIdx.x * kFlatThreads + threadIdx.x;
  int4 v = g < G ? idx4[g] : make_int4(0, 0, 0, 0);  // while parts land
  __syncthreads();  // the mbarrier is initialised
  ingp_mbar_wait(&bar, 0);
  cluster.sync();  // every part of the cluster is in place
  while (g < G) {
    reinterpret_cast<int4*>(out)[g] =
        make_int4(flat_at(cluster, slice, part, T, v.x),
                  flat_at(cluster, slice, part, T, v.y),
                  flat_at(cluster, slice, part, T, v.z),
                  flat_at(cluster, slice, part, T, v.w));
    g += stride;
    if (g < G) v = idx4[g];
  }
  if (blockIdx.x == 0)
    for (int64_t j = 4 * G + threadIdx.x; j < M; j += kFlatThreads)
      out[j] = flat_at(cluster, slice, part, T, idx[j]);
  cluster.sync();  // keep this part alive while the other blocks read it
}

__global__ void __launch_bounds__(256)
    axis0_before_kernel(const int* __restrict__ table, int R, int C,
                        const int* __restrict__ idx, int* __restrict__ out,
                        int64_t S) {
  extern __shared__ int slab[];  // (R, 32)
  const int c0 = blockIdx.x * kBeforeCols;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int e = threadIdx.x; e < R * kBeforeCols; e += blockDim.x)
    slab[e] = table[(int64_t)(e / kBeforeCols) * C + c0 + e % kBeforeCols];
  __syncthreads();
  const int64_t s0 = (int64_t)blockIdx.y * kRowsPerBlockBefore;
  for (int j = warp; j < kRowsPerBlockBefore; j += blockDim.x / 32) {
    const int64_t s = s0 + j;
    if (s >= S) return;
    const int64_t o = s * C + c0 + lane;
    const int v = idx[o];
    out[o] = (v >= 0 && v < R) ? slab[v * kBeforeCols + lane] : 0;
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
    flat_cluster_before_kernel(const int* __restrict__ table, int half,
                               const int* __restrict__ idx,
                               int* __restrict__ out, int64_t M) {
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

// A launch: grid, threads per block, blocks per cluster (1: none),
// dynamic shared bytes per block, and the flat table's part per block.
struct Plan {
  int64_t gx, gy;
  int threads, cluster;
  int64_t smem, part;
};

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The launch of `op` on these shapes; false where the op does not take
// them (the wrappers' limits). M = i_rows * i_cols > 0.
bool plan_of(int op, int64_t t_rows, int t_cols, int64_t i_rows,
             int i_cols, Plan& p) {
  const int64_t M = i_rows * (int64_t)i_cols;
  const int64_t T = t_rows * (int64_t)t_cols;
  p = Plan{1, 1, 256, 1, 0, 0};
  if (t_rows <= 0 || t_cols <= 0 || i_rows <= 0 || i_cols <= 0)
    return false;
  switch (op) {
    case AXIS0:
      if (t_cols != i_cols || t_cols % 32 || t_rows > kAxis0MaxRows)
        return false;
      if (i_rows >= kSlabFromRows) {
        p.gx = t_cols / kSlabCols;
        p.gy = cdiv(i_rows, kSlabRows);
        p.threads = kSlabThreads;
        p.smem = (kSlabRows + t_rows) * kSlabCols * 4;  // ids, the slab
      } else {
        p.gx = cdiv(M / 4, kL2Threads);
        p.threads = kL2Threads;
      }
      return p.gy < 65536;
    case AXIS0_BEFORE:
      if (t_cols != i_cols || t_cols % 32 || t_rows > kBeforeMaxRows)
        return false;
      p.gx = t_cols / kBeforeCols;
      p.gy = cdiv(i_rows, kRowsPerBlockBefore);
      p.smem = t_rows * kBeforeCols * 4;
      return p.gy < 65536;
    case AXIS1:
      if (t_cols != 128 || i_cols != 128 || t_rows != i_rows) return false;
      p.gx = cdiv(i_rows, 8);
      return true;
    case FLAT_GLOBAL:
      p.gx = cdiv(M, 256);
      return true;
    case FLAT_CLUSTER_BEFORE:
      if (T % 2 || (T / 2) * 4 > kSmemMax) return false;
      p.gx = 2;
      p.threads = kClusterThreadsBefore;
      p.cluster = 2;
      p.smem = (T / 2) * 4;
      return true;
    case FLAT_CLUSTER: {
      if (cdiv(T, kFlatCluster) > kFlatPartMax) return false;
      p.part = cdiv(cdiv(T, kFlatCluster), 4) * 4;
      const int64_t clusters =
          std::min(cdiv(cdiv(M, 4 * kFlatThreads), kFlatCluster),
                   (int64_t)(kFlatMaxBlocks / kFlatCluster));
      p.gx = clusters * kFlatCluster;
      p.threads = kFlatThreads;
      p.cluster = kFlatCluster;
      p.smem = p.part * 4;
      return true;
    }
    default:
      return false;
  }
}

// The alignment, in bytes, `op` needs of its table, ids and output.
int align_of(int op) { return op == AXIS0 || op == FLAT_CLUSTER ? 16 : 4; }

template <typename K>
cudaError_t allow_smem(K* kernel, int64_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// The launch ingp_probe_gather makes for op on these shapes: dims[0..4]
// = grid x, grid y, threads per block, blocks per cluster (1: no
// cluster), dynamic shared bytes per block. Returns 0, or
// cudaErrorInvalidValue where the op does not take the shapes.
extern "C" int ingp_probe_gather_shape(int op, int64_t t_rows, int t_cols,
                                       int64_t i_rows, int i_cols,
                                       int* dims) {
  Plan p;
  if (!plan_of(op, t_rows, t_cols, i_rows, i_cols, p))
    return (int)cudaErrorInvalidValue;
  dims[0] = (int)p.gx;
  dims[1] = (int)p.gy;
  dims[2] = p.threads;
  dims[3] = p.cluster;
  dims[4] = (int)p.smem;
  return 0;
}

// op: Op. table (t_rows, t_cols) int32 (the flat ops read it as
// t_rows * t_cols entries); idx and out (i_rows, i_cols) int32; all
// three 16-byte aligned for AXIS0 and FLAT_CLUSTER, 4-byte for the
// others. AXIS0 forms: t_cols == i_cols, a multiple of 32, t_rows <=
// 3120 (AXIS0_BEFORE: 1816); AXIS1: t_cols == i_cols == 128, t_rows ==
// i_rows; FLAT_CLUSTER: at most 8 x 58,108 entries; FLAT_CLUSTER_BEFORE:
// an even table of at most 2 x 58,112 entries. Returns
// cudaGetLastError() (0 = success).
extern "C" int ingp_probe_gather(int op, const void* table, int64_t t_rows,
                                 int t_cols, const void* idx, void* out,
                                 int64_t i_rows, int i_cols, void* stream) {
  const int64_t M = i_rows * (int64_t)i_cols;
  const int64_t T = t_rows * (int64_t)t_cols;
  if (M == 0) return 0;
  Plan p;
  if (!plan_of(op, t_rows, t_cols, i_rows, i_cols, p) ||
      ((uintptr_t)table | (uintptr_t)idx | (uintptr_t)out) % align_of(op))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* tb = (const int*)table;
  const int* ix = (const int*)idx;
  int* o = (int*)out;
  const dim3 grid((unsigned)p.gx, (unsigned)p.gy);
  const int R = (int)t_rows;
  cudaError_t e = cudaSuccess;
  switch (op) {
    case AXIS0: {
      const int4* ix4 = (const int4*)idx;
      int4* o4 = (int4*)out;
      if (i_rows < kSlabFromRows) {
        axis0_l2_kernel<<<grid, p.threads, 0, s>>>(tb, R, t_cols, ix4, o4,
                                                   M / 4);
      } else {
        e = allow_smem(axis0_slab_kernel, p.smem);
        if (e == cudaSuccess)
          axis0_slab_kernel<<<grid, p.threads, p.smem, s>>>(
              tb, R, t_cols, ix4, o4, i_rows);
      }
      break;
    }
    case AXIS0_BEFORE:
      e = allow_smem(axis0_before_kernel, p.smem);
      if (e == cudaSuccess)
        axis0_before_kernel<<<grid, p.threads, p.smem, s>>>(
            tb, R, t_cols, ix, o, i_rows);
      break;
    case AXIS1:
      axis1_kernel<<<grid, p.threads, 0, s>>>(tb, ix, o, i_rows);
      break;
    case FLAT_GLOBAL:
      flat_global_kernel<<<grid, p.threads, 0, s>>>(tb, T, ix, o, M);
      break;
    case FLAT_CLUSTER_BEFORE:
      e = allow_smem(flat_cluster_before_kernel, p.smem);
      if (e == cudaSuccess)
        flat_cluster_before_kernel<<<grid, p.threads, p.smem, s>>>(
            tb, (int)(T / 2), ix, o, M);
      break;
    case FLAT_CLUSTER:
      e = allow_smem(flat_cluster_kernel, p.smem);
      if (e == cudaSuccess)
        flat_cluster_kernel<<<grid, p.threads, p.smem, s>>>(
            tb, (int)T, (int)p.part, ix, o, M);
      break;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
