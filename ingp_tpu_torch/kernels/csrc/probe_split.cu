// K1 split probe: the K1 forward and backward with one piece stubbed at a
// time, to measure what share of their time each piece takes.
//
// Replaces benchmarking/probe_kernel_split.py (make_kernel, the Pallas
// kernel of its `run`), which times the TPU's K1 forward with its
// trilerp planes, one-hot expand or select dot stubbed. Here the pieces
// are those of rayreduce.cu, for a bf16 table, F = 8 and the full
// jacobian window (F = Fj = 8, the probe's shapes):
//
//   forward (ray_reduce_fwd_kernel of rayreduce.cu, one thread per cell)
//     FULL        the shipping kernel's body (ingp_trilerp_row) at
//                 F = Fj = 8: 256 threads, one cell each, as shipped
//     NO_PLANES   weight 1 and the derivative's sign (+-1) at every
//                 corner: no weight build from the fractions
//     NO_EXPAND   every cell reads its batch row's slot-0 row
//                 urows[b, 0]: no read of uid and no row read by id
//     NO_DOT      one corner (the cell's own lattice point) instead of
//                 the 8-corner sum; the compiler drops the other seven
//                 corners' loads with their sums
//     BF16_PLANES weights and products in __nv_bfloat162, sums in f32
//     FULL with P > 1: P batch rows per block (rowpair-P)
//   backward (ray_reduce_bwd_kernel, a block per batch row, a thread per
//   lane, (27F + 31) / 32 * 32 = 224 threads, f32 cotangents; with BF16
//   each cell's lane cotangent and each run's sum are rounded to bf16, as
//   the shipping kernel does for a bf16 table)
//     FULL        the shipping kernel's body at F = Fj = 8
//     NO_ATOMICS  each run's sum is stored into scratch[b*U + slot]
//                 instead of added into the master with atomicAdd
//     NO_PLANES   weight 1 and derivative signs, as forward
//     WALK_1      each block walks one cell, not K: the floor of the
//                 launch, the block set-up and one flush (it takes away
//                 all per-cell work of the other K - 1 cells)
//     STAGED      FULL, but the block first copies its K cells' uid, lf,
//                 df and dj into shared memory (coalesced) and walks
//                 them from there: the same work without a global load
//                 on each step of the walk
//
// Bound on the H100: bytes, as rayreduce.cu. Nothing here ships: the
// wrapper is ingp_tpu_torch/probes/kernel_split.py.
#include "trilerp.cuh"

namespace {

constexpr int kF = 8;        // features per lattice point
constexpr int kW = 256;      // lanes per row
constexpr int kLanes = 27 * kF;
constexpr int kBwdThreads = (kLanes + 31) / 32 * 32;
constexpr int kKMax = 256;   // cells per row a block may walk
constexpr int kPad = kKMax + 1;

enum FwdMode { FULL = 0, NO_PLANES = 1, NO_EXPAND = 2, NO_DOT = 3,
               BF16_PLANES = 4 };
enum BwdMode { B_FULL = 0, B_NO_ATOMICS = 1, B_NO_PLANES = 2, B_WALK_1 = 3,
               B_STAGED = 4 };

// acc[f] += bf16(bf16(w) * v[f]): the product of the weight rounded to
// bf16 and a bf16 feature pair, rounded to bf16, summed in f32.
__device__ __forceinline__ void bf16_products_add(
    float (&acc)[kF], float w, const __nv_bfloat162* __restrict__ v2) {
  const __nv_bfloat162 w2 = __bfloat162bfloat162(__float2bfloat16_rn(w));
#pragma unroll
  for (int h = 0; h < kF / 2; ++h) {
    const float2 pr = __bfloat1622float2(__hmul2(w2, v2[h]));
    acc[2 * h] = __fadd_rn(acc[2 * h], pr.x);
    acc[2 * h + 1] = __fadd_rn(acc[2 * h + 1], pr.y);
  }
}

// One cell's features and unscaled jacobian from row `row` at local cell
// (ix, iy, iz) and fractions (fx, fy, fz), with the piece MODE stubs.
template <int MODE>
__device__ __forceinline__ void split_trilerp(
    const __nv_bfloat16* __restrict__ row, int ix, int iy, int iz,
    float fx, float fy, float fz, float (&feat)[kF], float (&jx)[kF],
    float (&jy)[kF], float (&jz)[kF]) {
  if constexpr (MODE == FULL || MODE == NO_EXPAND) {
    ingp_trilerp_row<__nv_bfloat16, kF, true>(row, ix, iy, iz, fx, fy, fz,
                                              feat, jx, jy, jz);
  } else {
#pragma unroll
    for (int f = 0; f < kF; ++f) feat[f] = jx[f] = jy[f] = jz[f] = 0.f;
    constexpr int kCorners = MODE == NO_DOT ? 1 : 8;
#pragma unroll
    for (int c = 0; c < kCorners; ++c) {
      const int a = c >> 2, b = (c >> 1) & 1, e = c & 1;
      const __nv_bfloat16* p =
          row + (9 * (ix + a) + 3 * (iy + b) + (iz + e)) * kF;
      if constexpr (MODE == NO_PLANES) {
        float v[kF];
        ingp_load_point<__nv_bfloat16, kF>(p, v);
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          feat[f] += v[f];
          jx[f] = a ? jx[f] + v[f] : jx[f] - v[f];
          jy[f] = b ? jy[f] + v[f] : jy[f] - v[f];
          jz[f] = e ? jz[f] + v[f] : jz[f] - v[f];
        }
      } else if constexpr (MODE == NO_DOT) {
        float v[kF];
        ingp_load_point<__nv_bfloat16, kF>(p, v);
        const float wx = 1.f - fx, wy = 1.f - fy, wz = 1.f - fz;
        const float w = wx * wy * wz;
        const float dx = -1.f * wy * wz, dy = wx * -1.f * wz,
                    dz = wx * wy * -1.f;
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          feat[f] = w * v[f];
          jx[f] = dx * v[f];
          jy[f] = dy * v[f];
          jz[f] = dz * v[f];
        }
      } else {  // BF16_PLANES
        const float wx = a ? fx : 1.f - fx;
        const float wy = b ? fy : 1.f - fy;
        const float wz = e ? fz : 1.f - fz;
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
        const __nv_bfloat162* v2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        bf16_products_add(feat, wx * wy * wz, v2);
        bf16_products_add(jx, (a ? 1.f : -1.f) * wy * wz, v2);
        bf16_products_add(jy, wx * (b ? 1.f : -1.f) * wz, v2);
        bf16_products_add(jz, wx * wy * (e ? 1.f : -1.f), v2);
      }
    }
  }
}

// Block x takes batch rows [x*P, x*P + P), thread k the cell k of each
// (blockDim = K).
template <int MODE, int P>
__global__ void __launch_bounds__(256)
    split_fwd_kernel(const __nv_bfloat16* __restrict__ table,
                     int64_t n_rows, const int* __restrict__ urows,
                     const int* __restrict__ uid,
                     const float* __restrict__ lf,
                     float* __restrict__ feats, float* __restrict__ jac,
                     int64_t B, int K, int U) {
  const int64_t n_cells = B * K;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t b = (int64_t)blockIdx.x * P + p;
    const int k = threadIdx.x;
    if (b >= B || k >= K) return;
    const int64_t i = b * K + k;
    const float lx = lf[i], ly = lf[n_cells + i], lz = lf[2 * n_cells + i];
    int r;
    if constexpr (MODE == NO_EXPAND) {
      r = urows[b * U];
    } else {
      const int u = uid[i];
      r = (u >= 0 && u < U) ? urows[b * U + u] : -1;
    }
    float feat[kF], jx[kF], jy[kF], jz[kF];
    if (ingp_local_ok(lx, ly, lz) && r >= 0 && r < n_rows) {
      split_trilerp<MODE>(table + (int64_t)r * kW, (int)lx, (int)ly,
                          (int)lz, lf[3 * n_cells + i],
                          lf[4 * n_cells + i], lf[5 * n_cells + i], feat,
                          jx, jy, jz);
    } else {
#pragma unroll
      for (int f = 0; f < kF; ++f) feat[f] = jx[f] = jy[f] = jz[f] = 0.f;
    }
    const float sc = lf[6 * n_cells + i];
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      feats[f * n_cells + i] = feat[f];
      jac[(int64_t)f * n_cells + i] = jx[f] * sc;
      jac[(int64_t)(kF + f) * n_cells + i] = jy[f] * sc;
      jac[(int64_t)(2 * kF + f) * n_cells + i] = jz[f] * sc;
    }
  }
}

template <int MODE, int P>
int launch_fwd(const void* table, int64_t n_rows, const void* urows,
               const void* uid, const void* lf, void* feats, void* jac,
               int64_t B, int K, int U, cudaStream_t s) {
  const unsigned blocks = (unsigned)((B + P - 1) / P);
  split_fwd_kernel<MODE, P><<<blocks, K, 0, s>>>(
      (const __nv_bfloat16*)table, n_rows, (const int*)urows,
      (const int*)uid, (const float*)lf, (float*)feats, (float*)jac, B, K,
      U);
  return (int)cudaGetLastError();
}

// No __launch_bounds__, as ray_reduce_bwd_kernel: the same register
// allocation as the shipping kernel.
template <int MODE, bool BF16>
__global__ void split_bwd_kernel(float* __restrict__ grad, float* __restrict__ scratch,
                     int64_t n_rows, const int* __restrict__ urows,
                     const int* __restrict__ uid,
                     const float* __restrict__ lf,
                     const float* __restrict__ df,
                     const float* __restrict__ dj, int64_t n_cells, int K,
                     int U) {
  constexpr bool kStaged = MODE == B_STAGED;
  // STAGED: uid, the 7 lf planes read and the 4F cotangents (df, then
  // dj's x, y, z planes) of the block's cells; the cotangent planes are
  // padded to kPad so that the 8 features of a cell lie in 8 banks
  __shared__ int s_uid[kStaged ? kKMax : 1];
  __shared__ float s_lf[kStaged ? 7 * kKMax : 1];
  __shared__ float s_ct[kStaged ? 4 * kF * kPad : 1];
  const int q = threadIdx.x;
  const int64_t b = blockIdx.x;
  if constexpr (kStaged) {
    for (int k = q; k < K; k += blockDim.x) {
      const int64_t i = b * K + k;
      s_uid[k] = uid[i];
#pragma unroll
      for (int c = 0; c < 7; ++c) s_lf[c * kKMax + k] = lf[c * n_cells + i];
#pragma unroll
      for (int c = 0; c < kF; ++c) s_ct[c * kPad + k] = df[c * n_cells + i];
#pragma unroll
      for (int c = 0; c < 3 * kF; ++c)
        s_ct[(kF + c) * kPad + k] = dj[c * n_cells + i];
    }
    __syncthreads();
  }
  auto ld_uid = [&](int k, int64_t i) -> int {
    if constexpr (kStaged) return s_uid[k];
    else return __ldg(uid + i);
  };
  auto ld_lf = [&](int c, int k, int64_t i) -> float {
    if constexpr (kStaged) return s_lf[c * kKMax + k];
    else return __ldg(lf + (int64_t)c * n_cells + i);
  };
  // df plane c, and dj plane c (staged after df's F planes)
  auto ld_df = [&](int c, int k, int64_t i) -> float {
    if constexpr (kStaged) return s_ct[c * kPad + k];
    else return __ldg(df + (int64_t)c * n_cells + i);
  };
  auto ld_dj = [&](int c, int k, int64_t i) -> float {
    if constexpr (kStaged) return s_ct[(kF + c) * kPad + k];
    else return __ldg(dj + (int64_t)c * n_cells + i);
  };
  const bool lane_ok = q < kLanes;
  const int p = q / kF, f = q - p * kF;
  const int pi = p / 9, pj = (p / 3) % 3, pk = p % 3;
  float acc = 0.f;
  int cur = -1;
  auto flush = [&]() {
    if (cur < 0 || !lane_ok || acc == 0.f) return;
    const int r = urows[b * U + cur];
    if (r < 0 || r >= n_rows) return;
    const float v = BF16 ? ingp_round_bf16(acc) : acc;
    if constexpr (MODE == B_NO_ATOMICS)
      scratch[(b * U + cur) * kW + q] = v;
    else
      atomicAdd(grad + (int64_t)r * kW + q, v);
  };
  const int walk = MODE == B_WALK_1 ? 1 : K;
  for (int k = 0; k < walk; ++k) {
    const int64_t i = b * K + k;
    const int u = ld_uid(k, i);
    if (u < 0 || u >= U) continue;
    const float lx = ld_lf(0, k, i), ly = ld_lf(1, k, i),
                lz = ld_lf(2, k, i);
    if (!ingp_local_ok(lx, ly, lz)) continue;
    if (u != cur) {
      flush();
      cur = u;
      acc = 0.f;
    }
    if (!lane_ok) continue;
    const int a = pi - (int)lx, bb = pj - (int)ly, e = pk - (int)lz;
    if ((unsigned)a > 1u || (unsigned)bb > 1u || (unsigned)e > 1u) continue;
    float w, d1, d2, d3;
    if constexpr (MODE == B_NO_PLANES) {
      w = 1.f;
      d1 = a ? 1.f : -1.f;
      d2 = bb ? 1.f : -1.f;
      d3 = e ? 1.f : -1.f;
    } else {
      ingp_point_planes(a, bb, e, ld_lf(3, k, i), ld_lf(4, k, i),
                        ld_lf(5, k, i), w, d1, d2, d3);
    }
    const float jx = ld_dj(f, k, i), jy = ld_dj(kF + f, k, i),
                jz = ld_dj(2 * kF + f, k, i), sc = ld_lf(6, k, i);
    float v = ingp_lane_ct(ld_df(f, k, i), w, true, jx, jy, jz, d1, d2, d3,
                           sc);
    if (BF16) v = ingp_round_bf16(v);
    acc = __fadd_rn(acc, v);
  }
  flush();
}

template <int MODE>
int launch_bwd(int bf16, void* grad, void* scratch, int64_t n_rows,
               const void* urows, const void* uid, const void* lf,
               const void* df, const void* dj, int64_t B, int K, int U,
               cudaStream_t s) {
  const int64_t n_cells = B * (int64_t)K;
#define BWD_ARGS                                                          \
  (float*)grad, (float*)scratch, n_rows, (const int*)urows,               \
      (const int*)uid, (const float*)lf, (const float*)df,                \
      (const float*)dj, n_cells, K, U
  if (bf16)
    split_bwd_kernel<MODE, true><<<(unsigned)B, kBwdThreads, 0, s>>>(
        BWD_ARGS);
  else
    split_bwd_kernel<MODE, false><<<(unsigned)B, kBwdThreads, 0, s>>>(
        BWD_ARGS);
#undef BWD_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// table (n_rows, 256) bf16; urows (B, U) int32; uid (B, K) int32;
// lf (8, B, K) f32; feats (8, B, K) f32; jac (24, B, K) f32; K <= 256
// (one thread per cell). mode: FwdMode; rows_per_block: 1, 2 or 4 (2
// and 4 with FULL only). Returns cudaGetLastError() (0 = success).
extern "C" int ingp_probe_split_fwd(int mode, int rows_per_block,
                                    const void* table, int64_t n_rows,
                                    const void* urows, const void* uid,
                                    const void* lf, void* feats, void* jac,
                                    int64_t B, int K, int U, void* stream) {
  if (B * (int64_t)K == 0) return 0;
  if (K > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define ARGS table, n_rows, urows, uid, lf, feats, jac, B, K, U, s
  if (rows_per_block == 2 && mode == FULL) return launch_fwd<FULL, 2>(ARGS);
  if (rows_per_block == 4 && mode == FULL) return launch_fwd<FULL, 4>(ARGS);
  if (rows_per_block != 1) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case FULL: return launch_fwd<FULL, 1>(ARGS);
    case NO_PLANES: return launch_fwd<NO_PLANES, 1>(ARGS);
    case NO_EXPAND: return launch_fwd<NO_EXPAND, 1>(ARGS);
    case NO_DOT: return launch_fwd<NO_DOT, 1>(ARGS);
    case BF16_PLANES: return launch_fwd<BF16_PLANES, 1>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

// grad (n_rows, 256) f32, accumulated into (all modes but NO_ATOMICS);
// scratch (B*U, 256) f32, stored into (NO_ATOMICS only, else null);
// urows (B, U), uid (B, K) int32; lf (8, B, K), df (8, B, K),
// dj (24, B, K) f32; K <= 256 for STAGED. mode: BwdMode; bf16: round
// each cell's lane cotangent and each run's sum to bf16. Returns
// cudaGetLastError().
extern "C" int ingp_probe_split_bwd(int mode, int bf16, void* grad,
                                    void* scratch, int64_t n_rows,
                                    const void* urows, const void* uid,
                                    const void* lf, const void* df,
                                    const void* dj, int64_t B, int K, int U,
                                    void* stream) {
  if (B * (int64_t)K == 0) return 0;
  if (mode == B_STAGED && K > kKMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define ARGS bf16, grad, scratch, n_rows, urows, uid, lf, df, dj, B, K, U, s
  switch (mode) {
    case B_FULL: return launch_bwd<B_FULL>(ARGS);
    case B_NO_ATOMICS: return launch_bwd<B_NO_ATOMICS>(ARGS);
    case B_NO_PLANES: return launch_bwd<B_NO_PLANES>(ARGS);
    case B_WALK_1: return launch_bwd<B_WALK_1>(ARGS);
    case B_STAGED: return launch_bwd<B_STAGED>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}
