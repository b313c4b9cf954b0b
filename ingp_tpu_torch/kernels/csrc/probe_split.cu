// K1/K2 split probe: the K1 forward and backward and the K2 forward with
// one piece stubbed at a time, to measure what share of their time each
// piece takes.
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
//   backward (the K1 backward before the chunked, run-parallel form of
//   rayreduce.cu replaced it: a block per batch row, a thread per lane,
//   (27F + 31) / 32 * 32 = 224 threads walking all K cells, f32
//   cotangents; with BF16 each cell's lane cotangent and each run's sum
//   are rounded to bf16, as for a bf16 table)
//     FULL        that body at F = Fj = 8
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
//   FULL also runs without dj (null): that body's no-jacobian form (the
//   rgb table's backward). The replaced bodies stay here for the
//   before/after timing on the same inputs (chip_smoke.py).
//
//   K2 forward (brick_reduce_fwd_kernel before the tiled form of
//   brickreduce.cu replaced it: a thread per (level, sample) cell,
//   level-fastest, lf read at stride N, each output float a scalar store
//   at a 4*F-byte stride across the warp), bf16 table, F = Fj = 8, with
//   and without the jacobian:
//     K2_FULL          that body, unchanged
//     K2_NO_CORNERS    every cell reads the corners of cell (0, 0, 0)
//                      of row 0 (one fixed, cached row): no corner
//                      gather
//     K2_NO_JAC_STORES the jacobian is not stored (so the compiler drops
//                      its arithmetic too)
//     K2_COALESCED     the features stored feature-major, (F, Lw*N) at
//                      cell i = n*Lw + l, coalesced along i
//
//   K2 backward (brick_reduce_bwd_kernel before the tiled form of
//   brickreduce.cu replaced it: a thread per (level, sample) cell,
//   level-fastest, lf and rows read at stride N, df and dj read with
//   scalar loads at a 4*F-byte stride across the warp, each of the 8*F
//   lane cotangents added into the master with its own scalar f32
//   atomicAdd), F = Fj = 8, with and without dj, f32 or bf16 cells:
//     K2B_FULL         that body, unchanged
//     K2B_NO_ATOMICS   each lane value is added into a register instead
//                      of the master; the block's sum of them is written
//                      to scratch[block] (so the compiler keeps the work)
//     K2B_CONTIGUOUS   every input read at thread-contiguous addresses:
//                      lf and rows at the flat level-major index i, df
//                      and dj feature-major (df[f*cells + i]) -- the same
//                      bytes, coalesced, each cell given other inputs
//     K2B_VECTOR       each corner's F lanes added with two 16-byte
//                      float4 atomics (sm_90) instead of 8 scalar ones,
//                      none where all F are 0 (as `full` skips each 0)
//
//   K3 backward (composite_bwd_kernel of composite.cu before the
//   warp-per-ray form replaced it: a thread per ray walking its S
//   samples twice), K3B_FULL only, unchanged.
//
//   K3 forward (composite_fwd_kernel of composite.cu before the
//   group-per-ray form replaced it: a thread per ray, loads and stores at
//   the ray's S*4-byte stride across the warp, ws re-read for the aux
//   sums), unchanged: `k3 fwd full`. It reads ts (the callers that have
//   none pass a plane of zeros, as the step did before).
//
// Bound on the H100: bytes, as rayreduce.cu and brickreduce.cu. Nothing
// here ships: the wrapper is ingp_tpu_torch/probes/kernel_split.py.
#include "trilerp.cuh"
#include "k3.cuh"

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
enum K2Mode { K2_FULL = 0, K2_NO_CORNERS = 1, K2_NO_JAC_STORES = 2,
              K2_COALESCED = 3 };
enum K2BwdMode { K2B_FULL = 0, K2B_NO_ATOMICS = 1, K2B_CONTIGUOUS = 2,
                 K2B_VECTOR = 3 };

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
template <int MODE, bool BF16, bool JAC = true>
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
    float jx = 0.f, jy = 0.f, jz = 0.f, sc = 0.f;
    if (JAC) {
      jx = ld_dj(f, k, i);
      jy = ld_dj(kF + f, k, i);
      jz = ld_dj(2 * kF + f, k, i);
      sc = ld_lf(6, k, i);
    }
    float v = ingp_lane_ct(ld_df(f, k, i), w, JAC, jx, jy, jz, d1, d2, d3,
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
  if constexpr (MODE == B_FULL) {
    if (dj == nullptr) {
      if (bf16)
        split_bwd_kernel<MODE, true, false>
            <<<(unsigned)B, kBwdThreads, 0, s>>>(BWD_ARGS);
      else
        split_bwd_kernel<MODE, false, false>
            <<<(unsigned)B, kBwdThreads, 0, s>>>(BWD_ARGS);
      return (int)cudaGetLastError();
    }
  }
  if (bf16) {
    split_bwd_kernel<MODE, true><<<(unsigned)B, kBwdThreads, 0, s>>>(
        BWD_ARGS);
  } else {
    split_bwd_kernel<MODE, false><<<(unsigned)B, kBwdThreads, 0, s>>>(
        BWD_ARGS);
  }
#undef BWD_ARGS
  return (int)cudaGetLastError();
}

// brick_reduce_fwd_kernel before the tiled form (brickreduce.cu), with the
// K2Mode stubs.
template <int MODE, typename T, int F, bool JAC>
__global__ void __launch_bounds__(256)
    split_k2_kernel(const T* __restrict__ table, int64_t n_rows,
                    const int* __restrict__ rows,
                    const float* __restrict__ lf, float* __restrict__ feats,
                    float* __restrict__ jac, int Lw, int64_t N, int W,
                    int jac_lo, int Fj) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n_cells = (int64_t)Lw * N;
  if (i >= n_cells) return;
  const int64_t n = i / Lw;
  const int l = (int)(i - n * Lw);
  const int64_t c = (int64_t)l * N + n;  // index into (Lw, N) planes
  const float lx = lf[c], ly = lf[n_cells + c], lz = lf[2 * n_cells + c];
  const int r = rows[c];
  float feat[F], jx[F], jy[F], jz[F];
  if (ingp_local_ok(lx, ly, lz) && r >= 0 && r < n_rows) {
    if constexpr (MODE == K2_NO_CORNERS)   // row 0, cell (0, 0, 0)
      ingp_trilerp_row<T, F, JAC>(table, 0, 0, 0, lf[3 * n_cells + c],
                                  lf[4 * n_cells + c], lf[5 * n_cells + c],
                                  feat, jx, jy, jz);
    else
      ingp_trilerp_row<T, F, JAC>(table + (int64_t)r * W, (int)lx, (int)ly,
                                  (int)lz, lf[3 * n_cells + c],
                                  lf[4 * n_cells + c], lf[5 * n_cells + c],
                                  feat, jx, jy, jz);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) feat[f] = jx[f] = jy[f] = jz[f] = 0.f;
  }
  if constexpr (MODE == K2_COALESCED) {
#pragma unroll
    for (int f = 0; f < F; ++f) feats[f * n_cells + i] = feat[f];
  } else {
    float* fo = feats + n * ((int64_t)Lw * F) + (int64_t)l * F;
#pragma unroll
    for (int f = 0; f < F; ++f) fo[f] = feat[f];
  }
  if (JAC && MODE != K2_NO_JAC_STORES) {
    const float sc = lf[6 * n_cells + c];
    const int64_t plane = N * (int64_t)Lw * Fj;
    float* jo = jac + n * ((int64_t)Lw * Fj) + (int64_t)l * Fj;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      if (f < jac_lo || f >= jac_lo + Fj) continue;
      const int o = f - jac_lo;
      jo[o] = jx[f] * sc;
      jo[plane + o] = jy[f] * sc;
      jo[2 * plane + o] = jz[f] * sc;
    }
  }
}

template <int MODE, bool JAC>
int launch_k2(const void* table, int64_t n_rows, const void* rows,
              const void* lf, void* feats, void* jac, int Lw, int64_t N,
              cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks =
      (unsigned)(((int64_t)Lw * N + threads - 1) / threads);
  split_k2_kernel<MODE, __nv_bfloat16, kF, JAC><<<blocks, threads, 0, s>>>(
      (const __nv_bfloat16*)table, n_rows, (const int*)rows,
      (const float*)lf, (float*)feats, (float*)jac, Lw, N, kW, 0, kF);
  return (int)cudaGetLastError();
}

// brick_reduce_bwd_kernel before the tiled form (brickreduce.cu), F = Fj
// = 8, with the K2BwdMode stubs. No early return: K2B_NO_ATOMICS reduces
// over the whole block.
template <int MODE, bool JAC, bool BF16>
__global__ void __launch_bounds__(256)
    split_k2b_kernel(float* __restrict__ grad, float* __restrict__ scratch,
                     int64_t n_rows, const int* __restrict__ rows,
                     const float* __restrict__ lf,
                     const float* __restrict__ df,
                     const float* __restrict__ dj, int Lw, int64_t N) {
  constexpr int F = kF;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n_cells = (int64_t)Lw * N;
  float sum = 0.f;   // K2B_NO_ATOMICS: what the atomics would have added
  if (i < n_cells) {
    const int64_t n = i / Lw;
    const int l = (int)(i - n * Lw);
    const int64_t c = MODE == K2B_CONTIGUOUS ? i : (int64_t)l * N + n;
    const float lx = lf[c], ly = lf[n_cells + c], lz = lf[2 * n_cells + c];
    const int r = rows[c];
    if (ingp_local_ok(lx, ly, lz) && r >= 0 && r < n_rows) {
      const float fx = lf[3 * n_cells + c], fy = lf[4 * n_cells + c],
                  fz = lf[5 * n_cells + c], sc = lf[6 * n_cells + c];
      const int64_t plane = n_cells * F;
      float dfv[F], jx[F], jy[F], jz[F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        // K2B_CONTIGUOUS: feature-major, df[f*cells + i]; else the
        // cell's own F values at i*F (4*F-byte stride across the warp)
        const int64_t o = MODE == K2B_CONTIGUOUS ? f * n_cells + i
                                                 : i * F + f;
        dfv[f] = df[o];
        jx[f] = JAC ? dj[o] : 0.f;
        jy[f] = JAC ? dj[plane + o] : 0.f;
        jz[f] = JAC ? dj[2 * plane + o] : 0.f;
      }
      float* row = grad + (int64_t)r * kW;
      const int ix = (int)lx, iy = (int)ly, iz = (int)lz;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int a = k >> 2, b = (k >> 1) & 1, e = k & 1;
        float w, d1, d2, d3, v[F];
        ingp_point_planes(a, b, e, fx, fy, fz, w, d1, d2, d3);
        float* pt = row + (9 * (ix + a) + 3 * (iy + b) + (iz + e)) * F;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          v[f] = ingp_lane_ct(dfv[f], w, JAC, jx[f], jy[f], jz[f], d1, d2,
                              d3, sc);
          if (BF16) v[f] = ingp_round_bf16(v[f]);
        }
        if constexpr (MODE == K2B_NO_ATOMICS) {
#pragma unroll
          for (int f = 0; f < F; ++f) sum += v[f];
        } else if constexpr (MODE == K2B_VECTOR) {
          bool any = false;
#pragma unroll
          for (int f = 0; f < F; ++f) any |= v[f] != 0.f;
          if (any) ingp_red_point<F>(pt, v);
        } else {
#pragma unroll
          for (int f = 0; f < F; ++f)
            if (v[f] != 0.f) atomicAdd(pt + f, v[f]);
        }
      }
    }
  }
  if constexpr (MODE == K2B_NO_ATOMICS) {
    __shared__ float s_sum[8];
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if ((threadIdx.x & 31) == 0) s_sum[threadIdx.x >> 5] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) t += s_sum[w];
      scratch[blockIdx.x] = t;
    }
  }
}

template <int MODE>
int launch_k2b(int with_jac, int bf16, void* grad, void* scratch,
               int64_t n_rows, const void* rows, const void* lf,
               const void* df, const void* dj, int Lw, int64_t N,
               cudaStream_t s) {
  const unsigned blocks = (unsigned)(((int64_t)Lw * N + 255) / 256);
#define K2B_ARGS                                                          \
  (float*)grad, (float*)scratch, n_rows, (const int*)rows,                \
      (const float*)lf, (const float*)df, (const float*)dj, Lw, N
  if (with_jac) {
    if (bf16) split_k2b_kernel<MODE, true, true><<<blocks, 256, 0, s>>>(K2B_ARGS);
    else split_k2b_kernel<MODE, true, false><<<blocks, 256, 0, s>>>(K2B_ARGS);
  } else {
    if (bf16) split_k2b_kernel<MODE, false, true><<<blocks, 256, 0, s>>>(K2B_ARGS);
    else split_k2b_kernel<MODE, false, false><<<blocks, 256, 0, s>>>(K2B_ARGS);
  }
#undef K2B_ARGS
  return (int)cudaGetLastError();
}

// composite_bwd_kernel before the warp-per-ray form (composite.cu),
// unchanged: one thread walks one ray twice.
__global__ void __launch_bounds__(128)
    split_k3b_kernel(const float* __restrict__ sig,
                     const float* __restrict__ dt,
                     const float* __restrict__ ts,
                     const unsigned char* __restrict__ valid,
                     const float* __restrict__ rgbs,
                     const float* __restrict__ aux, int C, float thr, int R,
                     int S, const float* __restrict__ dws,
                     const float* __restrict__ dO,
                     const float* __restrict__ dD,
                     const float* __restrict__ dC,
                     const float* __restrict__ dAux,
                     float* __restrict__ dsig, float* __restrict__ drgb,
                     float* __restrict__ daux) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t base = (int64_t)r * S;
  const int64_t plane = (int64_t)R * S;
  const float* dA = dAux + (int64_t)r * C;
  const float dC0 = dC[3 * r], dC1 = dC[3 * r + 1], dC2 = dC[3 * r + 2];
  // dL/dws of sample i with the aux cotangents folded in
  auto dws_eff = [&](int64_t i) {
    float v = dws[i];
    for (int c = 0; c < C; ++c) v += dA[c] * aux[c * plane + i];
    return v;
  };
  float csum = 0.f, O = 0.f, D = 0.f, C0 = 0.f, C1 = 0.f, C2 = 0.f,
        Wd = 0.f;
  for (int s = 0; s < S; ++s) {
    const int64_t i = base + s;
    const bool v = valid[i] != 0;
    const float sd = v ? sig[i] * dt[i] : 0.f;
    csum += sd;
    const float T = expf(-(csum - sd));
    const float w = (v && T > thr) ? (1.f - expf(-sd)) * T : 0.f;
    O += w;
    D += w * ts[i];
    C0 += w * rgbs[i];
    C1 += w * rgbs[plane + i];
    C2 += w * rgbs[2 * plane + i];
    Wd += dws_eff(i) * w;
  }
  const float dOr = dO[r], dDr = dD[r];
  csum = 0.f;
  float pD = 0.f, p0 = 0.f, p1 = 0.f, p2 = 0.f, pW = 0.f;
  for (int s = 0; s < S; ++s) {
    const int64_t i = base + s;
    const bool v = valid[i] != 0;
    const float sd = v ? sig[i] * dt[i] : 0.f;
    csum += sd;
    const float T = expf(-(csum - sd));
    const bool inc = v && T > thr;
    const float alpha = 1.f - expf(-sd);
    const float w = inc ? alpha * T : 0.f;
    const float Ta = T * (1.f - alpha);
    const float t = ts[i];
    const float r0 = rgbs[i], r1 = rgbs[plane + i], r2 = rgbs[2 * plane + i];
    const float de = dws_eff(i);
    pD += w * t;
    p0 += w * r0;
    p1 += w * r1;
    p2 += w * r2;
    pW += de * w;
    float acc = dOr * (1.f - O) + dDr * (t * Ta - (D - pD));
    acc = acc + Ta * de - (Wd - pW);
    acc = acc + dC0 * (r0 * Ta - (C0 - p0));
    acc = acc + dC1 * (r1 * Ta - (C1 - p1));
    acc = acc + dC2 * (r2 * Ta - (C2 - p2));
    dsig[i] = inc ? dt[i] * acc : 0.f;
    drgb[i] = dC0 * w;
    drgb[plane + i] = dC1 * w;
    drgb[2 * plane + i] = dC2 * w;
    for (int c = 0; c < C; ++c) daux[c * plane + i] = dA[c] * w;
  }
}

// composite_fwd_kernel before the group-per-ray form (composite.cu),
// unchanged: one thread walks one ray.
__global__ void __launch_bounds__(128)
    split_k3f_kernel(const float* __restrict__ sig,
                     const float* __restrict__ dt,
                     const float* __restrict__ ts,
                     const unsigned char* __restrict__ valid,
                     const float* __restrict__ rgbs,
                     const float* __restrict__ aux, int C, float thr, int R,
                     int S, float* __restrict__ ws, float* __restrict__ Ts,
                     float* __restrict__ opacity, float* __restrict__ depth,
                     float* __restrict__ rgb_out,
                     float* __restrict__ aux_out, int* __restrict__ count) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t base = (int64_t)r * S;
  const int64_t plane = (int64_t)R * S;
  float csum = 0.f, op = 0.f, dp = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
  int n = 0;
  for (int s = 0; s < S; ++s) {
    const int64_t i = base + s;
    const bool v = valid[i] != 0;
    const float sd = k3_sd(v, sig[i], dt[i]);
    csum = __fadd_rn(csum, sd);
    const float T = k3_T(csum, sd);
    const float w = (v && T > thr) ? (1.f - expf(-sd)) * T : 0.f;
    ws[i] = w;
    if (Ts) Ts[i] = T;
    op += w;
    dp = fmaf(w, ts[i], dp);
    n += w > 0.f;
    if (rgbs) {
      c0 = fmaf(w, rgbs[i], c0);
      c1 = fmaf(w, rgbs[plane + i], c1);
      c2 = fmaf(w, rgbs[2 * plane + i], c2);
    }
  }
  opacity[r] = op;
  depth[r] = dp;
  count[r] = n;
  if (rgbs) {
    rgb_out[3 * r] = c0;
    rgb_out[3 * r + 1] = c1;
    rgb_out[3 * r + 2] = c2;
  }
  for (int c = 0; c < C; ++c) {
    const float* a = aux + c * plane + base;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc = fmaf(ws[base + s], a[s], acc);
    aux_out[(int64_t)r * C + c] = acc;
  }
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
// dj (24, B, K) f32, or null for FULL (no jacobian cotangent);
// K <= 256 for STAGED. mode: BwdMode; bf16: round
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
  if (dj == nullptr && mode != B_FULL) return (int)cudaErrorInvalidValue;
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

// table (n_rows, 256) bf16; rows (Lw, N) int32; lf (8, Lw, N) f32;
// feats (N, Lw*8) f32, or (8, N*Lw) for K2_COALESCED; jac (3, N, Lw*8)
// f32 with with_jac (not written by K2_NO_JAC_STORES, which needs
// with_jac), else null. mode: K2Mode. Returns cudaGetLastError().
extern "C" int ingp_probe_split_k2(int mode, int with_jac,
                                   const void* table, int64_t n_rows,
                                   const void* rows, const void* lf,
                                   void* feats, void* jac, int Lw,
                                   int64_t N, void* stream) {
  if ((int64_t)Lw * N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define ARGS table, n_rows, rows, lf, feats, jac, Lw, N, s
  if (with_jac) {
    switch (mode) {
      case K2_FULL: return launch_k2<K2_FULL, true>(ARGS);
      case K2_NO_CORNERS: return launch_k2<K2_NO_CORNERS, true>(ARGS);
      case K2_NO_JAC_STORES: return launch_k2<K2_NO_JAC_STORES, true>(ARGS);
      case K2_COALESCED: return launch_k2<K2_COALESCED, true>(ARGS);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (mode) {
    case K2_FULL: return launch_k2<K2_FULL, false>(ARGS);
    case K2_NO_CORNERS: return launch_k2<K2_NO_CORNERS, false>(ARGS);
    case K2_COALESCED: return launch_k2<K2_COALESCED, false>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

// grad (n_rows, 256) f32, accumulated into (all modes but
// K2B_NO_ATOMICS); scratch (ceil(Lw*N / 256),) f32, written by
// K2B_NO_ATOMICS only (else null); rows (Lw, N) int32; lf (8, Lw, N) f32;
// df (N, Lw*8) f32; dj (3, N, Lw*8) f32 with with_jac, else null. bf16:
// round each cell's lane cotangent to bf16 first. mode: K2BwdMode.
// Returns cudaGetLastError().
extern "C" int ingp_probe_split_k2b(int mode, int with_jac, int bf16,
                                    void* grad, void* scratch,
                                    int64_t n_rows, const void* rows,
                                    const void* lf, const void* df,
                                    const void* dj, int Lw, int64_t N,
                                    void* stream) {
  if ((int64_t)Lw * N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define ARGS with_jac, bf16, grad, scratch, n_rows, rows, lf, df, dj, Lw, N, s
  switch (mode) {
    case K2B_FULL: return launch_k2b<K2B_FULL>(ARGS);
    case K2B_NO_ATOMICS: return launch_k2b<K2B_NO_ATOMICS>(ARGS);
    case K2B_CONTIGUOUS: return launch_k2b<K2B_CONTIGUOUS>(ARGS);
    case K2B_VECTOR: return launch_k2b<K2B_VECTOR>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

// The arguments of ingp_composite_bwd (composite.cu). Returns
// cudaGetLastError().
extern "C" int ingp_probe_split_k3b(const void* sigmas, const void* deltas,
                                    const void* ts, const void* valid,
                                    const void* rgbs, const void* aux,
                                    int C, float thr, int R, int S,
                                    const void* dws, const void* dO,
                                    const void* dD, const void* dC,
                                    const void* dAux, void* dsig,
                                    void* drgb, void* daux, void* stream) {
  if (R == 0) return 0;
  split_k3b_kernel<<<(R + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const float*)sigmas, (const float*)deltas, (const float*)ts,
      (const unsigned char*)valid, (const float*)rgbs, (const float*)aux, C,
      thr, R, S, (const float*)dws, (const float*)dO, (const float*)dD,
      (const float*)dC, (const float*)dAux, (float*)dsig, (float*)drgb,
      (float*)daux);
  return (int)cudaGetLastError();
}

// The arguments of ingp_composite_fwd (composite.cu), ts and depth not
// null. Returns cudaGetLastError().
extern "C" int ingp_probe_split_k3f(const void* sigmas, const void* deltas,
                                    const void* ts, const void* valid,
                                    const void* rgbs, const void* aux,
                                    int C, float thr, int R, int S,
                                    void* ws, void* Ts, void* opacity,
                                    void* depth, void* rgb_out,
                                    void* aux_out, void* count,
                                    void* stream) {
  if (R == 0) return 0;
  split_k3f_kernel<<<(R + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const float*)sigmas, (const float*)deltas, (const float*)ts,
      (const unsigned char*)valid, (const float*)rgbs, (const float*)aux, C,
      thr, R, S, (float*)ws, (float*)Ts, (float*)opacity, (float*)depth,
      (float*)rgb_out, (float*)aux_out, (int*)count);
  return (int)cudaGetLastError();
}
