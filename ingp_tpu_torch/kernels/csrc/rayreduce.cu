// K1 forward: fused unique-row expand + trilerp reduce.
//
// Replaces ingp_tpu/ops/pallas/rayreduce_pallas.py fused_ray_reduce
// (_fwd_kernel). The TPU kernel expands unique rows, gathered beforehand
// into a (B, U, W) block, with a one-hot MXU matmul because Mosaic has
// no vector gather. Here each thread takes one (batch row b, cell k),
// reads uid[b, k], the table row urows[b, uid] and the 8 trilerp corners
// of that row straight from the storage table, and writes feats (F, B, K)
// and, with JAC, jac (3*Fj, B, K) = scale * d feats / d frac over
// [jac_lo, jac_lo+Fj). The unique-row block is never materialised.
//
// Bound on the H100: bytes. Each cell reads 8 corner points (8*F
// values) of a row that neighbouring cells of the same run share, plus
// 6-7 floats of lf, one uid and one row id, and writes F (+3*Fj) floats;
// there are ~2 FMAs per byte moved. The design reads the corner points
// with 16-byte loads, keeps the accumulators in registers, lets the
// L1/L2 caches serve the rows that cells of one run share, and writes
// the feature-major outputs coalesced along k.
#include "trilerp.cuh"

namespace {

template <typename T, int F, bool JAC>
__global__ void __launch_bounds__(256)
    ray_reduce_fwd_kernel(const T* __restrict__ table, int64_t n_rows,
                          const int* __restrict__ urows,
                          const int* __restrict__ uid,
                          const float* __restrict__ lf,
                          float* __restrict__ feats, float* __restrict__ jac,
                          int64_t n_cells, int K, int U, int W, int jac_lo,
                          int Fj) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  const float lx = lf[i], ly = lf[n_cells + i], lz = lf[2 * n_cells + i];
  const int u = uid[i];
  const int r = (u >= 0 && u < U) ? urows[(i / K) * U + u] : -1;
  float feat[F], jx[F], jy[F], jz[F];
  if (ingp_local_ok(lx, ly, lz) && r >= 0 && r < n_rows) {
    ingp_trilerp_row<T, F, JAC>(table + (int64_t)r * W, (int)lx, (int)ly,
                                (int)lz, lf[3 * n_cells + i],
                                lf[4 * n_cells + i], lf[5 * n_cells + i],
                                feat, jx, jy, jz);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) feat[f] = jx[f] = jy[f] = jz[f] = 0.f;
  }
#pragma unroll
  for (int f = 0; f < F; ++f) feats[f * n_cells + i] = feat[f];
  if (JAC) {
    const float sc = lf[6 * n_cells + i];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      if (f < jac_lo || f >= jac_lo + Fj) continue;
      const int o = f - jac_lo;
      jac[(int64_t)o * n_cells + i] = jx[f] * sc;
      jac[(int64_t)(Fj + o) * n_cells + i] = jy[f] * sc;
      jac[(int64_t)(2 * Fj + o) * n_cells + i] = jz[f] * sc;
    }
  }
}

template <typename T, int F>
void launch(const void* table, int64_t n_rows, const void* urows,
            const void* uid, const void* lf, void* feats, void* jac,
            int64_t n_cells, int K, int U, int W, int with_jac, int jac_lo,
            int Fj, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_cells + threads - 1) / threads);
  if (with_jac)
    ray_reduce_fwd_kernel<T, F, true><<<blocks, threads, 0, stream>>>(
        (const T*)table, n_rows, (const int*)urows, (const int*)uid,
        (const float*)lf, (float*)feats, (float*)jac, n_cells, K, U, W,
        jac_lo, Fj);
  else
    ray_reduce_fwd_kernel<T, F, false><<<blocks, threads, 0, stream>>>(
        (const T*)table, n_rows, (const int*)urows, (const int*)uid,
        (const float*)lf, (float*)feats, (float*)jac, n_cells, K, U, W,
        jac_lo, Fj);
}

template <typename T>
int dispatch(int F, const void* table, int64_t n_rows, const void* urows,
             const void* uid, const void* lf, void* feats, void* jac,
             int64_t n_cells, int K, int U, int W, int with_jac, int jac_lo,
             int Fj, cudaStream_t s) {
  switch (F) {
    case 2: launch<T, 2>(table, n_rows, urows, uid, lf, feats, jac,
                         n_cells, K, U, W, with_jac, jac_lo, Fj, s); break;
    case 4: launch<T, 4>(table, n_rows, urows, uid, lf, feats, jac,
                         n_cells, K, U, W, with_jac, jac_lo, Fj, s); break;
    case 8: launch<T, 8>(table, n_rows, urows, uid, lf, feats, jac,
                         n_cells, K, U, W, with_jac, jac_lo, Fj, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// table (n_rows, W) of dtype t_bf16 ? bf16 : f32; urows (B, U) int32;
// uid (B, K) int32; lf (8, B, K) f32; feats (F, B, K) f32;
// jac (3*Fj, B, K) f32 or null.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int ingp_ray_reduce_fwd(const void* table, int t_bf16,
                                   int64_t n_rows, const void* urows,
                                   const void* uid, const void* lf,
                                   void* feats, void* jac, int64_t B, int K,
                                   int U, int W, int F, int with_jac,
                                   int jac_lo, int Fj, void* stream) {
  const int64_t n_cells = B * (int64_t)K;
  if (n_cells == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return t_bf16 ? dispatch<__nv_bfloat16>(F, table, n_rows, urows, uid, lf,
                                          feats, jac, n_cells, K, U, W,
                                          with_jac, jac_lo, Fj, s)
                : dispatch<float>(F, table, n_rows, urows, uid, lf, feats,
                                  jac, n_cells, K, U, W, with_jac, jac_lo,
                                  Fj, s);
}
