// K2 forward: per-sample brick trilerp reduce with the table gather
// fused in.
//
// Replaces ingp_tpu/ops/pallas/brickreduce_pallas.py fused_brick_reduce
// (_fwd_kernel), which reduces rows that XLA has already gathered into
// an (n, W) block. Here the kernel takes the storage table, the
// per-(level, sample) row ids and lf, and each thread gathers only the 8
// corner points it needs of its row, so the (n, W) block is never
// written to or read back from device memory.
//
// Bound on the H100: bytes. Per (level, sample) cell it reads one row
// id, 8 floats of lf and 8 corner points (8*F values, 16-byte loads) of
// a table row that is mostly cold (fine levels are hashed), and writes
// F (+3*Fj) floats. Threads are ordered level-fastest, so the F floats
// a thread writes for consecutive levels of one sample are contiguous
// in the (N, Lw*F) output layout that reduce_feats_jac returns.
#include "trilerp.cuh"

namespace {

template <typename T, int F, bool JAC>
__global__ void __launch_bounds__(256)
    brick_reduce_fwd_kernel(const T* __restrict__ table, int64_t n_rows,
                            const int* __restrict__ rows,
                            const float* __restrict__ lf,
                            float* __restrict__ feats,
                            float* __restrict__ jac, int Lw, int64_t N,
                            int W, int jac_lo, int Fj) {
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
    ingp_trilerp_row<T, F, JAC>(table + (int64_t)r * W, (int)lx, (int)ly,
                                (int)lz, lf[3 * n_cells + c],
                                lf[4 * n_cells + c], lf[5 * n_cells + c],
                                feat, jx, jy, jz);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) feat[f] = jx[f] = jy[f] = jz[f] = 0.f;
  }
  float* fo = feats + n * ((int64_t)Lw * F) + (int64_t)l * F;
#pragma unroll
  for (int f = 0; f < F; ++f) fo[f] = feat[f];
  if (JAC) {
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

template <typename T, int F>
void launch(const void* table, int64_t n_rows, const void* rows,
            const void* lf, void* feats, void* jac, int Lw, int64_t N,
            int W, int with_jac, int jac_lo, int Fj, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks =
      (unsigned)(((int64_t)Lw * N + threads - 1) / threads);
  if (with_jac)
    brick_reduce_fwd_kernel<T, F, true><<<blocks, threads, 0, stream>>>(
        (const T*)table, n_rows, (const int*)rows, (const float*)lf,
        (float*)feats, (float*)jac, Lw, N, W, jac_lo, Fj);
  else
    brick_reduce_fwd_kernel<T, F, false><<<blocks, threads, 0, stream>>>(
        (const T*)table, n_rows, (const int*)rows, (const float*)lf,
        (float*)feats, (float*)jac, Lw, N, W, jac_lo, Fj);
}

template <typename T>
int dispatch(int F, const void* table, int64_t n_rows, const void* rows,
             const void* lf, void* feats, void* jac, int Lw, int64_t N,
             int W, int with_jac, int jac_lo, int Fj, cudaStream_t s) {
  switch (F) {
    case 2: launch<T, 2>(table, n_rows, rows, lf, feats, jac, Lw, N, W,
                         with_jac, jac_lo, Fj, s); break;
    case 4: launch<T, 4>(table, n_rows, rows, lf, feats, jac, Lw, N, W,
                         with_jac, jac_lo, Fj, s); break;
    case 8: launch<T, 8>(table, n_rows, rows, lf, feats, jac, Lw, N, W,
                         with_jac, jac_lo, Fj, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// table (n_rows, W) of dtype t_bf16 ? bf16 : f32; rows (Lw, N) int32;
// lf (8, Lw, N) f32; feats (N, Lw*F) f32; jac (3, N, Lw*Fj) f32 or null.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int ingp_brick_reduce_fwd(const void* table, int t_bf16,
                                     int64_t n_rows, const void* rows,
                                     const void* lf, void* feats, void* jac,
                                     int Lw, int64_t N, int W, int F,
                                     int with_jac, int jac_lo, int Fj,
                                     void* stream) {
  if ((int64_t)Lw * N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return t_bf16 ? dispatch<__nv_bfloat16>(F, table, n_rows, rows, lf, feats,
                                          jac, Lw, N, W, with_jac, jac_lo,
                                          Fj, s)
                : dispatch<float>(F, table, n_rows, rows, lf, feats, jac, Lw,
                                  N, W, with_jac, jac_lo, Fj, s);
}
