// K2 forward: per-sample brick trilerp reduce with the table gather
// fused in.
//
// Replaces ingp_tpu/ops/pallas/brickreduce_pallas.py fused_brick_reduce
// (_fwd_kernel), which reduces rows that XLA has already gathered into
// an (n, W) block. Here the kernel takes the storage table, the
// per-(level, sample) row ids and lf, and gathers only the 8 corner
// points each cell needs of its row, so the (n, W) block is never
// written to or read back from device memory.
//
// Bound on the H100: bytes. Per (level, sample) cell it reads one row
// id, 7 floats of lf and 8 corner points (8*F values, 16-byte loads) of
// a table row that is mostly cold (fine levels are hashed), and writes
// F (+3*Fj) floats. The outputs are sample-major, (N, Lw*F) and
// (3, N, Lw*Fj), while the inputs are level-major, (Lw, N) and
// (8, Lw, N): a thread per cell in either order makes one side of the
// kernel strided. So a block owns a tile of S consecutive samples x
// all Lw levels (S*Lw = 256 cells) and moves both sides through shared
// memory:
//   1. rows and the 7 lf planes, sample-fastest: each warp load is
//      coalesced at any Lw;
//   2. a thread per cell, level-fastest, gathers its 8 corners
//      (ingp_trilerp_row: every load issued before the sums) and puts
//      its F (+3*Fj) results into shared memory in the output's
//      (sample, level, feature) order. The staged inputs' level stride
//      is padded so that these reads hit 32 distinct banks when Lw
//      divides 32;
//   3. the tile's outputs are contiguous slabs, S*Lw*F floats of feats
//      and S*Lw*Fj of each jac plane: the block writes each with
//      16-byte coalesced stores (scalar stores for an unaligned head
//      and tail: the ragged last tile, a jac plane of odd length).
// The old form (a thread per cell, level-fastest, reading lf at
// stride N and writing each output float with a scalar store at a
// 4*F-byte stride across the warp) survives as the K2 split probe's
// `full` variant (probe_split.cu) for before/after timing.
//
// K2 backward (ingp_brick_reduce_bwd): replaces brickreduce_pallas.py
// _fbr_bwd (_bwd_kernel), which writes the cotangent of the gathered
// (n, W) row block for the gather's backward to scatter-add into the
// table. The forward here fused the gather, so the backward fuses the
// scatter: each (level, sample) cell computes the per-lane cotangent
// df*w + ((jx*d1 + jy*d2) + jz*d3) * scale of its 8 corner points x F
// features and adds it into the f32 master gradient row rows[l, n]. With
// BF16 each cell's lane values are rounded to bf16 before any sum (the
// JAX path's bf16 gathered block has a bf16 cotangent per cell).
//
// Bound on the H100: bytes. Per cell: one row id, 6 lf floats (7 with a
// jacobian), F (+3*Fj) cotangent floats, and a read-modify-write of the
// master points it touches. The old form (a thread per cell,
// level-fastest: lf and rows read at stride N, df and dj read with
// scalar loads at a 4*F-byte stride, 8*F scalar atomics per cell; the
// K2 bwd split's `full`, probe_split.cu) spent its time on its 64
// scalar atomics per cell: the split's no-atomics stub takes 73-97% of
// it away, reading the same bytes coalesced -8% to +2%. On training's
// inputs a run of consecutive samples at one level on one row holds
// ~1.3 real cells, so summing runs before the flush would save few
// atomics; the streams' zero-padded tail (one long run of zero
// cotangents) adds nothing. So a block owns a tile of S samples x Lw
// levels (S*Lw <= 256 cells, k2_tile_samples) and
//   1. copies the tile's df rows and each dj plane's rows (contiguous
//      slabs of Lw*F and Lw*Fj floats at the caller's row stride: the
//      backward of torch.cat hands over column slices) into shared
//      memory with 16-byte loads, at a padded row stride whose 16-byte
//      words fall in distinct banks for 8 consecutive samples;
//   2. a thread per cell, level-major (sample-fastest, so its row id
//      and lf loads are coalesced), computes its 8 corners' F lane
//      values from the staged cotangents and adds each corner with
//      16-byte vector atomics (ingp_red_point: 2 per corner at F = 8, 16
//      per cell instead of 64), skipping a corner whose lanes are all 0
//      and a cell whose cotangents are all 0 (the padded tail, most of a
//      training launch's cells).
// The vector atomics still take most of the time left (the split's
// no-atomics stub).
//
// K2 backward's position-cotangent variant (POS,
// ingp_brick_reduce_bwd_and_pos): the same tiled kernel also writes each
// (level, sample) cell's cotangent of its fractional position frac,
// which JAX's XLA form of the reduce gives through AD (its Pallas form,
// _fbr_bwd, returns a zero lf cotangent). With pose refinement the
// sample positions depend on the refined poses, so the wrapper launches
// the variant in place of the plain backward whenever lf requires a
// gradient; no other run launches it. Per cell, over its 8 corner points
// v:
//   dfrac_a = sum d_a w_b w_c <v, df>
//             + scale * (d_a d_b w_c <v_j, dj_b> + d_a d_c w_b <v_j, dj_c>)
// ({a, b, c} the axes, w the corner's weight along an axis, d = dw/dfrac
// = -1 or +1; the trilinear weight has no pure second derivative), the
// jacobian term on the window [jac_lo, jac_lo + Fj).
// Bound on the H100: bytes. Of what a cell needs (its row id, lf, F +
// 3*Fj cotangent floats, 8 corner points of the storage row, 3 output
// floats) all but the corner points and the output are what the table
// backward reads for the same cell: at F = 8 about 26 of ~198 bytes a
// cell are corner points. The kernel this replaces was a second launch
// on the same inputs, a thread per cell reading its cotangent rows with
// scalar loads at a 4*F-byte stride across the warp, and it held all F
// lanes of the jacobian cotangent in registers and loaded the corners of
// cells whose cotangents are all zero. Fused, a live cell reuses step
// 1's staged cotangents (only the window's lanes) and its row id and lf
// loads, issues each corner point's load ahead of that corner's atomics,
// and writes its 3 floats at c, n_cells + c and 2 n_cells + c, coalesced
// since the threads run sample-fastest; a cell that is not live
// (all-zero cotangents, -9, a row outside the table) loads no corner and
// writes exact zeros. The variant's added cost is bound by the live
// cells' corner points and 12 bytes a cell. On an H100 at 700 W, from
// CUDA graphs on pose refinement's inputs, the variant takes 0.69-0.84
// of the time of the two launches it replaces, with dpos bit for bit
// theirs.
#include <type_traits>

#include "trilerp.cuh"

namespace {

constexpr int kK2Threads = 256;   // threads per block, and cells per tile

// the storage table's element type in the K2 backward: bf16 with BF16
template <bool BF16>
using k2b_storage_t = std::conditional_t<BF16, __nv_bfloat16, float>;

// Samples per tile: S samples x Lw levels fill the block's 256 cells.
__host__ __device__ __forceinline__ int k2_tile_samples(int Lw) {
  return Lw >= kK2Threads ? 1 : kK2Threads / Lw;
}

// Stride, in floats, of one level's S staged inputs. A warp of the
// level-fastest step 2 spans 32/Lw samples of each of the Lw levels;
// a stride of 32/Lw (mod 32) banks puts its 32 reads in 32 banks.
__host__ __device__ __forceinline__ int k2_level_stride(int Lw, int S) {
  if (32 % Lw) return S | 1;
  const int g = (32 / Lw) % 32;
  return S + (((g - S) % 32) + 32) % 32;
}

__host__ __device__ __forceinline__ int k2_round4(int n) {
  return (n + 3) & ~3;
}

// Shared memory of one block: the staged inputs (8 planes x Lw x P:
// lf planes 0-6 and the row ids), then feats (S*Lw*F) and the 3 jac
// planes (S*Lw*Fj each), each region a whole number of 16-byte words.
__host__ __forceinline__ size_t k2_smem_bytes(int Lw, int F, int Fj,
                                             bool jac) {
  const int S = k2_tile_samples(Lw), P = k2_level_stride(Lw, S);
  const int cells = S * Lw;
  return sizeof(float) * ((size_t)8 * Lw * P + k2_round4(cells * F) +
                          (jac ? 3 * (size_t)k2_round4(cells * Fj) : 0));
}

// F floats of registers into shared memory at dst (16-byte aligned for
// F = 4, 8, 16; 8-byte for F = 2).
template <int F>
__device__ __forceinline__ void k2_put(float* dst, const float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int i = 0; i < F / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < F / 2; ++i)
      reinterpret_cast<float2*>(dst)[i] = make_float2(v[2 * i], v[2 * i + 1]);
  }
}

// The block writes len floats of shared memory src to global dst: 16-byte
// stores from dst's first 16-byte boundary on, scalar stores before it
// and after the last whole word.
__device__ __forceinline__ void k2_store_slab(float* __restrict__ dst,
                                              const float* src, int len) {
  const int head = min(
      len, (int)(((16u - ((unsigned)(uintptr_t)dst & 15u)) & 15u) >> 2));
  const int n4 = (len - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  if (head == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const float* e = src + head + 4 * i;
      d4[i] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
  for (int i = head + 4 * n4 + threadIdx.x; i < len; i += blockDim.x)
    dst[i] = src[i];
}

template <typename T, int F, bool JAC>
__global__ void __launch_bounds__(kK2Threads)
    brick_reduce_fwd_kernel(const T* __restrict__ table, int64_t n_rows,
                            const int* __restrict__ rows,
                            const float* __restrict__ lf,
                            float* __restrict__ feats,
                            float* __restrict__ jac, int Lw, int64_t N,
                            int W, int jac_lo, int Fj) {
  extern __shared__ __align__(16) float k2_smem[];
  const int S = k2_tile_samples(Lw), P = k2_level_stride(Lw, S);
  const int cells = S * Lw;
  const int plane = Lw * P;                   // one staged input plane
  float* s_in = k2_smem;
  float* s_feat = s_in + 8 * plane;
  float* s_jac = s_feat + k2_round4(cells * F);
  const int jstride = k2_round4(cells * Fj);
  const int64_t n0 = (int64_t)blockIdx.x * S;
  const int s_eff = (int)min((int64_t)S, N - n0);   // the ragged last tile
  const int64_t n_cells = (int64_t)Lw * N;

  // 1. the tile's row ids and lf planes 0-6, sample-fastest
  for (int t = threadIdx.x; t < cells; t += blockDim.x) {
    const int l = t / S, n = t - l * S;
    if (n >= s_eff) continue;
    const int64_t c = (int64_t)l * N + n0 + n;
    const int o = l * P + n;
    s_in[7 * plane + o] = __int_as_float(rows[c]);
#pragma unroll
    for (int p = 0; p < 7; ++p) s_in[p * plane + o] = lf[p * n_cells + c];
  }
  __syncthreads();

  // 2. a thread per cell, level-fastest: t = n*Lw + l is also the cell's
  // place in the tile's output slabs
  for (int t = threadIdx.x; t < s_eff * Lw; t += blockDim.x) {
    const int n = t / Lw, l = t - n * Lw;
    const int o = l * P + n;
    const float lx = s_in[o], ly = s_in[plane + o], lz = s_in[2 * plane + o];
    const int r = __float_as_int(s_in[7 * plane + o]);
    float feat[F], jx[F], jy[F], jz[F];
    if (ingp_local_ok(lx, ly, lz) && r >= 0 && r < n_rows) {
      ingp_trilerp_row<T, F, JAC>(table + (int64_t)r * W, (int)lx, (int)ly,
                                  (int)lz, s_in[3 * plane + o],
                                  s_in[4 * plane + o], s_in[5 * plane + o],
                                  feat, jx, jy, jz);
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) feat[f] = jx[f] = jy[f] = jz[f] = 0.f;
    }
    k2_put<F>(s_feat + t * F, feat);
    if (JAC) {
      const float sc = s_in[6 * plane + o];
      if (jac_lo == 0 && Fj == F) {
#pragma unroll
        for (int f = 0; f < F; ++f) {
          jx[f] *= sc;
          jy[f] *= sc;
          jz[f] *= sc;
        }
        k2_put<F>(s_jac + t * F, jx);
        k2_put<F>(s_jac + jstride + t * F, jy);
        k2_put<F>(s_jac + 2 * jstride + t * F, jz);
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f) {
          if (f < jac_lo || f >= jac_lo + Fj) continue;
          const int e = t * Fj + f - jac_lo;
          s_jac[e] = jx[f] * sc;
          s_jac[jstride + e] = jy[f] * sc;
          s_jac[2 * jstride + e] = jz[f] * sc;
        }
      }
    }
  }
  __syncthreads();

  // 3. the tile's contiguous output slabs
  k2_store_slab(feats + n0 * Lw * F, s_feat, s_eff * Lw * F);
  if (JAC) {
    const int64_t jplane = N * (int64_t)Lw * Fj;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      k2_store_slab(jac + i * jplane + n0 * Lw * Fj, s_jac + i * jstride,
                    s_eff * Lw * Fj);
  }
}

template <typename T, int F, bool JAC>
int launch_fwd(const void* table, int64_t n_rows, const void* rows,
               const void* lf, void* feats, void* jac, int Lw, int64_t N,
               int W, int jac_lo, int Fj, cudaStream_t stream) {
  const size_t bytes = k2_smem_bytes(Lw, F, Fj, JAC);
  auto kernel = brick_reduce_fwd_kernel<T, F, JAC>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int S = k2_tile_samples(Lw);
  const unsigned blocks = (unsigned)((N + S - 1) / S);
  kernel<<<blocks, kK2Threads, bytes, stream>>>(
      (const T*)table, n_rows, (const int*)rows, (const float*)lf,
      (float*)feats, (float*)jac, Lw, N, W, jac_lo, Fj);
  return (int)cudaGetLastError();
}

template <typename T, int F>
int launch(const void* table, int64_t n_rows, const void* rows,
           const void* lf, void* feats, void* jac, int Lw, int64_t N, int W,
           int with_jac, int jac_lo, int Fj, cudaStream_t stream) {
  return with_jac ? launch_fwd<T, F, true>(table, n_rows, rows, lf, feats,
                                           jac, Lw, N, W, jac_lo, Fj, stream)
                  : launch_fwd<T, F, false>(table, n_rows, rows, lf, feats,
                                            jac, Lw, N, W, jac_lo, Fj,
                                            stream);
}

template <typename T>
int dispatch(int F, const void* table, int64_t n_rows, const void* rows,
             const void* lf, void* feats, void* jac, int Lw, int64_t N,
             int W, int with_jac, int jac_lo, int Fj, cudaStream_t s) {
  switch (F) {
    case 2: return launch<T, 2>(table, n_rows, rows, lf, feats, jac, Lw, N,
                                W, with_jac, jac_lo, Fj, s);
    case 4: return launch<T, 4>(table, n_rows, rows, lf, feats, jac, Lw, N,
                                W, with_jac, jac_lo, Fj, s);
    case 8: return launch<T, 8>(table, n_rows, rows, lf, feats, jac, Lw, N,
                                W, with_jac, jac_lo, Fj, s);
    case 16: return launch<T, 16>(table, n_rows, rows, lf, feats, jac, Lw,
                                  N, W, with_jac, jac_lo, Fj, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Floats between two staged cotangent rows of len floats: a whole number
// of 16-byte words, odd, so that 8 consecutive rows' words fall in 8
// distinct groups of 4 banks.
__host__ __device__ __forceinline__ int k2b_row_stride(int len) {
  const int q = k2_round4(len);
  return ((q >> 2) & 1) ? q : q + 4;
}

__host__ __forceinline__ size_t k2b_smem_bytes(int Lw, int F, int Fj,
                                              bool jac) {
  const int S = k2_tile_samples(Lw);
  return sizeof(float) * (size_t)S *
         (k2b_row_stride(Lw * F) + (jac ? 3 * k2b_row_stride(Lw * Fj) : 0));
}

// The block copies n rows of len floats, `stride` floats apart in global
// memory, into shared memory Q floats apart: 16-byte loads with vec
// (src 16-byte aligned, stride and len multiples of 4), else scalar.
__device__ __forceinline__ void k2b_stage(float* dst,
                                          const float* __restrict__ src,
                                          int64_t stride, int len, int Q,
                                          int n, bool vec) {
  if (vec) {
    const int w = len >> 2;
    for (int i = threadIdx.x; i < n * w; i += blockDim.x) {
      const int row = i / w, k = i - row * w;
      reinterpret_cast<float4*>(dst + row * Q)[k] =
          __ldg(reinterpret_cast<const float4*>(src + row * stride) + k);
    }
  } else {
    for (int i = threadIdx.x; i < n * len; i += blockDim.x) {
      const int row = i / len, k = i - row * len;
      dst[row * Q + k] = __ldg(src + row * stride + k);
    }
  }
}

// F floats of shared memory at p (16-byte aligned for F = 4, 8, 16;
// 8-byte for F = 2) into registers.
template <int F>
__device__ __forceinline__ void k2b_get(const float* p, float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int i = 0; i < F; i += 4) {
      const float4 q = reinterpret_cast<const float4*>(p)[i / 4];
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  }
}

// The position cotangent of one corner point v of a cell, added into
// g: s_df = <v, df> and s_j = <v_j, dj_k> over the jacobian window (FMAs
// in lane order), then per axis a d_a w_b w_e s_df + scale d_a (d_b w_e
// s_j[b] + d_e w_b s_j[e]). jx, jy, jz hold the cell's jacobian
// cotangent at its feature lanes.
template <int F, bool JAC>
__device__ __forceinline__ void k2b_pos_corner(
    int a, int b, int e, const float (&v)[F], const float (&dfv)[F],
    const float (&jx)[F], const float (&jy)[F], const float (&jz)[F],
    int jac_lo, int Fj, float fx, float fy, float fz, float sc,
    float (&g)[3]) {
  float s_df = 0.f, s_j[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int f = 0; f < F; ++f) {
    s_df = fmaf(v[f], dfv[f], s_df);
    if (JAC && f >= jac_lo && f < jac_lo + Fj) {
      s_j[0] = fmaf(v[f], jx[f], s_j[0]);
      s_j[1] = fmaf(v[f], jy[f], s_j[1]);
      s_j[2] = fmaf(v[f], jz[f], s_j[2]);
    }
  }
  const int o[3] = {a, b, e};
  const float fr[3] = {fx, fy, fz};
  float w[3], d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w[k] = o[k] ? fr[k] : 1.f - fr[k];
    d[k] = o[k] ? 1.f : -1.f;
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const int q = (p + 1) % 3, u = (p + 2) % 3;
    float t = d[p] * w[q] * w[u] * s_df;
    if (JAC) t += sc * d[p] * (d[q] * w[u] * s_j[q] + d[u] * w[q] * s_j[u]);
    g[p] += t;
  }
}

// vec: bit 0 the df rows, bit 1 the dj rows may be read with 16-byte
// loads. With POS the kernel also writes each cell's position cotangent
// dpos (3, Lw, N), reading the cell's 8 corner points of the storage
// table (bf16 with BF16, else f32); without it table and dpos are unused.
template <int F, bool JAC, bool BF16, bool POS>
__global__ void __launch_bounds__(kK2Threads)
    brick_reduce_bwd_kernel(float* __restrict__ grad, int64_t n_rows,
                            const int* __restrict__ rows,
                            const float* __restrict__ lf,
                            const float* __restrict__ df, int64_t df_stride,
                            const float* __restrict__ dj, int64_t dj_plane,
                            int64_t dj_stride, int Lw, int64_t N, int W,
                            int jac_lo, int Fj, int vec,
                            const k2b_storage_t<BF16>* __restrict__ table,
                            float* __restrict__ dpos) {
  extern __shared__ __align__(16) float k2b_smem[];
  const int S = k2_tile_samples(Lw);
  const int Qf = k2b_row_stride(Lw * F), Qj = k2b_row_stride(Lw * Fj);
  float* s_df = k2b_smem;
  float* s_dj = s_df + S * Qf;   // 3 planes of S*Qj
  const int64_t n0 = (int64_t)blockIdx.x * S;
  const int s_eff = (int)min((int64_t)S, N - n0);   // the ragged last tile
  const int64_t n_cells = (int64_t)Lw * N;

  // 1. the tile's cotangent rows
  k2b_stage(s_df, df + n0 * df_stride, df_stride, Lw * F, Qf, s_eff,
            vec & 1);
  if (JAC) {
#pragma unroll
    for (int p = 0; p < 3; ++p)
      k2b_stage(s_dj + p * S * Qj, dj + p * dj_plane + n0 * dj_stride,
                dj_stride, Lw * Fj, Qj, s_eff, vec & 2);
  }
  __syncthreads();

  // 2. a thread per cell, level-major: t = l*S + n
  const int t = threadIdx.x;
  const int l = t / S, n = t - l * S;
  if (l >= Lw || n >= s_eff) return;
  const int64_t c = (int64_t)l * N + n0 + n;
  // every load of the cell issued before its validity test
  const float lx = lf[c], ly = lf[n_cells + c], lz = lf[2 * n_cells + c];
  const float fx = lf[3 * n_cells + c], fy = lf[4 * n_cells + c],
              fz = lf[5 * n_cells + c];
  const float sc = JAC ? lf[6 * n_cells + c] : 0.f;
  const int r = rows[c];
  float dfv[F], jx[F], jy[F], jz[F];
  k2b_get<F>(s_df + n * Qf + l * F, dfv);
#pragma unroll
  for (int f = 0; f < F; ++f) jx[f] = jy[f] = jz[f] = 0.f;
  if (JAC) {
    const float* q = s_dj + n * Qj;
    if (jac_lo == 0 && Fj == F) {
      k2b_get<F>(q + l * F, jx);
      k2b_get<F>(q + S * Qj + l * F, jy);
      k2b_get<F>(q + 2 * S * Qj + l * F, jz);
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if (f < jac_lo || f >= jac_lo + Fj) continue;
        const int e = l * Fj + f - jac_lo;
        jx[f] = q[e];
        jy[f] = q[S * Qj + e];
        jz[f] = q[2 * S * Qj + e];
      }
    }
  }
  // a cell with all-zero cotangents (the streams' padded tail) adds
  // nothing: every lane value would be 0 (and so would its position
  // cotangent, written as exact zeros, as for a cell that reads no row)
  bool live = false;
#pragma unroll
  for (int f = 0; f < F; ++f)
    live |= dfv[f] != 0.f || jx[f] != 0.f || jy[f] != 0.f || jz[f] != 0.f;
  if (!live || !ingp_local_ok(lx, ly, lz) || r < 0 || r >= n_rows) {
    if constexpr (POS) {
      dpos[c] = 0.f;
      dpos[n_cells + c] = 0.f;
      dpos[2 * n_cells + c] = 0.f;
    }
    return;
  }
  float* row = grad + (int64_t)r * W;
  const int ix = (int)lx, iy = (int)ly, iz = (int)lz;
  float g[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int a = k >> 2, b = (k >> 1) & 1, e = k & 1;
    const int pt = 9 * (ix + a) + 3 * (iy + b) + (iz + e);
    // the corner point's load goes out before this corner's atomics
    float pv[POS ? F : 1];
    if constexpr (POS)
      ingp_load_point<k2b_storage_t<BF16>, F>(
          table + ((int64_t)r * W + pt * F), pv);
    float w, d1, d2, d3, v[F];
    ingp_point_planes(a, b, e, fx, fy, fz, w, d1, d2, d3);
    bool any = false;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const bool in_win = JAC && f >= jac_lo && f < jac_lo + Fj;
      v[f] = ingp_lane_ct(dfv[f], w, in_win, jx[f], jy[f], jz[f], d1, d2,
                          d3, sc);
      if (BF16) v[f] = ingp_round_bf16(v[f]);
      any |= v[f] != 0.f;
    }
    if (any) ingp_red_point<F>(row + pt * F, v);
    if constexpr (POS)
      k2b_pos_corner<F, JAC>(a, b, e, pv, dfv, jx, jy, jz, jac_lo, Fj, fx,
                             fy, fz, sc, g);
  }
  if constexpr (POS) {
    dpos[c] = g[0];
    dpos[n_cells + c] = g[1];
    dpos[2 * n_cells + c] = g[2];
  }
}

template <int F, bool JAC, bool BF16, bool POS>
int launch_bwd(void* grad, int64_t n_rows, const void* rows, const void* lf,
               const void* df, int64_t df_stride, const void* dj,
               int64_t dj_plane, int64_t dj_stride, int Lw, int64_t N,
               int W, int jac_lo, int Fj, int vec, const void* table,
               void* dpos, cudaStream_t s) {
  const size_t bytes = k2b_smem_bytes(Lw, F, Fj, JAC);
  auto kernel = brick_reduce_bwd_kernel<F, JAC, BF16, POS>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int S = k2_tile_samples(Lw);
  kernel<<<(unsigned)((N + S - 1) / S), kK2Threads, bytes, s>>>(
      (float*)grad, n_rows, (const int*)rows, (const float*)lf,
      (const float*)df, df_stride, (const float*)dj, dj_plane, dj_stride,
      Lw, N, W, jac_lo, Fj, vec, (const k2b_storage_t<BF16>*)table,
      (float*)dpos);
  return (int)cudaGetLastError();
}

template <int F, bool POS>
int dispatch_bwd(int with_jac, int bf16, void* grad, int64_t n_rows,
                 const void* rows, const void* lf, const void* df,
                 int64_t df_stride, const void* dj, int64_t dj_plane,
                 int64_t dj_stride, int Lw, int64_t N, int W, int jac_lo,
                 int Fj, int vec, const void* table, void* dpos,
                 cudaStream_t s) {
#define BWD_ARGS                                                       \
  grad, n_rows, rows, lf, df, df_stride, dj, dj_plane, dj_stride, Lw, N, \
      W, jac_lo, Fj, vec, table, dpos, s
  if (with_jac)
    return bf16 ? launch_bwd<F, true, true, POS>(BWD_ARGS)
                : launch_bwd<F, true, false, POS>(BWD_ARGS);
  return bf16 ? launch_bwd<F, false, true, POS>(BWD_ARGS)
              : launch_bwd<F, false, false, POS>(BWD_ARGS);
#undef BWD_ARGS
}

template <bool POS>
int dispatch_bwd_f(int F, int with_jac, int bf16, void* grad,
                   int64_t n_rows, const void* rows, const void* lf,
                   const void* df, int64_t df_stride, const void* dj,
                   int64_t dj_plane, int64_t dj_stride, int Lw, int64_t N,
                   int W, int jac_lo, int Fj, int vec, const void* table,
                   void* dpos, cudaStream_t s) {
  if ((int64_t)Lw * N == 0) return 0;
  if (Lw > kK2Threads) return (int)cudaErrorInvalidValue;
#define ARGS with_jac, bf16, grad, n_rows, rows, lf, df, df_stride, dj, \
             dj_plane, dj_stride, Lw, N, W, jac_lo, Fj, vec, table, dpos, s
  switch (F) {
    case 2: return dispatch_bwd<2, POS>(ARGS);
    case 4: return dispatch_bwd<4, POS>(ARGS);
    case 8: return dispatch_bwd<8, POS>(ARGS);
    case 16: return dispatch_bwd<16, POS>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

}  // namespace

// grad (n_rows, W) f32, 16-byte aligned rows, accumulated into; rows
// (Lw, N) int32; lf (8, Lw, N) f32; df (N, Lw*F) f32 with row stride
// df_stride floats; dj (3, N, Lw*Fj) f32 with plane and row strides
// dj_plane, dj_stride floats, or null; Lw <= 256. vec: bit 0 df, bit 1
// dj may be read with 16-byte loads. Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int ingp_brick_reduce_bwd(void* grad, int64_t n_rows,
                                     const void* rows, const void* lf,
                                     const void* df, int64_t df_stride,
                                     const void* dj, int64_t dj_plane,
                                     int64_t dj_stride, int Lw, int64_t N,
                                     int W, int F, int with_jac, int jac_lo,
                                     int Fj, int bf16, int vec,
                                     void* stream) {
  return dispatch_bwd_f<false>(F, with_jac, bf16, grad, n_rows, rows, lf,
                               df, df_stride, dj, dj_plane, dj_stride, Lw,
                               N, W, jac_lo, Fj, vec, nullptr, nullptr,
                               (cudaStream_t)stream);
}

// ingp_brick_reduce_bwd, and in the same pass each cell's position
// cotangent: table (n_rows, W), the storage the forward read, bf16 when
// bf16 else f32, 16-byte aligned rows, W a multiple of 8; dpos (3, Lw, N)
// f32, written.
extern "C" int ingp_brick_reduce_bwd_and_pos(
    void* grad, const void* table, int64_t n_rows, const void* rows,
    const void* lf, const void* df, int64_t df_stride, const void* dj,
    int64_t dj_plane, int64_t dj_stride, void* dpos, int Lw, int64_t N,
    int W, int F, int with_jac, int jac_lo, int Fj, int bf16, int vec,
    void* stream) {
  return dispatch_bwd_f<true>(F, with_jac, bf16, grad, n_rows, rows, lf, df,
                              df_stride, dj, dj_plane, dj_stride, Lw, N, W,
                              jac_lo, Fj, vec, table, dpos,
                              (cudaStream_t)stream);
}

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
