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
// the feature-major outputs coalesced along k. A staged form, in which a
// block of 256 cells copied the lattice points its cells read into
// shared memory once (cp.async) and trilerped from there with this
// body's bits, was timed against this body on every recorded input and
// at the split probe's shapes and was slower at every training shape
// (PERF.md, row 1): the warps of this body stream their stores
// independently, where the staged block waited at five barriers and
// three dependent global loads per chunk of 256 cells, and the L1
// already serves the points that cells of a run share.
//
// K1 backward (ingp_ray_reduce_bwd): replaces rayreduce_pallas.py
// _frr_bwd (_bwd_kernel), which scatters each cell's row cotangent onto
// its unique slot with a one-hot MXU transpose. Here, per batch row b
// and slot u, the per-lane cotangents of the row's cells whose uid is u
// are summed in increasing k and the slot's 27*F-lane row is added into
// the f32 master gradient at urows[b, u] with f32 atomics. The sum runs
// in k order (the plain version's order: with bf16 a slot summed in
// another order can round to another bf16 value).
//
// Bound on the H100: bytes (per cell: uid, 6 lf floats (7 with a
// jacobian), F + 3*Fj cotangent floats; per slot a read-modify-write of
// its touched lanes).
// A thread per lane that walks all K cells of the row one after another
// is a latency chain: at each cell only the 64 lanes of its 8 corner
// points have work, and each step waits on the last. So a block takes
// one batch row, 256 cells at a time (a chunk), in three steps:
//   1. a thread per cell loads its uid, lf and cotangents (coalesced
//      along k) and computes the 8*F lane cotangents of its 8 corner
//      points (ingp_point_planes / ingp_lane_ct) into shared memory, as
//      bf16 in the bf16 variant (the plain version's rounding of each
//      cell's cotangent), corner planes padded so that the reads of
//      step 3 hit distinct banks;
//   2. the slot runs, from uid alone: a run starts at a valid cell
//      whose uid differs from the previous valid cell's (-9 cells and
//      uids outside [0, U) are skipped and do not break a run; uid
//      never decreases along a row, so a run is all of its slot's
//      cells), found with warp ballots and a block scan;
//   3. a thread per (run, lattice point): it sums the F lanes of its
//      point over the run's cells in k order out of shared memory
//      (one 16-byte read per cell that has the point as a corner) and
//      flushes once, rounded as the plain version rounds it, with
//      16-byte atomics (ingp_red_point). All runs of the chunk are
//      summed in parallel, and no thread steps through cells of other
//      runs.
// A run that reaches the end of a chunk carries its partial sums to the
// next chunk in shared memory, so a row of any K is summed in k order.
#include <type_traits>

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
    case 16: launch<T, 16>(table, n_rows, urows, uid, lf, feats, jac,
                           n_cells, K, U, W, with_jac, jac_lo, Fj, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

constexpr int kBwdThreads = 256;   // threads per block, and cells per chunk
constexpr int kBwdWarps = kBwdThreads / 32;
// cells per corner plane of the staged cotangents: one past the chunk,
// so that the 8 corners of one cell lie in 8 different bank groups
constexpr int kCornerStride = kBwdThreads + 1;

template <int F, bool BF16>
constexpr size_t bwd_smem_bytes() {
  return (size_t)8 * kCornerStride * F * (BF16 ? 2 : 4)   // cotangents
         + sizeof(int) * (4 * kBwdThreads + 3)   // uid, loc, runs' k, row
         + sizeof(float) * 2 * 27 * F;           // carries
}

// F lane cotangents of one (corner, cell) into shared memory, as bf16
// when the variant rounds to it (each value rounded once, to nearest
// even, as ingp_round_bf16), and back as f32; 16-byte accesses where F
// values fill them.
template <int F>
__device__ __forceinline__ void bwd_put(float* p, const float (&v)[F]) {
#pragma unroll
  for (int i = 0; i < F; i += 2)
    *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
}
template <int F>
__device__ __forceinline__ void bwd_put(__nv_bfloat16* p,
                                        const float (&v)[F]) {
  __align__(16) __nv_bfloat162 h[F / 2];
#pragma unroll
  for (int i = 0; i < F / 2; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  if constexpr (F % 8 == 0) {
#pragma unroll
    for (int i = 0; i < F / 8; ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(h)[i];
  } else if constexpr (F == 4)
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  else
    *reinterpret_cast<__nv_bfloat162*>(p) = h[0];
}
template <int F>
__device__ __forceinline__ void bwd_get(const float* p, float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int i = 0; i < F; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
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
template <int F>
__device__ __forceinline__ void bwd_get(const __nv_bfloat16* p,
                                        float (&v)[F]) {
  __align__(16) __nv_bfloat162 h[F / 2];
  if constexpr (F % 8 == 0) {
#pragma unroll
    for (int i = 0; i < F / 8; ++i)
      reinterpret_cast<uint4*>(h)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else if constexpr (F == 4)
    *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
  else
    h[0] = *reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < F / 2; ++i) {
    const float2 q = __bfloat1622float2(h[i]);
    v[2 * i] = q.x;
    v[2 * i + 1] = q.y;
  }
}

// 3 blocks per SM up to F = 8: ptxas then keeps the kernel within 80
// registers (measured faster on the card than 2 blocks at 114
// registers). At F = 16 the f32 staging alone takes 132 KB of shared
// memory, so one block fits an SM, and its 4 x 16-float carries would
// spill at 80 registers: the bound asks for one block.
constexpr int bwd_min_blocks(int F) { return F >= 16 ? 1 : 3; }

template <int F, bool JAC, bool BF16>
__global__ void __launch_bounds__(kBwdThreads, bwd_min_blocks(F))
    ray_reduce_bwd_kernel(float* __restrict__ grad, int64_t n_rows,
                          const int* __restrict__ urows,
                          const int* __restrict__ uid,
                          const float* __restrict__ lf,
                          const float* __restrict__ df,
                          const float* __restrict__ dj, int64_t n_cells,
                          int K, int U, int W, int jac_lo, int Fj) {
  using Ct = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  extern __shared__ __align__(16) unsigned char k1b_smem[];
  // the chunk's lane cotangents, (8 corners, kCornerStride cells, F)
  Ct* s_ct = reinterpret_cast<Ct*>(k1b_smem);
  int* s_uid = reinterpret_cast<int*>(s_ct + 8 * kCornerStride * F);
  int* s_loc = s_uid + kBwdThreads;    // local cell 4lx+2ly+lz, 8: skip
  int* s_run = s_loc + kBwdThreads;    // run starts, then the chunk end
  int* s_row = s_run + kBwdThreads + 2;   // each run's table row, -1: none
  float* s_carry = reinterpret_cast<float*>(s_row + kBwdThreads + 1);
  __shared__ int s_wmax[kBwdWarps], s_wcnt[kBwdWarps], s_first_flag;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.x;

  // the F lanes of lattice point p of one run (or carry), flushed into
  // the master row r (-1: none) once, rounded as the plain version
  auto flush = [&](int r, float (&acc)[F], int p) {
    bool any = false;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      any |= acc[f] != 0.f;
      if (BF16) acc[f] = ingp_round_bf16(acc[f]);
    }
    if (r >= 0 && any) ingp_red_point<F>(grad + (int64_t)r * W + p * F, acc);
  };

  int prev_vuid = -1;   // uid of the row's last valid cell so far
  int prev_row = -1;    // the table row of the run carried into a chunk
  for (int k0 = 0, ci = 0; k0 < K; k0 += kBwdThreads, ++ci) {
    const int kc = min(kBwdThreads, K - k0);
    const bool last_chunk = k0 + kc >= K;

    // 1. a thread per cell: validity, local cell, 8F lane cotangents
    bool valid = false;
    int u = -1;
    if (tid < kc) {
      // every load of the cell issued before the validity test: one
      // round trip to memory
      const int64_t i = b * K + k0 + tid;
      u = uid[i];
      const float lx = lf[i], ly = lf[n_cells + i], lz = lf[2 * n_cells + i];
      const float fx = lf[3 * n_cells + i], fy = lf[4 * n_cells + i],
                  fz = lf[5 * n_cells + i];
      const float sc = JAC ? lf[6 * n_cells + i] : 0.f;
      float dfv[F], jx[F], jy[F], jz[F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        dfv[f] = df[(int64_t)f * n_cells + i];
        jx[f] = jy[f] = jz[f] = 0.f;
        if (JAC && f >= jac_lo && f < jac_lo + Fj) {
          const int o = f - jac_lo;
          jx[f] = dj[(int64_t)o * n_cells + i];
          jy[f] = dj[(int64_t)(Fj + o) * n_cells + i];
          jz[f] = dj[(int64_t)(2 * Fj + o) * n_cells + i];
        }
      }
      valid = u >= 0 && u < U && ingp_local_ok(lx, ly, lz);
      s_uid[tid] = u;
      s_loc[tid] = valid ? ((int)lx << 2) | ((int)ly << 1) | (int)lz : 8;
      if (valid) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float w, d1, d2, d3, v[F];
          ingp_point_planes(c >> 2, (c >> 1) & 1, c & 1, fx, fy, fz, w, d1,
                            d2, d3);
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const bool in_win = JAC && f >= jac_lo && f < jac_lo + Fj;
            v[f] = ingp_lane_ct(dfv[f], w, in_win, jx[f], jy[f], jz[f], d1,
                                d2, d3, sc);
          }
          bwd_put<F>(s_ct + (c * kCornerStride + tid) * F, v);
        }
      }
    }

    // 2. run starts: a valid cell whose uid differs from that of the
    // previous valid cell (the last one before the chunk: prev_vuid)
    int idx = valid ? tid : -1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, idx, d);
      if (lane >= d) idx = max(idx, o);
    }
    if (lane == 31) s_wmax[warp] = idx;
    if (tid == 0) s_first_flag = 0;
    __syncthreads();
    int before = -1, last = -1;   // last valid cell before this warp, in all
#pragma unroll
    for (int w2 = 0; w2 < kBwdWarps; ++w2) {
      if (w2 < warp) before = max(before, s_wmax[w2]);
      last = max(last, s_wmax[w2]);
    }
    const int incl = max(idx, before);
    int excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = before;
    const bool flag =
        valid && (excl >= 0 ? s_uid[excl] != u : u != prev_vuid);
    if (valid && excl < 0) s_first_flag = flag;   // the chunk's first valid
    const unsigned m = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) s_wcnt[warp] = __popc(m);
    __syncthreads();
    // cont: the chunk opens inside the run carried from the last chunk;
    // otherwise that run ended there and its carry is flushed here
    const bool cont = prev_vuid >= 0 && !s_first_flag;
    const bool flush_carry = prev_vuid >= 0 && !cont;
    int off = cont, n_runs = cont;
#pragma unroll
    for (int w2 = 0; w2 < kBwdWarps; ++w2) {
      if (w2 < warp) off += s_wcnt[w2];
      n_runs += s_wcnt[w2];
    }
    if (flag) {   // each run's start and table row, one load per run
      const int o = off + __popc(m & ((1u << lane) - 1u));
      const int r = urows[b * U + u];
      s_run[o] = tid;
      s_row[o] = r >= 0 && r < n_rows ? r : -1;
    }
    if (tid == 0) {
      if (cont) {
        s_run[0] = 0;
        s_row[0] = prev_row;
      }
      s_run[n_runs] = kc;
    }
    if (last >= 0) prev_vuid = s_uid[last];
    __syncthreads();
    const int carry_row = prev_row;
    if (n_runs > 0) prev_row = s_row[n_runs - 1];

    // 3. a thread per (run, lattice point): its F lanes summed over the
    // run's cells in k order, then flushed once
    const float* carry_in = s_carry + ((ci + 1) & 1) * 27 * F;
    float* carry_out = s_carry + (ci & 1) * 27 * F;
    const int n_tasks = (n_runs + flush_carry) * 27;
    for (int t = tid; t < n_tasks; t += kBwdThreads) {
      const int r = t / 27, p = t - r * 27;
      float acc[F];
      const bool carried = r == n_runs || (r == 0 && cont);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = carried ? carry_in[p * F + f] : 0.f;
      if (r == n_runs) {   // the carried run ended with the last chunk
        flush(carry_row, acc, p);
        continue;
      }
      const int pi = p / 9, pj = (p / 3) % 3, pk = p % 3;
      unsigned hit = 0;   // bit l: p is a corner of local cell l
#pragma unroll
      for (int l = 0; l < 8; ++l)
        if ((unsigned)(pi - (l >> 2)) <= 1u &&
            (unsigned)(pj - ((l >> 1) & 1)) <= 1u &&
            (unsigned)(pk - (l & 1)) <= 1u)
          hit |= 1u << l;
      const int cp = 4 * pi + 2 * pj + pk;   // corner = cp - local cell
      const int k_hi = s_run[r + 1];
#pragma unroll 4
      for (int k = s_run[r]; k < k_hi; ++k) {
        const int l = s_loc[k];
        if ((hit >> l) & 1u) {
          float v[F];
          bwd_get<F>(s_ct + ((cp - l) * kCornerStride + k) * F, v);
#pragma unroll
          for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], v[f]);
        }
      }
      if (r == n_runs - 1 && !last_chunk) {
#pragma unroll
        for (int f = 0; f < F; ++f) carry_out[p * F + f] = acc[f];
      } else {
        flush(s_row[r], acc, p);
      }
    }
    __syncthreads();
  }
}

template <int F, bool JAC, bool BF16>
int launch_bwd_kernel(void* grad, int64_t n_rows, const void* urows,
                      const void* uid, const void* lf, const void* df,
                      const void* dj, int64_t B, int K, int U, int W,
                      int jac_lo, int Fj, cudaStream_t s) {
  constexpr size_t bytes = bwd_smem_bytes<F, BF16>();
  auto kernel = ray_reduce_bwd_kernel<F, JAC, BF16>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)B, kBwdThreads, bytes, s>>>(
      (float*)grad, n_rows, (const int*)urows, (const int*)uid,
      (const float*)lf, (const float*)df, (const float*)dj, B * (int64_t)K,
      K, U, W, jac_lo, Fj);
  return (int)cudaGetLastError();
}

template <int F>
int dispatch_bwd(int with_jac, int bf16, void* grad, int64_t n_rows,
                 const void* urows, const void* uid, const void* lf,
                 const void* df, const void* dj, int64_t B, int K, int U,
                 int W, int jac_lo, int Fj, cudaStream_t s) {
#define BWD_ARGS \
  grad, n_rows, urows, uid, lf, df, dj, B, K, U, W, jac_lo, Fj, s
  if (with_jac)
    return bf16 ? launch_bwd_kernel<F, true, true>(BWD_ARGS)
                : launch_bwd_kernel<F, true, false>(BWD_ARGS);
  return bf16 ? launch_bwd_kernel<F, false, true>(BWD_ARGS)
              : launch_bwd_kernel<F, false, false>(BWD_ARGS);
#undef BWD_ARGS
}

}  // namespace

// grad (n_rows, W) f32, accumulated into; urows (B, U) int32; uid (B, K)
// int32, non-decreasing along a row; lf (8, B, K) f32; df (F, B, K) f32;
// dj (3*Fj, B, K) f32 or null. Returns cudaGetLastError() (0 = success).
extern "C" int ingp_ray_reduce_bwd(void* grad, int64_t n_rows,
                                   const void* urows, const void* uid,
                                   const void* lf, const void* df,
                                   const void* dj, int64_t B, int K, int U,
                                   int W, int F, int with_jac, int jac_lo,
                                   int Fj, int bf16, void* stream) {
  if (B * (int64_t)K == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 2: return dispatch_bwd<2>(with_jac, bf16, grad, n_rows, urows, uid,
                                   lf, df, dj, B, K, U, W, jac_lo, Fj, s);
    case 4: return dispatch_bwd<4>(with_jac, bf16, grad, n_rows, urows, uid,
                                   lf, df, dj, B, K, U, W, jac_lo, Fj, s);
    case 8: return dispatch_bwd<8>(with_jac, bf16, grad, n_rows, urows, uid,
                                   lf, df, dj, B, K, U, W, jac_lo, Fj, s);
    case 16: return dispatch_bwd<16>(with_jac, bf16, grad, n_rows, urows,
                                     uid, lf, df, dj, B, K, U, W, jac_lo, Fj,
                                     s);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
