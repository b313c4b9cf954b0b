// Shared device code of the brick-row trilerp kernels (rayreduce.cu,
// brickreduce.cu). A brick row holds the 27-point (3x3x3) corner lattice
// of a 2x2x2-cell brick, F features per point, point p = 9i + 3j + k at
// lanes [p*F, p*F + F). A sample in local cell (ix, iy, iz) of the brick
// interpolates the 8 points (ix+a, iy+b, iz+c), a, b, c in {0, 1}.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float ingp_to_f32(float v) { return v; }
__device__ __forceinline__ float ingp_to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// F features of one lattice point; 16-byte vector loads where a point's
// features fill whole 16-byte words (bf16 F=8, f32 F=4/8), which the
// wrappers keep aligned by requiring aligned, contiguous rows.
template <typename T, int F>
__device__ __forceinline__ void ingp_load_point(const T* __restrict__ p,
                                                float (&v)[F]) {
  if constexpr ((F * sizeof(T)) % 16 == 0) {
    constexpr int kWords = F * sizeof(T) / 16;
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[i * kPer + j] = ingp_to_f32(e[j]);
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = ingp_to_f32(p[f]);
  }
}

// Trilinear reduce of one row: features, and with JAC the unscaled
// derivative of each feature along x, y and z (d weight / d frac).
template <typename T, int F, bool JAC>
__device__ __forceinline__ void ingp_trilerp_row(
    const T* __restrict__ row, int ix, int iy, int iz, float fx, float fy,
    float fz, float (&feat)[F], float (&jx)[F], float (&jy)[F],
    float (&jz)[F]) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    feat[f] = 0.f;
    jx[f] = 0.f;
    jy[f] = 0.f;
    jz[f] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int a = c >> 2, b = (c >> 1) & 1, e = c & 1;
    const float wx = a ? fx : 1.f - fx;
    const float wy = b ? fy : 1.f - fy;
    const float wz = e ? fz : 1.f - fz;
    float v[F];
    ingp_load_point<T, F>(row + (9 * (ix + a) + 3 * (iy + b) + (iz + e)) * F,
                          v);
    const float w = wx * wy * wz;
#pragma unroll
    for (int f = 0; f < F; ++f) feat[f] = fmaf(w, v[f], feat[f]);
    if (JAC) {
      const float dx = (a ? 1.f : -1.f) * wy * wz;
      const float dy = wx * (b ? 1.f : -1.f) * wz;
      const float dz = wx * wy * (e ? 1.f : -1.f);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        jx[f] = fmaf(dx, v[f], jx[f]);
        jy[f] = fmaf(dy, v[f], jy[f]);
        jz[f] = fmaf(dz, v[f], jz[f]);
      }
    }
  }
}

// Local cell coordinates of a usable cell are 0 or 1 on every axis; the
// overflow / padding marker (-9) and anything else reads nothing.
__device__ __forceinline__ bool ingp_local_ok(float lx, float ly, float lz) {
  return lx >= 0.f && lx <= 1.f && ly >= 0.f && ly <= 1.f && lz >= 0.f &&
         lz <= 1.f;
}
