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
// features fill whole 16-byte words (bf16 F=8/16, f32 F=4/8/16), which the
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

// Backward helpers (rayreduce.cu, brickreduce.cu). Every product and sum
// is rounded on its own (__fmul_rn / __fadd_rn are never contracted into
// fused multiply-adds), in the order of brickreduce.py
// `trilerp_rows_bwd_plain`, so that a cell's per-lane cotangent has the
// same bits as the plain version's and a bf16 rounding of it cannot step
// the other way.
__device__ __forceinline__ float ingp_round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Weight of the lattice point at offset a (0 or 1) from the cell along
// one axis, (1 - f) or f, and its derivative -1 or +1.
__device__ __forceinline__ void ingp_axis_w(int a, float fr, float& w,
                                            float& d) {
  w = a ? fr : __fsub_rn(1.f, fr);
  d = a ? 1.f : -1.f;
}

// The four weight planes at one lattice point: w = wx*(wy*wz),
// d1 = dwx*(wy*wz), d2 = dwy*(wx*wz), d3 = dwz*(wx*wy).
__device__ __forceinline__ void ingp_point_planes(int a, int b, int e,
                                                  float fx, float fy,
                                                  float fz, float& w,
                                                  float& d1, float& d2,
                                                  float& d3) {
  float wx, wy, wz, dwx, dwy, dwz;
  ingp_axis_w(a, fx, wx, dwx);
  ingp_axis_w(b, fy, wy, dwy);
  ingp_axis_w(e, fz, wz, dwz);
  const float pyz = __fmul_rn(wy, wz);
  w = __fmul_rn(wx, pyz);
  d1 = __fmul_rn(dwx, pyz);
  d2 = __fmul_rn(dwy, __fmul_rn(wx, wz));
  d3 = __fmul_rn(dwz, __fmul_rn(wx, wy));
}

// One lane's cotangent: df*w, plus ((jx*d1 + jy*d2) + jz*d3) * scale
// inside the jacobian window.
__device__ __forceinline__ float ingp_lane_ct(float df, float w, bool jac,
                                              float jx, float jy, float jz,
                                              float d1, float d2, float d3,
                                              float sc) {
  const float v = __fmul_rn(df, w);
  if (!jac) return v;
  const float t = __fadd_rn(__fadd_rn(__fmul_rn(jx, d1), __fmul_rn(jy, d2)),
                            __fmul_rn(jz, d3));
  return __fadd_rn(v, __fmul_rn(t, sc));
}

// v (the F lanes of one lattice point) added into a master-gradient row
// at dst, with 16-byte (8-byte for F = 2) vector atomics (sm_90): each
// float is added atomically on its own; a lane of 0 adds +0, which
// changes no value. dst must be 16-byte (8-byte) aligned.
template <int F>
__device__ __forceinline__ void ingp_red_point(float* dst,
                                               const float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int i = 0; i < F; i += 4)
      atomicAdd(reinterpret_cast<float4*>(dst + i),
                make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  } else {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  }
}
