// K3 forward: per-ray volume composite with the aux composites folded
// in.
//
// Replaces ingp_tpu/ops/pallas/composite_pallas.py composite_pallas
// (_run_fwd -> _fwd_kernel). Per ray, front to back: sd = valid ?
// sigma*dt : 0, inclusive running sum csum, transmittance before the
// sample T = exp(-(csum - sd)), include = valid && T > thr, w = include ?
// (1 - exp(-sd)) * T : 0 -- the include rule of composite_pallas.py:35-50
// (k3.cuh; 1 - exp(-sd) is k3_alpha). It writes ws (and, when asked, Ts
// for the test render's visibility cut), opacity, depth (only when ts is
// given), rgb, the count of samples with w > 0, and the weighted sums of
// the aux channels (normal_pred, normal_raw, semantics: (C, R, S) ->
// (R, C)).
//
// Bound on the H100: bytes. Each (ray, sample) reads sigma, dt, valid, t,
// 3 rgb and C aux values and writes ws (and Ts); a handful of flops per
// byte. A thread per ray (the old form, the K1/K2/K3 split's `k3 fwd
// full`) made 64 blocks of 128 threads for training's 8192 rays on 132
// SMs, loaded every channel at the ray's S*4-byte stride across the warp
// (32 sectors per warp load; the ws and Ts stores the same) and re-read
// ws for the aux sums. Here a group of 16 lanes takes a ray (16 rays per
// 256-thread block: 512 blocks for 8192 rays), its lanes the ray's
// samples in segments of 16 (at S = 48, three full segments; groups of
// 32 left half of each ray's second segment idle and ran slower at every
// measured shape):
//   per segment, every input of a lane's sample is loaded once and
//     coalesced (a group reads 64 contiguous bytes of each channel), all
//     before the walk; lane 0 sums the segment's sd front to back out of
//     shared memory, carrying the sum from segment to segment
//     (k3_csum_walk, the walk of K3 backward, so both decide T > thr
//     from the same bits); then each lane makes its w and T, stores ws
//     and Ts coalesced and adds into its partials of opacity, depth,
//     rgb, count and the aux channels;
//   at the end one butterfly per quantity (k3_total) gives the ray's
//     totals. Only the summation order of opacity, depth, rgb and aux
//     differs from the thread-per-ray body; ws, Ts and count have its
//     bits.
// The aux partials live in registers, kK3Aux channels per pass over the
// ray: C <= kK3Aux takes one pass, a larger C one more pass (the walk
// again) per kK3Aux channels. A launch without rgb and aux runs an
// instance with their code compiled away. Any S works: one segment is
// staged at a time.
//
// K3 backward (ingp_composite_bwd): replaces composite_pallas.py _run_bwd
// (_bwd_kernel), the closed form of volumerendering.cu:222-241 plus the
// dL/dws term. The aux composites A_c = sum_s w_s aux_cs fold in as
// dws_s += sum_c dAux_c aux_cs and daux_cs = dAux_c w_s. Per sample,
//   dsigma = dt * (dO (1 - O) + dD (t T' - (D - prefD)) + T' dws
//                  - (sum dws w - pref dws w)
//                  + sum_c dC_c (rgb_c T' - (C_c - pref_c)))
// where included (0 elsewhere; T' is the transmittance after the sample),
// drgb = dC w and daux = dAux w -- the order of operations of
// composite.py `composite_bwd_plain`. deltas, ts and valid get no
// gradient.
//
// Bound on the H100: bytes. Per (ray, sample) it reads sigma, dt, t,
// valid, 3 rgb, C aux and dws and writes dsigma, 3 drgb and C daux; tens
// of flops per sample. A thread per ray (the old form, the K1/K2/K3
// split's `k3 bwd full`) left most of the card idle (8192 rays are 64
// blocks of 128 threads on 132 SMs), loaded every channel at the ray's
// S*4-byte stride across the warp and read the aux channels twice. Here
// a warp takes a ray (8 rays per 256-thread block), its lanes the ray's
// samples in segments of 32:
//   pass 1, per segment: every input loaded once, coalesced (a warp
//     reads 128 contiguous bytes of each channel); dws_eff = dws +
//     sum_c dAux_c aux_c computed once; the inclusive csum of sd in
//     K3 forward's serial front-to-back order (k3_csum_walk, k3_sd,
//     k3_T), so that T > thr includes exactly the samples the forward
//     weighted; w, T', dt (or -1 where not included), t, rgb and dws_eff
//     kept in shared memory; the lane partials of O, D, C and sum
//     dws_eff w;
//   the totals by __shfl_xor_sync reductions;
//   pass 2, per segment: the prefix sums of w t, w rgb and dws_eff w by
//     __shfl_up_sync inclusive scans carried across segments (they enter
//     only as differences from the totals), and the outputs written
//     coalesced.
// Any S works while a warp's 9*S floats of shared memory fit the block.
#include <cstdint>
#include <cuda_runtime.h>

#include "k3.cuh"

namespace {

// the butterfly total over a group of G lanes (every lane gets it)
template <int G = 32, typename T>
__device__ __forceinline__ T k3_total(T v) {
#pragma unroll
  for (int o = G / 2; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kK3FwdThreads = 256;
constexpr int kK3FwdGroup = 16;   // lanes per ray
constexpr int kK3Aux = 16;        // aux channels a pass keeps in registers

// CHANNELS: the launch composites rgb or aux channels. Without them (the
// weights + Ts launch of render_weights) their code compiles away: half
// the registers, and twice the speed on training's launch.
template <bool CHANNELS>
__global__ void __launch_bounds__(kK3FwdThreads)
    composite_fwd_kernel(const float* __restrict__ sig,
                         const float* __restrict__ dt,
                         const float* __restrict__ ts,
                         const unsigned char* __restrict__ valid,
                         const float* __restrict__ rgbs,
                         const float* __restrict__ aux, int C, float thr,
                         int R, int S, float* __restrict__ ws,
                         float* __restrict__ Ts, float* __restrict__ opacity,
                         float* __restrict__ depth,
                         float* __restrict__ rgb_out,
                         float* __restrict__ aux_out,
                         int* __restrict__ count) {
  constexpr int G = kK3FwdGroup;
  __shared__ float cs_block[kK3FwdThreads];
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int r = blockIdx.x * (kK3FwdThreads / G) + grp;
  // a group past the last ray runs on without loads or stores, so that
  // every lane of a warp reaches its __syncwarp and shuffles
  const bool ray = r < R;
  float* cs = cs_block + grp * G;
  const int64_t base = (int64_t)r * S;
  const int64_t plane = (int64_t)R * S;
  for (int c0 = 0; c0 == 0 || c0 < C; c0 += kK3Aux) {
    const bool first = c0 == 0;   // the pass that writes ws, Ts, ...
    const int nc = CHANNELS ? min(kK3Aux, C - c0) : 0;
    float csum = 0.f;             // lane 0: the ray's running sum of sd
    float op = 0.f, dp = 0.f, q0 = 0.f, q1 = 0.f, q2 = 0.f;
    float acc[kK3Aux];
#pragma unroll
    for (int c = 0; c < kK3Aux; ++c) acc[c] = 0.f;
    int n = 0;
    for (int s0 = 0; s0 < S; s0 += G) {
      const int s = s0 + lane;
      const bool in = ray && s < S;
      const int64_t i = base + s;
      bool v = false;
      float sd = 0.f, t = 0.f, r0 = 0.f, r1 = 0.f, r2 = 0.f, a[kK3Aux];
      if (in) {
        v = valid[i] != 0;
        sd = k3_sd(v, sig[i], dt[i]);
        cs[lane] = sd;
        if (first && ts) t = ts[i];
        if (CHANNELS && first && rgbs) {
          r0 = rgbs[i];
          r1 = rgbs[plane + i];
          r2 = rgbs[2 * plane + i];
        }
#pragma unroll
        for (int c = 0; c < kK3Aux; ++c)
          if (c < nc) a[c] = aux[(c0 + c) * plane + i];
      }
      __syncwarp();
      if (lane == 0) k3_csum_walk(cs, ray ? min(G, S - s0) : 0, csum);
      __syncwarp();
      if (in) {
        const float T = k3_T(cs[lane], sd);
        const float w = (v && T > thr) ? k3_alpha(sd) * T : 0.f;
        if (first) {
          ws[i] = w;
          if (Ts) Ts[i] = T;
          op += w;
          dp = fmaf(w, t, dp);
          n += w > 0.f;
          q0 = fmaf(w, r0, q0);
          q1 = fmaf(w, r1, q1);
          q2 = fmaf(w, r2, q2);
        }
#pragma unroll
        for (int c = 0; c < kK3Aux; ++c)
          if (c < nc) acc[c] = fmaf(w, a[c], acc[c]);
      }
    }
    if (first) {
      op = k3_total<G>(op);
      dp = k3_total<G>(dp);
      n = k3_total<G>(n);
      if (CHANNELS) {
        q0 = k3_total<G>(q0);
        q1 = k3_total<G>(q1);
        q2 = k3_total<G>(q2);
      }
      if (lane == 0 && ray) {
        opacity[r] = op;
        if (depth) depth[r] = dp;
        count[r] = n;
        if (CHANNELS && rgb_out) {
          rgb_out[3 * r] = q0;
          rgb_out[3 * r + 1] = q1;
          rgb_out[3 * r + 2] = q2;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kK3Aux; ++c) {
      if (c < nc) {
        const float tot = k3_total<G>(acc[c]);
        if (lane == 0 && ray) aux_out[(int64_t)r * C + c0 + c] = tot;
      }
    }
  }
}

// shared memory per warp: kK3Fields planes of S floats
enum K3Field { K3_CSUM = 0, K3_W, K3_TA, K3_DT, K3_T, K3_R0, K3_R1, K3_R2,
               K3_DE, kK3Fields };
constexpr int kK3Warps = 8;   // rays per block

__device__ __forceinline__ float k3_scan(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

__global__ void __launch_bounds__(kK3Warps * 32)
    composite_bwd_kernel(const float* __restrict__ sig,
                         const float* __restrict__ dt,
                         const float* __restrict__ ts,
                         const unsigned char* __restrict__ valid,
                         const float* __restrict__ rgbs,
                         const float* __restrict__ aux, int C, float thr,
                         int R, int S, const float* __restrict__ dws,
                         const float* __restrict__ dO,
                         const float* __restrict__ dD,
                         const float* __restrict__ dC,
                         const float* __restrict__ dAux,
                         float* __restrict__ dsig, float* __restrict__ drgb,
                         float* __restrict__ daux) {
  extern __shared__ float k3_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= R) return;   // the whole warp: no block-wide barrier below
  float* sm = k3_smem + (size_t)warp * kK3Fields * S;
  const int64_t base = (int64_t)r * S;
  const int64_t plane = (int64_t)R * S;
  const float* dA = dAux + (int64_t)r * C;

  // pass 1: inputs, the forward's csum, weights, totals
  float csum = 0.f;   // lane 0: the ray's running sum of sd
  float O = 0.f, D = 0.f, C0 = 0.f, C1 = 0.f, C2 = 0.f, Wd = 0.f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool in = s < S;
    const int64_t i = base + s;
    bool v = false;
    float sd = 0.f, dtv = 0.f, t = 0.f, r0 = 0.f, r1 = 0.f, r2 = 0.f,
          de = 0.f;
    if (in) {
      v = valid[i] != 0;
      dtv = dt[i];
      sd = k3_sd(v, sig[i], dtv);
      t = ts[i];
      r0 = rgbs[i];
      r1 = rgbs[plane + i];
      r2 = rgbs[2 * plane + i];
      de = dws[i];
      for (int c = 0; c < C; ++c) de += dA[c] * aux[c * plane + i];
      sm[K3_CSUM * S + s] = sd;
    }
    __syncwarp();
    if (lane == 0)   // K3 forward's serial order
      k3_csum_walk(sm + K3_CSUM * S + s0, min(32, S - s0), csum);
    __syncwarp();
    if (in) {
      const float T = k3_T(sm[K3_CSUM * S + s], sd);
      const bool inc = v && T > thr;
      const float alpha = k3_alpha(sd);
      const float w = inc ? alpha * T : 0.f;
      sm[K3_W * S + s] = w;
      sm[K3_TA * S + s] = T * (1.f - alpha);
      sm[K3_DT * S + s] = inc ? dtv : -1.f;
      sm[K3_T * S + s] = t;
      sm[K3_R0 * S + s] = r0;
      sm[K3_R1 * S + s] = r1;
      sm[K3_R2 * S + s] = r2;
      sm[K3_DE * S + s] = de;
      O += w;
      D += w * t;
      C0 += w * r0;
      C1 += w * r1;
      C2 += w * r2;
      Wd += de * w;
    }
  }
  O = k3_total(O);
  D = k3_total(D);
  C0 = k3_total(C0);
  C1 = k3_total(C1);
  C2 = k3_total(C2);
  Wd = k3_total(Wd);
  __syncwarp();

  // pass 2: prefix sums carried across segments, outputs
  const float dOr = dO[r], dDr = dD[r];
  const float dC0 = dC[3 * r], dC1 = dC[3 * r + 1], dC2 = dC[3 * r + 2];
  float cD = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, cW = 0.f;   // carries
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool in = s < S;
    float w = 0.f, Ta = 0.f, dtv = -1.f, t = 0.f, r0 = 0.f, r1 = 0.f,
          r2 = 0.f, de = 0.f;
    if (in) {
      w = sm[K3_W * S + s];
      Ta = sm[K3_TA * S + s];
      dtv = sm[K3_DT * S + s];
      t = sm[K3_T * S + s];
      r0 = sm[K3_R0 * S + s];
      r1 = sm[K3_R1 * S + s];
      r2 = sm[K3_R2 * S + s];
      de = sm[K3_DE * S + s];
    }
    const float pD = cD + k3_scan(w * t, lane);
    const float p0 = c0 + k3_scan(w * r0, lane);
    const float p1 = c1 + k3_scan(w * r1, lane);
    const float p2 = c2 + k3_scan(w * r2, lane);
    const float pW = cW + k3_scan(de * w, lane);
    if (in) {
      const int64_t i = base + s;
      float acc = dOr * (1.f - O) + dDr * (t * Ta - (D - pD));
      acc = acc + Ta * de - (Wd - pW);
      acc = acc + dC0 * (r0 * Ta - (C0 - p0));
      acc = acc + dC1 * (r1 * Ta - (C1 - p1));
      acc = acc + dC2 * (r2 * Ta - (C2 - p2));
      dsig[i] = dtv >= 0.f ? dtv * acc : 0.f;
      drgb[i] = dC0 * w;
      drgb[plane + i] = dC1 * w;
      drgb[2 * plane + i] = dC2 * w;
      for (int c = 0; c < C; ++c) daux[c * plane + i] = dA[c] * w;
    }
    cD = __shfl_sync(0xffffffffu, pD, 31);
    c0 = __shfl_sync(0xffffffffu, p0, 31);
    c1 = __shfl_sync(0xffffffffu, p1, 31);
    c2 = __shfl_sync(0xffffffffu, p2, 31);
    cW = __shfl_sync(0xffffffffu, pW, 31);
  }
}

}  // namespace

// sigmas, deltas, ts (R, S) f32; valid (R, S) bool; rgbs (3, R, S) f32;
// aux (C, R, S) f32 (C may be 0); cotangents dws (R, S), dO (R,), dD (R,),
// dC (R, 3), dAux (R, C) f32; outputs dsig (R, S), drgb (3, R, S), daux
// (C, R, S). Returns cudaGetLastError().
extern "C" int ingp_composite_bwd(const void* sigmas, const void* deltas,
                                  const void* ts, const void* valid,
                                  const void* rgbs, const void* aux, int C,
                                  float thr, int R, int S, const void* dws,
                                  const void* dO, const void* dD,
                                  const void* dC, const void* dAux,
                                  void* dsig, void* drgb, void* daux,
                                  void* stream) {
  if (R == 0) return 0;
  if (S == 0) return 0;
  const size_t bytes = sizeof(float) * kK3Fields * (size_t)S * kK3Warps;
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  composite_bwd_kernel<<<(R + kK3Warps - 1) / kK3Warps, kK3Warps * 32,
                         bytes, (cudaStream_t)stream>>>(
      (const float*)sigmas, (const float*)deltas, (const float*)ts,
      (const unsigned char*)valid, (const float*)rgbs, (const float*)aux, C,
      thr, R, S, (const float*)dws, (const float*)dO, (const float*)dD,
      (const float*)dC, (const float*)dAux, (float*)dsig, (float*)drgb,
      (float*)daux);
  return (int)cudaGetLastError();
}

// sigmas, deltas (R, S) f32; ts (R, S) f32 or null (then depth is null
// and not written); valid (R, S) bool (1 byte); rgbs (3, R, S) f32 or
// null; aux (C, R, S) f32 or null (C = 0); outputs ws (R, S), Ts (R, S)
// or null, opacity (R,), depth (R,) or null, rgb (R, 3) or null, aux_out
// (R, C), count (R,) int32. Returns cudaGetLastError().
extern "C" int ingp_composite_fwd(const void* sigmas, const void* deltas,
                                  const void* ts, const void* valid,
                                  const void* rgbs, const void* aux, int C,
                                  float thr, int R, int S, void* ws,
                                  void* Ts, void* opacity, void* depth,
                                  void* rgb_out, void* aux_out, void* count,
                                  void* stream) {
  if (R == 0) return 0;
  constexpr int rays = kK3FwdThreads / kK3FwdGroup;
  const auto kernel = (rgbs || C > 0) ? composite_fwd_kernel<true>
                                      : composite_fwd_kernel<false>;
  kernel<<<(R + rays - 1) / rays, kK3FwdThreads, 0, (cudaStream_t)stream>>>(
      (const float*)sigmas, (const float*)deltas, (const float*)ts,
      (const unsigned char*)valid, (const float*)rgbs, (const float*)aux, C,
      thr, R, S, (float*)ws, (float*)Ts, (float*)opacity, (float*)depth,
      (float*)rgb_out, (float*)aux_out, (int*)count);
  return (int)cudaGetLastError();
}
