// K3 forward: per-ray volume composite with the aux composites folded
// in.
//
// Replaces ingp_tpu/ops/pallas/composite_pallas.py composite_pallas
// (_run_fwd -> _fwd_kernel). One thread walks one ray front to back:
// sd = valid ? sigma*dt : 0, inclusive running sum csum, transmittance
// before the sample T = exp(-(csum - sd)), include = valid && T > thr,
// w = include ? (1 - exp(-sd)) * T : 0 -- the include rule of
// composite_pallas.py:35-50. It writes ws (and, when asked, Ts for the
// test render's visibility cut), opacity, depth, rgb, the count of
// samples with w > 0, and the weighted sums of the aux channels
// (normal_pred, normal_raw, semantics: (C, R, S) -> (R, C)).
//
// Bound on the H100: bytes. Each (ray, sample) reads sigma, dt, t,
// valid, 3 rgb and C aux values and writes ws (and Ts); a handful of
// flops per byte. The design reads each input once per sample in one
// pass (the aux sums re-read ws, which the same thread has just written
// and the L1 still holds) and keeps every running sum in registers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(128)
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
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t base = (int64_t)r * S;
  const int64_t plane = (int64_t)R * S;
  float csum = 0.f, op = 0.f, dp = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
  int n = 0;
  for (int s = 0; s < S; ++s) {
    const int64_t i = base + s;
    const bool v = valid[i] != 0;
    const float sd = v ? sig[i] * dt[i] : 0.f;
    csum += sd;
    const float T = expf(-(csum - sd));
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

// sigmas, deltas, ts (R, S) f32; valid (R, S) bool (1 byte); rgbs
// (3, R, S) f32 or null; aux (C, R, S) f32 or null (C = 0); outputs ws
// (R, S), Ts (R, S) or null, opacity (R,), depth (R,), rgb (R, 3) or
// null, aux_out (R, C), count (R,) int32. Returns cudaGetLastError().
extern "C" int ingp_composite_fwd(const void* sigmas, const void* deltas,
                                  const void* ts, const void* valid,
                                  const void* rgbs, const void* aux, int C,
                                  float thr, int R, int S, void* ws,
                                  void* Ts, void* opacity, void* depth,
                                  void* rgb_out, void* aux_out, void* count,
                                  void* stream) {
  if (R == 0) return 0;
  const int threads = 128;
  composite_fwd_kernel<<<(R + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)sigmas, (const float*)deltas, (const float*)ts,
      (const unsigned char*)valid, (const float*)rgbs, (const float*)aux, C,
      thr, R, S, (float*)ws, (float*)Ts, (float*)opacity, (float*)depth,
      (float*)rgb_out, (float*)aux_out, (int*)count);
  return (int)cudaGetLastError();
}
