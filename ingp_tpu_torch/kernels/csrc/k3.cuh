// The include rule of K3 (composite.cu, forward and backward, and the
// replaced forward body kept in probe_split.cu): sd = valid ? sigma*dt : 0,
// its inclusive front-to-back sum csum, the transmittance before the
// sample T = exp(-(csum - sd)), and include = valid && T > thr. Every
// kernel that decides T > thr takes its bits from these functions, each
// product and sum rounded on its own (never contracted into a fused
// multiply-add), the sum always serial and front to back.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float k3_sd(bool v, float sig, float dt) {
  return v ? __fmul_rn(sig, dt) : 0.f;
}

__device__ __forceinline__ float k3_T(float csum, float sd) {
  return expf(-__fsub_rn(csum, sd));
}

// One thread's serial walk over a segment of a ray: cs[0, n) holds the
// segment's sd and becomes their inclusive running sums, continued from
// csum, which carries the sum to the next segment.
__device__ __forceinline__ void k3_csum_walk(float* cs, int n, float& csum) {
  for (int j = 0; j < n; ++j) {
    csum = __fadd_rn(csum, cs[j]);
    cs[j] = csum;
  }
}
