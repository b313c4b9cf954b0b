// The include rule of K3 (composite.cu, forward and backward, and the
// replaced forward body kept in probe_split.cu): sd = valid ? sigma*dt : 0,
// its inclusive front-to-back sum csum, the transmittance before the
// sample T = exp(-(csum - sd)), and include = valid && T > thr; an
// included sample's alpha is k3_alpha. Every kernel that decides T > thr
// takes its bits from these functions, each product and sum rounded on
// its own (never contracted into a fused multiply-add), the sum always
// serial and front to back.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float k3_sd(bool v, float sig, float dt) {
  return v ? __fmul_rn(sig, dt) : 0.f;
}

__device__ __forceinline__ float k3_T(float csum, float sd) {
  return expf(-__fsub_rn(csum, sd));
}

// The sample's alpha = 1 - exp(-sd), the reference's form
// (composite_pallas.py:44), with exp(-sd) rounded once to float from a
// double exp: the float nearest the exact value, as the plain version
// (composite.py `alpha_of`) takes it on any device. The cancellation
// multiplies the error of exp(-sd) by 1/sd: expf one ulp off moved
// alpha by 5e-5 of itself at sd ~1e-3, and by that much every weight of
// a ray where the field is flat (a fresh bf16 model's first step).
__device__ __forceinline__ float k3_alpha(float sd) {
  return __fsub_rn(1.f, __double2float_rn(exp(-(double)sd)));
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
