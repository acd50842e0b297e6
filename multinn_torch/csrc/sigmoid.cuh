// The logistic sigmoid in the two forms the port's kernels use.
#pragma once

namespace multinn_torch {

// 1 / (1 + exp(-x)) with IEEE division. The plain versions compute
// torch.sigmoid; without fast-math this agrees with it to a few ulps, and a
// draw compared against it flips only when a uniform lands between the two
// values.
__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// sigmoid(x) = 1 / (1 + exp(-x)) without the IEEE division's slow-path
// branch, which keeps independent sigmoids from overlapping: the hardware
// reciprocal estimate refined by one Newton step, within an ulp of the
// rounded quotient (the plain versions' torch.sigmoid); exp(-x) = inf
// gives 0.
__device__ __forceinline__ float sigmoid_nr(float x) {
  const float y = 1.0f + expf(-x);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  r = fmaf(r, fmaf(-y, r, 1.0f), r);
  return isinf(y) ? 0.f : r;
}

// 1 / (1 + 2^t), that is sigmoid(x) at t = -x log2(e), from the SFU's two
// approximations alone: ex2.approx and rcp.approx, each within about 2
// ulp. 2^t = inf gives rcp(inf) = 0, the limit. A caller that keeps its
// activations in these units pays two SFU operations and one add.
__device__ __forceinline__ float sigmoid_exp2(float t) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(t));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return r;
}

}  // namespace multinn_torch
