// Helpers of the NADE kernels: a warp sum in a fixed order and the bf16
// weight words they read.
#pragma once

#include <cstdint>

namespace multinn_torch {

// Sum of x over the 32 lanes of a warp by a fixed xor butterfly: every lane
// gets the same bits (each level adds the same two values, in either
// order). Every lane of the warp must call it.
__device__ __forceinline__ float warp_allsum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A bfloat16 weight, passed as its 16-bit word, widened to float32. Exact:
// the bf16 value is the float32 with its low 16 mantissa bits cleared.
__device__ __forceinline__ float bf16_to_f32(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

}  // namespace multinn_torch
