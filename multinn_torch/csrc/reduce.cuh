// Helpers of the NADE kernels: a warp sum in a fixed order and the bf16
// weight words they read (also the whole-generation kernels' bf16
// rounding).
#pragma once

#include <cuda_bf16.h>

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

// One level of warp_allsum's transposed form: each lane keeps one half of
// its 2 * kHalf partials (the lower lane of the pair the low half) and adds
// the partner's copy of the same half, so the pair splits the work.
template <int kHalf>
__device__ __forceinline__ void fold_half(float* p, int lane, int off) {
  const bool upper = (lane & off) != 0;
#pragma unroll
  for (int v = 0; v < kHalf; ++v) {
    const float send = upper ? p[v] : p[v + kHalf];
    const float keep = upper ? p[v + kHalf] : p[v];
    p[v] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// warp_allsum of kN partials at once (kN a power of two, at most 16), by a
// transposed butterfly: the levels 16, 8, ... halve the partials each lane
// carries (kN / 2 + kN / 4 + ... shuffles in all instead of 5 kN), then the
// levels left sum the one that remains as warp_allsum does. At every level
// each lane adds the same two values as warp_allsum of that partial adds
// there (lane l: the sum over its group plus the partner group's sum), so
// each result has warp_allsum's bits. Returns the sum of partial number
// lane >> (5 - log2 kN), which lanes 2^(5 - log2 kN) apart share.
template <int kN>
__device__ __forceinline__ float warp_allsum_slots(float (&p)[kN]) {
  static_assert(kN == 1 || kN == 2 || kN == 4 || kN == 8 || kN == 16,
                "kN partials: a power of two up to 16");
  const int lane = threadIdx.x & 31;
  constexpr int kLog = kN >= 16 ? 4 : kN >= 8 ? 3 : kN >= 4 ? 2 : kN >= 2;
  if constexpr (kN >= 16) fold_half<8>(p, lane, 16 >> (kLog - 4));
  if constexpr (kN >= 8) fold_half<4>(p, lane, 16 >> (kLog - 3));
  if constexpr (kN >= 4) fold_half<2>(p, lane, 16 >> (kLog - 2));
  if constexpr (kN >= 2) fold_half<1>(p, lane, 16 >> (kLog - 1));
  float x = p[0];
#pragma unroll
  for (int off = 16 >> kLog; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A bfloat16 weight, passed as its 16-bit word, widened to float32. Exact:
// the bf16 value is the float32 with its low 16 mantissa bits cleared.
__device__ __forceinline__ float bf16_to_f32(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// x rounded to the nearest bfloat16 (ties to even), as float32: the
// operand of a product with bf16 weights, as the reference's capacity
// mode feeds it.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace multinn_torch
