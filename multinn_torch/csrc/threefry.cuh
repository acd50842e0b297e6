// Threefry-2x32-20 as a device function — the counter stream every sampling
// kernel of the port draws from.
//
// Replaces multinn_tpu/ops/kernel_prng.py (threefry2x32 / random_bits /
// random_uniform, the in-kernel PRNG of the Pallas kernels). The stream is
// the JAX package's, bit for bit: key (seed, salt), counter words
// (c, c ^ 0x9E3779B9) where c = row * n_cols + col over the whole drawn
// shape, and a uniform from the top 23 bits via the [1, 2) exponent trick.
// It costs 20 rounds of 32-bit add/rotate/xor per draw: integer work that
// hides behind the weight loads of the kernels that call it.
#pragma once

#include <cstdint>

namespace multinn_torch {

__host__ __device__ constexpr int threefry_rot(int d, int r) {
  return (d & 1) ? (r == 0 ? 17 : r == 1 ? 29 : r == 2 ? 16 : 24)
                 : (r == 0 ? 13 : r == 1 ? 15 : r == 2 ? 26 : 6);
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int d = 0; d < 5; ++d) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, threefry_rot(d, r));
      x1 ^= x0;
    }
    x0 += ks[(d + 1) % 3];
    x1 += ks[(d + 2) % 3] + static_cast<uint32_t>(d + 1);
  }
  return make_uint2(x0, x1);
}

// Uniform in [0, 1) at one counter of the (seed, salt) stream.
__device__ __forceinline__ float random_uniform_at(uint32_t seed,
                                                   uint32_t salt,
                                                   uint32_t counter) {
  const uint32_t bits =
      threefry2x32(seed, salt, counter, counter ^ 0x9E3779B9u).x;
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace multinn_torch
