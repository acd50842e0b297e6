// Elementwise Threefry-2x32-20 over counter arrays: the device side of
// ops/kernel_prng.py::threefry2x32, which ops/sampling.py uses for
// fold_in / split on keys that live on the card, and which random_bits
// uses to check the stream against its plain version.
//
// Bound by nothing worth measuring at the sizes the main path gives it (two
// to a few thousand counters); a grid-stride loop keeps any size legal.
#include <cuda_runtime.h>

#include "launchers.h"
#include "threefry.cuh"

namespace multinn_torch {
namespace {

__global__ void threefry2x32_kernel(const int32_t* __restrict__ key,
                                    const int32_t* __restrict__ x0,
                                    const int32_t* __restrict__ x1,
                                    int32_t* __restrict__ y0,
                                    int32_t* __restrict__ y1, int64_t n) {
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const uint2 y = threefry2x32(k0, k1, static_cast<uint32_t>(x0[i]),
                                 static_cast<uint32_t>(x1[i]));
    y0[i] = static_cast<int32_t>(y.x);
    y1[i] = static_cast<int32_t>(y.y);
  }
}

}  // namespace

const char* launch_threefry2x32(const int32_t* key, const int32_t* x0,
                                const int32_t* x1, int32_t* y0, int32_t* y1,
                                int64_t n, void* stream) {
  if (n <= 0) return nullptr;
  constexpr int kThreads = 256;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  threefry2x32_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(key, x0, x1, y0,
                                                             y1, n);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? nullptr : cudaGetErrorString(err);
}

}  // namespace multinn_torch
