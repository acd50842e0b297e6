// k-sweep block-Gibbs chain of an RBM with per-row biases:
//   h ~ Bern(sigmoid(v W + bh)),  v ~ Bern(sigmoid(h W^T + bv)),  k times.
//
// Replaces multinn_tpu/ops/gibbs_pallas.py::_kernel (wrapper gibbs_chain).
// The Pallas kernel tiles the rows into blocks of bb (its _block_b rule)
// and keys each block's stream with seed[0] ^ block * 0x85EB; the counter
// of a draw is (row within the block) * n_cols + col. This kernel keeps
// that STREAM layout, so it and its plain version (ops/gibbs_cuda.py) draw
// the same bits as the JAX kernel, but not its thread layout: one CTA
// carries kRows rows through all k sweeps with v and h in shared memory.
//
// Bound: per sweep each row reads all of W twice (D*H floats from L1/L2)
// for 2*D*H multiply-adds. Skipping the zero entries of the binary v and h
// halves the reads at typical densities; W itself stays in global memory
// (50 KB at D=84, H=150 — L1 holds it across the CTA's rows).
#include <cuda_runtime.h>

#include "launchers.h"
#include "threefry.cuh"

namespace multinn_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // chain rows one CTA carries through all sweeps

__global__ void __launch_bounds__(kThreads)
    gibbs_chain_kernel(const float* __restrict__ v0,
                       const float* __restrict__ w,   // (d, h)
                       const float* __restrict__ wt,  // (h, d)
                       const float* __restrict__ bv,  // (n, d)
                       const float* __restrict__ bh,  // (n, h)
                       const int32_t* __restrict__ seed,
                       float* __restrict__ out, int n, int d, int h, int k,
                       int bb) {
  extern __shared__ float smem[];
  float* v_s = smem;             // (kRows, d)
  float* h_s = smem + kRows * d;  // (kRows, h)
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  for (int o = threadIdx.x; o < rows * d; o += blockDim.x)
    v_s[o] = v0[static_cast<size_t>(row0) * d + o];
  const uint32_t s0 = static_cast<uint32_t>(seed[0]);
  const uint32_t s1 = static_cast<uint32_t>(seed[1]);
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    const uint32_t salt_h = s1 + 2u * static_cast<uint32_t>(i);
    const uint32_t salt_v = salt_h + 1u;
    for (int o = threadIdx.x; o < rows * h; o += blockDim.x) {
      const int r = o / h, j = o - r * h;
      const uint32_t grow = row0 + r;
      const uint32_t blk = grow / bb, lrow = grow - blk * bb;
      const float* vr = v_s + r * d;
      float acc = 0.f;
      for (int ii = 0; ii < d; ++ii) {
        const float x = vr[ii];
        if (x != 0.f) acc = fmaf(x, w[static_cast<size_t>(ii) * h + j], acc);
      }
      const float p = sigmoid_f32(acc + bh[static_cast<size_t>(grow) * h + j]);
      const float u = random_uniform_at(s0 ^ (blk * 0x85EBu), salt_h,
                                        lrow * static_cast<uint32_t>(h) + j);
      h_s[o] = u < p ? 1.f : 0.f;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < rows * d; o += blockDim.x) {
      const int r = o / d, ii = o - r * d;
      const uint32_t grow = row0 + r;
      const uint32_t blk = grow / bb, lrow = grow - blk * bb;
      const float* hr = h_s + r * h;
      float acc = 0.f;
      for (int j = 0; j < h; ++j) {
        const float x = hr[j];
        if (x != 0.f) acc = fmaf(x, wt[static_cast<size_t>(j) * d + ii], acc);
      }
      const float p = sigmoid_f32(acc + bv[static_cast<size_t>(grow) * d + ii]);
      const float u = random_uniform_at(s0 ^ (blk * 0x85EBu), salt_v,
                                        lrow * static_cast<uint32_t>(d) + ii);
      v_s[o] = u < p ? 1.f : 0.f;
    }
    __syncthreads();
  }
  for (int o = threadIdx.x; o < rows * d; o += blockDim.x)
    out[static_cast<size_t>(row0) * d + o] = v_s[o];
}

}  // namespace

const char* launch_gibbs_chain(const float* v0, const float* w,
                               const float* wt, const float* bv,
                               const float* bh, const int32_t* seed,
                               float* out, int64_t n, int64_t d, int64_t h,
                               int64_t k, int64_t bb, void* stream) {
  if (n <= 0) return nullptr;
  const size_t smem = sizeof(float) * kRows * static_cast<size_t>(d + h);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gibbs_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // cleared: the caller raises this error itself
      return cudaGetErrorString(e);
    }
  }
  const int blocks = static_cast<int>((n + kRows - 1) / kRows);
  gibbs_chain_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      v0, w, wt, bv, bh, seed, out, static_cast<int>(n), static_cast<int>(d),
      static_cast<int>(h), static_cast<int>(k), static_cast<int>(bb));
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? nullptr : cudaGetErrorString(err);
}

}  // namespace multinn_torch
