// NADE ancestral sampling sweep of one frame over D dims, for n rows with
// per-row biases:
//   a = bh;  for i < D:  p = sigmoid(bv_i + V_i . sigmoid(a)),
//                        x_i = (u_i < p),  a += x_i * W_i.
//
// Replaces multinn_tpu/ops/nade_pallas.py::_kernel (wrapper _sample_2d), the
// per-step sampler of the RNN-NADE scan path. The Pallas kernel keeps W, V
// and the (H, B) running activation in VMEM and advances all rows together.
// Here ONE CTA PER ROW carries its activation through the D dims in shared
// memory, threads over the H hidden lanes; each thread owns fixed lanes, so
// only the logit's block reduction needs a barrier.
//
// Random stream: the Pallas kernel draws one (D, n) uniform matrix up front
// under key (seed[0] ^ block * 0x85EB, seed[1]) with block 0 (its grid is
// (1,), and under jax.vmap the batching rule prepends the vmapped axis to
// the grid, so program_id(0) stays 0): the draw of (dim i, row b) has
// counter i * n + b. This kernel draws the same counters into shared memory
// before the sweep, keeping Threefry off the serial chain.
//
// Bound: the D serial dims. Per dim a row reads one V row and, when x_i is
// set, one W row (H floats each, through L1/L2), and pays one barrier, so a
// launch costs about D dependent L2 round trips whatever n is below one CTA
// per SM. The logit is summed lane -> warp (fixed shuffle tree) -> the
// warps' partials in order, so the kernel is deterministic.
#include <cuda_runtime.h>

#include "launchers.h"
#include "reduce.cuh"
#include "sigmoid.cuh"
#include "threefry.cuh"

namespace multinn_torch {
namespace {

constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads)
    nade_sample_kernel(const float* __restrict__ w,   // (d, h)
                       const float* __restrict__ v,   // (d, h)
                       const float* __restrict__ bv,  // (n, d)
                       const float* __restrict__ bh,  // (n, h)
                       const int32_t* __restrict__ seed,
                       float* __restrict__ out,       // (n, d)
                       int n, int d, int h) {
  extern __shared__ float smem[];
  float* act = smem;        // (h) running activation a
  float* sig = act + h;     // (h) sigmoid(a)
  float* u_s = sig + h;     // (d) this row's uniforms
  float* red = u_s + d;     // (2, 32) warp partials, double-buffered
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const uint32_t s0 = static_cast<uint32_t>(seed[0]);
  const uint32_t s1 = static_cast<uint32_t>(seed[1]);
  for (int j = tid; j < h; j += nt) {
    const float x = bh[static_cast<size_t>(b) * h + j];
    act[j] = x;
    sig[j] = sigmoid_f32(x);
  }
  for (int i = tid; i < d; i += nt)
    u_s[i] = random_uniform_at(
        s0, s1, static_cast<uint32_t>(i) * static_cast<uint32_t>(n) + b);
  __syncthreads();

  for (int i = 0; i < d; ++i) {
    // two buffers: a warp may write dim i+1's partial while a slower
    // thread still sums dim i's
    float* rd = red + (i & 1) * 32;
    const float* vi = v + static_cast<size_t>(i) * h;
    float part = 0.f;
    for (int j = tid; j < h; j += nt) part = fmaf(vi[j], sig[j], part);
    part = warp_sum(part);
    if (lane == 0) rd[warp] = part;
    __syncthreads();
    float s = 0.f;
    for (int q = 0; q < n_warps; ++q) s += rd[q];
    const bool x = u_s[i] < sigmoid_f32(s + bv[static_cast<size_t>(b) * d + i]);
    if (tid == 0) out[static_cast<size_t>(b) * d + i] = x ? 1.f : 0.f;
    if (x) {
      const float* wi = w + static_cast<size_t>(i) * h;
      for (int j = tid; j < h; j += nt) {
        const float a = act[j] + wi[j];
        act[j] = a;
        sig[j] = sigmoid_f32(a);
      }
    }
  }
}

}  // namespace

const char* launch_nade_sample(const float* w, const float* v,
                               const float* bv, const float* bh,
                               const int32_t* seed, float* out, int64_t n,
                               int64_t d, int64_t h, void* stream) {
  if (n <= 0 || d <= 0) return nullptr;
  const int threads = static_cast<int>(
      h >= kMaxThreads ? kMaxThreads : ((h + 31) / 32) * 32);
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(h) + static_cast<size_t>(d) + 64);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nade_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // cleared: the caller raises this error itself
      return cudaGetErrorString(e);
    }
  }
  nade_sample_kernel<<<static_cast<int>(n), threads > 0 ? threads : 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      w, v, bv, bh, seed, out, static_cast<int>(n), static_cast<int>(d),
      static_cast<int>(h));
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? nullptr : cudaGetErrorString(err);
}

}  // namespace multinn_torch
