// Grid-free NADE exact-likelihood logits and their reverse sweep, for
// track-stacked rows: x, bv, logits (K, N, D); bh, a_D, dbh (K, N, H);
// w, v (K, D, H).
//
//   forward   a = bh;  per dim i:  h = sigmoid(a),  logit_i = bv_i + V_i . h,
//                                  a += x_i W_i;    saves a_D only
//   backward  from a_D, i = D-1 .. 0:  a -= x_i W_i,  h = sigmoid(a),
//             dV_i = sum_n g_i h,  dW_i = sum_n x_i r,  dx_i = W_i . r,
//             r += (V_i g_i) h (1 - h);            dbh = r at the end
//
// Replaces multinn_tpu/ops/nade_ll_pallas.py::_fwd_kernel (wrapper _fwd_2d)
// and ::_bwd_kernel (wrapper _bwd_2d). Like them, neither kernel builds the
// (N, D, H) activation grid of the parallel forms (about 1 GB per tensor at
// the NADE flagship's training shape): the running activation lives in
// registers and device memory sees O(N (D + H)) floats per direction.
//
// Layout: one CTA per (tile of 32 rows, track), one thread per hidden lane
// (H rounded up to a warp; lanes past H carry zeros). Each thread keeps
// a[lane, row] (and, backward, the suffix sum r) for the tile's 32 rows in
// registers, so the two reductions over rows are in-thread: dV_i and dW_i
// accumulate per thread in row order and are written as per-tile partials,
// which a second pass sums in tile order. The reductions over H (the
// logits, dx) cross threads: a transposed shuffle reduction leaves warp w's
// sum for row l in lane l (31 shuffles for 32 rows, not 5 per row), and the
// warps' sums are added in warp order. No float atomics anywhere, so a
// launch reproduces its results bit for bit.
//
// Bound: arithmetic, not memory. Each (row, dim, lane) costs one sigmoid
// (an exp and a divide) and a few FMAs: 5 tracks x 4096 rows x 84 dims x
// 160 lanes = 275 M sigmoids per direction at the flagship shape, against
// about 20 MB of traffic. The transposed reduction keeps the shuffles at
// one per row and dim; the backward skips dx (and with it every barrier in
// the sweep) when no input gradient is asked for. Tensor cores and shared-
// memory weight tiles are later work.
#include <cuda_runtime.h>

#include "launchers.h"
#include "threefry.cuh"

namespace multinn_torch {
namespace {

constexpr int kRows = kNadeLLTileRows;  // rows per CTA: one per warp lane
constexpr int kMaxThreads = 512;        // H <= 512; 128 registers a thread
static_assert(kRows == 32, "the transposed reduction maps rows to lanes");

// One level of the transposed reduction: lanes exchange half of their
// window with the lane S away, and each keeps the half its bit S selects.
template <int S>
__device__ __forceinline__ void reduce_level(float (&v)[kRows], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float send = upper ? v[j] : v[j + S];
    const float keep = upper ? v[j + S] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// v[r] on each lane -> the warp's sum of v[lane], in a fixed order.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[kRows],
                                                    int lane) {
  reduce_level<16>(v, lane);
  reduce_level<8>(v, lane);
  reduce_level<4>(v, lane);
  reduce_level<2>(v, lane);
  reduce_level<1>(v, lane);
  return v[0];
}

// The warps' row sums of dim i (double-buffered by the dim's parity, so a
// warp may write dim i+1's while thread r still reads dim i's): thread
// r < kRows returns their total for row r, summed in warp order.
__device__ __forceinline__ float block_row_sum(float* red, float s, int i,
                                               int tid, int n_warps) {
  float* rd = red + (i & 1) * n_warps * kRows;
  rd[(tid >> 5) * kRows + (tid & 31)] = s;
  __syncthreads();
  float t = 0.f;
  if (tid < kRows)
    for (int q = 0; q < n_warps; ++q) t += rd[q * kRows + tid];
  return t;
}

__global__ void __launch_bounds__(kMaxThreads)
    nade_ll_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ v,
                       const float* __restrict__ bv,
                       const float* __restrict__ bh,
                       float* __restrict__ logits, float* __restrict__ a_end,
                       int n, int d, int h) {
  extern __shared__ float smem[];
  float* x_s = smem;              // (kRows, d) the tile's x
  float* o_s = x_s + kRows * d;   // (kRows, d) bv, then the logits
  float* red = o_s + kRows * d;   // (2, n_warps, kRows)
  const int tid = threadIdx.x, lane = tid & 31, n_warps = blockDim.x >> 5;
  const int track = blockIdx.y, row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  const size_t xo = (static_cast<size_t>(track) * n + row0) * d;
  const size_t ho = (static_cast<size_t>(track) * n + row0) * h;
  for (int o = tid; o < kRows * d; o += blockDim.x) {
    const bool in = o < rows * d;
    x_s[o] = in ? x[xo + o] : 0.f;
    o_s[o] = in ? bv[xo + o] : 0.f;
  }
  const bool on = tid < h;  // a real hidden lane
  const float* wk = w + static_cast<size_t>(track) * d * h + tid;
  const float* vk = v + static_cast<size_t>(track) * d * h + tid;
  float a[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    a[r] = (on && r < rows) ? bh[ho + static_cast<size_t>(r) * h + tid] : 0.f;
  __syncthreads();

  for (int i = 0; i < d; ++i) {
    const float wi = on ? wk[static_cast<size_t>(i) * h] : 0.f;
    const float vi = on ? vk[static_cast<size_t>(i) * h] : 0.f;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      p[r] = vi * sigmoid_f32(a[r]);
      a[r] = fmaf(x_s[r * d + i], wi, a[r]);
    }
    const float t = block_row_sum(red, warp_transpose_sum(p, lane), i, tid,
                                  n_warps);
    if (tid < kRows) o_s[tid * d + i] += t;
  }
  __syncthreads();
  for (int o = tid; o < rows * d; o += blockDim.x) logits[xo + o] = o_s[o];
  if (on) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) a_end[ho + static_cast<size_t>(r) * h + tid] = a[r];
  }
}

template <bool kWantDx>
__global__ void __launch_bounds__(kMaxThreads)
    nade_ll_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ v,
                       const float* __restrict__ g,
                       const float* __restrict__ a_end,
                       float* __restrict__ dw_part,  // (K, tiles, d, h)
                       float* __restrict__ dv_part,  // (K, tiles, d, h)
                       float* __restrict__ dx, float* __restrict__ dbh,
                       int n, int d, int h) {
  extern __shared__ float smem[];
  float* x_s = smem;              // (kRows, d)
  float* g_s = x_s + kRows * d;   // (kRows, d)
  float* dx_s = g_s + kRows * d;  // (kRows, d), when kWantDx
  float* red = dx_s + kRows * d;  // (2, n_warps, kRows), when kWantDx
  const int tid = threadIdx.x, lane = tid & 31, n_warps = blockDim.x >> 5;
  const int track = blockIdx.y, tile = blockIdx.x, row0 = tile * kRows;
  const int rows = min(kRows, n - row0);
  const size_t xo = (static_cast<size_t>(track) * n + row0) * d;
  const size_t ho = (static_cast<size_t>(track) * n + row0) * h;
  for (int o = tid; o < kRows * d; o += blockDim.x) {
    const bool in = o < rows * d;
    x_s[o] = in ? x[xo + o] : 0.f;
    g_s[o] = in ? g[xo + o] : 0.f;
  }
  const bool on = tid < h;
  const size_t wo = static_cast<size_t>(track) * d * h + tid;
  const size_t po =
      (static_cast<size_t>(track) * gridDim.x + tile) * d * h + tid;
  float a[kRows], r_[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    a[r] = (on && r < rows) ? a_end[ho + static_cast<size_t>(r) * h + tid]
                            : 0.f;
    r_[r] = 0.f;
  }
  __syncthreads();

  for (int i = d - 1; i >= 0; --i) {
    const float wi = on ? w[wo + static_cast<size_t>(i) * h] : 0.f;
    const float vi = on ? v[wo + static_cast<size_t>(i) * h] : 0.f;
    if (kWantDx) {  // dx_i = W_i . r, with r before dim i's update
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) p[r] = wi * r_[r];
      const float t = block_row_sum(red, warp_transpose_sum(p, lane), i, tid,
                                    n_warps);
      if (tid < kRows) dx_s[tid * d + i] = t;
    }
    float dv = 0.f, dw = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float xr = x_s[r * d + i], gr = g_s[r * d + i];
      a[r] = a[r] - xr * wi;  // a_i, downdated from a_{i+1}
      const float hv = sigmoid_f32(a[r]);
      dv = fmaf(gr, hv, dv);
      dw = fmaf(xr, r_[r], dw);
      r_[r] += (vi * gr) * (hv - hv * hv);
    }
    if (on) {
      dw_part[po + static_cast<size_t>(i) * h] = dw;
      dv_part[po + static_cast<size_t>(i) * h] = dv;
    }
  }
  if (kWantDx) {
    __syncthreads();
    for (int o = tid; o < rows * d; o += blockDim.x) dx[xo + o] = dx_s[o];
  }
  if (on) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) dbh[ho + static_cast<size_t>(r) * h + tid] = r_[r];
  }
}

// out[k, e] = sum over tiles t, in order, of part[k, t, e].
__global__ void sum_tiles_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int tiles,
                                 int64_t per_track, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  const int64_t k = idx / per_track, e = idx - k * per_track;
  const float* p = part + k * tiles * per_track + e;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += p[static_cast<int64_t>(t) * per_track];
  out[idx] = s;
}

int threads_for(int64_t h) {
  return static_cast<int>(((h + 31) / 32) * 32);
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
// A refusal is also cleared from CUDA's last-error state: the caller
// raises, and the next launch in the process must not report it again.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

const char* last_error() {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? nullptr : cudaGetErrorString(err);
}

}  // namespace

const char* launch_nade_ll_fwd(const float* x, const float* w, const float* v,
                               const float* bv, const float* bh,
                               float* logits, float* a_end, int64_t k,
                               int64_t n, int64_t d, int64_t h,
                               void* stream) {
  if (k <= 0 || n <= 0 || d <= 0) return nullptr;
  const int threads = threads_for(h);
  const size_t smem =
      sizeof(float) * (2 * kRows * static_cast<size_t>(d) +
                       2 * static_cast<size_t>(threads / 32) * kRows);
  const cudaError_t e = allow_smem(nade_ll_fwd_kernel, smem);
  if (e != cudaSuccess) return cudaGetErrorString(e);
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows),
                  static_cast<unsigned>(k));
  nade_ll_fwd_kernel<<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, w, v, bv, bh, logits, a_end, static_cast<int>(n),
      static_cast<int>(d), static_cast<int>(h));
  return last_error();
}

const char* launch_nade_ll_bwd(const float* x, const float* w, const float* v,
                               const float* g, const float* a_end,
                               float* dw_part, float* dv_part, float* dw,
                               float* dv, float* dx, float* dbh, int64_t k,
                               int64_t n, int64_t d, int64_t h,
                               void* stream) {
  if (k <= 0 || d <= 0 || h <= 0) return nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + kRows - 1) / kRows;
  if (n > 0) {
    const int threads = threads_for(h);
    const bool want_dx = dx != nullptr;
    const size_t smem =
        sizeof(float) *
        ((want_dx ? 3 : 2) * kRows * static_cast<size_t>(d) +
         (want_dx ? 2 * static_cast<size_t>(threads / 32) * kRows : 0));
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(k));
    const auto kernel =
        want_dx ? nade_ll_bwd_kernel<true> : nade_ll_bwd_kernel<false>;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return cudaGetErrorString(e);
    kernel<<<grid, threads, smem, s>>>(x, w, v, g, a_end, dw_part, dv_part,
                                       dx, dbh, static_cast<int>(n),
                                       static_cast<int>(d),
                                       static_cast<int>(h));
    if (const char* err = last_error()) return err;
  }
  const int64_t per_track = d * h, total = k * per_track;
  const int blocks = static_cast<int>((total + 255) / 256);
  sum_tiles_kernel<<<blocks, 256, 0, s>>>(dw_part, dw, static_cast<int>(tiles),
                                          per_track, total);
  if (const char* err = last_error()) return err;
  sum_tiles_kernel<<<blocks, 256, 0, s>>>(dv_part, dv, static_cast<int>(tiles),
                                          per_track, total);
  return last_error();
}

}  // namespace multinn_torch
