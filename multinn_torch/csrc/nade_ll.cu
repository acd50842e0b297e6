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
// Layout: tiles of 32 rows, one thread per hidden lane (H rounded up to a
// warp; lanes past H carry zeros). Each thread keeps a[lane, row] (and,
// backward, the suffix sum r) for the tile's 32 rows in registers, so the
// two reductions over rows are in-thread. The reductions over H (the
// logits, dx) cross threads: a transposed shuffle reduction leaves warp w's
// sum for row l in lane l (31 shuffles for 32 rows, not 5 per row), and the
// warps' sums are added in warp order. No float atomics anywhere, so a
// launch reproduces its results bit for bit.
//
// Bound: arithmetic, not memory. Each (row, dim, lane) costs one sigmoid
// (an exp and a reciprocal on the SFU, 16 a clock per SM) and a few FMAs:
// 5 tracks x 4096 rows x 84 dims x 160 lanes = 275 M triples per direction
// at the flagship shape, about 0.15 ms of SFU time on the H100, against
// about 20 MB of traffic.
//
// The forward runs one CTA per (tile, track). The backward is a persistent
// grid of G CTAs per track (ops/nade_ll.bwd_plan: one wave of the card's
// resident CTA slots, two 115 KB CTAs per SM at the flagship), each walking
// tiles c, c + G, ... in order. What it does about its costs:
//   * dV_i and dW_i are summed per thread over a tile's rows, then into the
//     CTA's (D, H) accumulators in shared memory (thread `lane` owns column
//     `lane`, so neither a barrier nor an atomic), written once per CTA as
//     (K, G, D, H) partials and summed over the CTAs in order by a second
//     pass;
//   * the activations are kept as -a log2(e), and the sigmoid is the SFU's
//     ex2 and reciprocal estimates (sigmoid_exp2): no exp range reduction
//     and no IEEE division, whose slow-path branch would keep the rows'
//     sigmoids from overlapping;
//   * x is 0/1 and mostly 0 in training, and a row's x_i is the same for
//     every thread: per-dim row masks let a warp-uniform branch skip the
//     downdate and dW where no row of the tile has x_i != 0, and make x_i a
//     select elsewhere (a - 0 W = a exactly); an x neither 0 nor 1 is read
//     from x itself;
//   * W_i and V_i are loaded a dim ahead, g is read as float4s of 4 rows,
//     and a tile's loads are issued together;
//   * dx (and with it a barrier per dim) only when asked for.
// At the training shape on the H100 the sweep runs at about twice its SFU
// floor, with 10 warps on an SM's 4 schedulers; dx adds a 32-row
// transposed shuffle sum and a barrier per dim.
#include <cuda_runtime.h>

#include "launchers.h"
#include "sigmoid.cuh"

namespace multinn_torch {
namespace {

constexpr int kRows = kNadeLLTileRows;  // rows per tile: one per warp lane
constexpr int kMaxThreads = 512;        // H <= 512; 128 registers a thread
static_assert(kRows == 32, "the transposed reduction maps rows to lanes");
constexpr float kLog2e = 1.44269504f;
// the backward's g tile: a dim's 32 rows at a pitch that keeps float4
// reads aligned and spreads the staging writes over 8 banks
constexpr int kGPitch = kRows + 4;

__host__ __device__ constexpr int64_t round4(int64_t x) {
  return (x + 3) & ~int64_t{3};
}

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

// One dim i of the reverse sweep over a tile's rows, for one hidden lane.
// kDown: some row has x_i != 0, so a is downdated and dW accumulated, with
// x_i as a 0/1 select (a - 0 W_i = a and dw + 0 r = dw exactly: the rows
// with x_i = 0 change nothing); kGeneral: some x_i is neither 0 nor 1 and
// is read from x. No branch per row, so the rows' sigmoids overlap.
// The activations are kept as t = -a log2(e) (the sigmoid's own units,
// sigmoid_exp2), so the downdate adds x_i W_i log2(e) and the sigmoid is two
// SFU operations and an add.
template <bool kDown, bool kGeneral>
__device__ __forceinline__ void sweep_dim(float (&t)[kRows],
                                          float (&r_)[kRows],
                                          const float* g_dim,
                                          const float* __restrict__ x_col,
                                          int d, uint32_t one, uint32_t gen,
                                          float wl, float vi, float& dv,
                                          float& dw) {
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    const float4 g4 = reinterpret_cast<const float4*>(g_dim)[q];
    const float gq[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 4 * q + e;
      if (kDown) {
        float xr = ((one >> r) & 1u) ? 1.f : 0.f;
        if (kGeneral && ((gen >> r) & 1u))
          xr = x_col[static_cast<size_t>(r) * d];
        t[r] = fmaf(xr, wl, t[r]);  // t_i, downdated from t_{i+1}
        dw = fmaf(xr, r_[r], dw);
      }
      const float hv = sigmoid_exp2(t[r]);
      dv = fmaf(gq[e], hv, dv);
      r_[r] = fmaf(vi * gq[e], hv - hv * hv, r_[r]);
    }
  }
}

template <bool kWantDx>
__global__ void __launch_bounds__(kMaxThreads)
    nade_ll_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ v,
                       const float* __restrict__ g,
                       const float* __restrict__ a_end,
                       float* __restrict__ dw_part,  // (K, G, d, h)
                       float* __restrict__ dv_part,  // (K, G, d, h)
                       float* __restrict__ dx, float* __restrict__ dbh,
                       int n, int d, int h) {
  extern __shared__ float smem[];
  float* dv_acc = smem;               // (d, h): this CTA's dV over its tiles
  float* dw_acc = dv_acc + d * h;     // (d, h): its dW
  // (d, kGPitch): the tile's g by dim, a dim's rows read as float4s
  float* g_s = smem + round4(2 * d * h);
  float* red = g_s + kGPitch * d;  // (2, n_warps, kRows), when kWantDx
  const int tid = threadIdx.x, lane = tid & 31, n_warps = blockDim.x >> 5;
  // per dim of the tile: the rows where x = 1, and where x is neither 0
  // nor 1 (read from x itself)
  uint32_t* one_s = reinterpret_cast<uint32_t*>(red + 2 * n_warps * kRows);
  uint32_t* gen_s = one_s + d;
  const int track = blockIdx.y, n_ctas = gridDim.x;
  const int tiles = (n + kRows - 1) / kRows;
  const bool on = tid < h;  // a real hidden lane; it alone owns column tid
  const size_t wo = static_cast<size_t>(track) * d * h + tid;
  if (on)
    for (int i = 0; i < d; ++i)
      dv_acc[i * h + tid] = dw_acc[i * h + tid] = 0.f;

  for (int tile = blockIdx.x; tile < tiles; tile += n_ctas) {
    const int row0 = tile * kRows, rows = min(kRows, n - row0);
    const size_t xo = (static_cast<size_t>(track) * n + row0) * d;
    const size_t ho = (static_cast<size_t>(track) * n + row0) * h;
    __syncthreads();  // the last tile's g_s and masks are no longer read
    // the tile's loads are unrolled so that they are in flight together
#pragma unroll 8
    for (int o = tid; o < kRows * d; o += blockDim.x) {
      const int r = o / d, i = o - r * d;
      g_s[i * kGPitch + r] = o < rows * d ? g[xo + o] : 0.f;
    }
    for (int i = tid; i < d; i += blockDim.x) {
      float xv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        xv[r] = r < rows ? x[xo + static_cast<size_t>(r) * d + i] : 0.f;
      uint32_t one = 0, gen = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        one |= static_cast<uint32_t>(xv[r] == 1.f) << r;
        gen |= static_cast<uint32_t>(xv[r] != 0.f && xv[r] != 1.f) << r;
      }
      one_s[i] = one;
      gen_s[i] = gen;
    }
    float t[kRows], r_[kRows];  // t = -a log2(e)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      t[r] = (on && r < rows)
                 ? a_end[ho + static_cast<size_t>(r) * h + tid] * -kLog2e
                 : 0.f;
      r_[r] = 0.f;
    }
    __syncthreads();

    // W_i and V_i come from L2 a dim ahead of their use, so no dim waits
    // for them
    float wn = on ? w[wo + static_cast<size_t>(d - 1) * h] : 0.f;
    float vn = on ? v[wo + static_cast<size_t>(d - 1) * h] : 0.f;
    for (int i = d - 1; i >= 0; --i) {
      const float wi = wn, vi = vn;
      if (on && i > 0) {
        wn = w[wo + static_cast<size_t>(i - 1) * h];
        vn = v[wo + static_cast<size_t>(i - 1) * h];
      }
      if (kWantDx) {  // dx_i = W_i . r, with r before dim i's update
        float p[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) p[r] = wi * r_[r];
        const float t = block_row_sum(red, warp_transpose_sum(p, lane), i,
                                      tid, n_warps);
        if (tid < rows) dx[xo + static_cast<size_t>(tid) * d + i] = t;
      }
      // warp-uniform: every thread of the CTA reads the same masks
      const uint32_t one = one_s[i], gen = gen_s[i];
      const float* x_col = x + xo + i;
      const float* g_dim = g_s + i * kGPitch;
      const float wl = wi * kLog2e;
      float dv = 0.f, dw = 0.f;
      if (gen != 0)
        sweep_dim<true, true>(t, r_, g_dim, x_col, d, one, gen, wl, vi, dv,
                              dw);
      else if (one != 0)
        sweep_dim<true, false>(t, r_, g_dim, x_col, d, one, gen, wl, vi, dv,
                               dw);
      else
        sweep_dim<false, false>(t, r_, g_dim, x_col, d, one, gen, wl, vi, dv,
                                dw);
      if (on) {
        dv_acc[i * h + tid] += dv;
        dw_acc[i * h + tid] += dw;
      }
    }
    if (on) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) dbh[ho + static_cast<size_t>(r) * h + tid] = r_[r];
    }
  }
  if (on) {
    const size_t po =
        (static_cast<size_t>(track) * n_ctas + blockIdx.x) * d * h + tid;
    for (int i = 0; i < d; ++i) {
      dv_part[po + static_cast<size_t>(i) * h] = dv_acc[i * h + tid];
      dw_part[po + static_cast<size_t>(i) * h] = dw_acc[i * h + tid];
    }
  }
}

// out[k, e] = sum over the CTAs c of a track, in order, of part[k, c, e]:
// dW in the first `total` threads, dV in the next.
__global__ void sum_parts_kernel(const float* __restrict__ dw_part,
                                 const float* __restrict__ dv_part,
                                 float* __restrict__ dw,
                                 float* __restrict__ dv, int n_ctas,
                                 int64_t per_track, int64_t total) {
  int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 2 * total) return;
  const bool is_v = idx >= total;
  if (is_v) idx -= total;
  const int64_t k = idx / per_track, e = idx - k * per_track;
  const float* p = (is_v ? dv_part : dw_part) + k * n_ctas * per_track + e;
  float s = 0.f;
  for (int c = 0; c < n_ctas; ++c) s += p[static_cast<int64_t>(c) * per_track];
  (is_v ? dv : dw)[idx] = s;
}

int threads_for(int64_t h) {
  return static_cast<int>(((h + 31) / 32) * 32);
}

// The backward's dynamic shared memory: the dV and dW accumulators, the
// tile's g, the row-sum buffer and the two x masks per dim. The launch plan
// (ops/nade_ll.bwd_plan) counts the same bytes.
size_t bwd_smem_bytes(int64_t d, int64_t h) {
  return sizeof(float) * static_cast<size_t>(round4(2 * d * h) +
                                             kGPitch * d +
                                             2 * (threads_for(h) / 32) *
                                                 kRows) +
         sizeof(uint32_t) * 2 * static_cast<size_t>(d);
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
                               int64_t n, int64_t d, int64_t h, int64_t n_ctas,
                               void* stream) {
  if (k <= 0 || d <= 0 || h <= 0) return nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(h);
  const size_t smem = bwd_smem_bytes(d, h);
  const dim3 grid(static_cast<unsigned>(n_ctas), static_cast<unsigned>(k));
  const auto kernel =
      dx != nullptr ? nade_ll_bwd_kernel<true> : nade_ll_bwd_kernel<false>;
  cudaError_t e = allow_smem(kernel, smem);
  // two CTAs of the flagship's 113.5 KB per SM (the plan counts on them)
  // need the whole of the SM's 228 KB as shared memory, not L1
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return cudaGetErrorString(e);
  }
  kernel<<<grid, threads, smem, s>>>(x, w, v, g, a_end, dw_part, dv_part, dx,
                                     dbh, static_cast<int>(n),
                                     static_cast<int>(d),
                                     static_cast<int>(h));
  if (const char* err = last_error()) return err;
  const int64_t per_track = d * h, total = k * per_track;
  const int blocks = static_cast<int>((2 * total + 255) / 256);
  sum_parts_kernel<<<blocks, 256, 0, s>>>(dw_part, dv_part, dw, dv,
                                          static_cast<int>(n_ctas), per_track,
                                          total);
  return last_error();
}

}  // namespace multinn_torch
