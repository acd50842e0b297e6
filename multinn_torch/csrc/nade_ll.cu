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
// Layout: tiles of 32 rows. The backward runs one thread per hidden lane (H
// rounded up to a warp; lanes past H carry zeros), each keeping a[lane,
// row] and the suffix sum r for the tile's 32 rows in registers, so the two
// reductions over rows are in-thread; its dx sum over H crosses threads in a
// transposed shuffle reduction (warp w's sum for row l ends in lane l, 31
// shuffles for 32 rows), and the warps' sums are added in warp order. The
// forward splits the tile's 32 rows x 32 lanes of a warp into 8 x 4 per
// thread (see nade_ll_fwd_kernel). No float atomics anywhere, so a launch
// reproduces its results bit for bit.
//
// Bound: arithmetic, not memory. The backward pays one sigmoid per (row,
// dim, lane) (an exp and a reciprocal on the SFU, 16 a clock per SM) and a
// few FMAs: 5 tracks x 4096 rows x 84 dims x 160 lanes = 275 M triples at
// the flagship shape, about 0.15 ms of SFU time on the H100, against about
// 20 MB of traffic. The forward refreshes h only where x_i != 0 (at
// training density about 15 times fewer sigmoids) and is bound by issuing
// its dot products and shuffle sums.
//
// Both are persistent grids: G CTAs per track and H chunk
// (ops/nade_ll.fwd_plan and bwd_plan: one wave of the card's resident CTA
// slots), each walking tiles c, c + G, ... in order; H is split into chunks
// when its lanes exceed a CTA's threads or, backward, its accumulators a
// CTA's shared memory. What the backward does about its costs:
//   * dV_i and dW_i are summed per thread over a tile's rows, then into the
//     CTA's (D, chunk) accumulators in shared memory (thread `lane` owns
//     column `lane`, so neither a barrier nor an atomic), written once per
//     CTA as (K, G, D, H) partials and summed over the CTAs in order by a
//     second pass;
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
//   * dx (and with it a barrier per dim) only when asked for; with C > 1
//     chunks each writes its part of dx to (C, K, N, D), summed in chunk
//     order by a third pass.
// At the training shape on the H100 the sweep runs at about twice its SFU
// floor, with 10 warps on an SM's 4 schedulers; dx adds a 32-row
// transposed shuffle sum and a barrier per dim.
#include <cuda_runtime.h>

#include "launchers.h"
#include "sigmoid.cuh"

namespace multinn_torch {
namespace {

constexpr int kRows = kNadeLLTileRows;  // rows per tile: one per warp lane
constexpr int kMaxThreads = 512;    // backward: lanes of an H chunk
constexpr int kFwdMaxLanes = 256;  // forward: lanes of an H chunk
constexpr int kFwdLanes = 4;       // forward: hidden lanes a thread
constexpr int kFwdDims = 32;       // forward: dims per block of partials
// the forward's partials: a dim's 32 rows at an odd pitch, so the block
// sums (threads over dims) read 32 different banks
constexpr int kRedPitch = kRows + 1;
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
template <int S, int N>
__device__ __forceinline__ void reduce_level(float (&v)[N], int lane) {
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

// The forward: a persistent grid (G, K, C) of CTAs, ops/nade_ll.fwd_plan.
// CTA (g, k, c) walks the tiles g, g + G, ... of track k over the hidden
// lanes [c * chunk, c * chunk + chunk) of H. Each thread carries 8 rows x
// kFwdLanes hidden lanes of the tile in registers, a and h = sigmoid(a):
// lane group lg = lane & 7 owns lanes warp * 32 + lg + 8 c (c < kFwdLanes)
// of the chunk, row group rg = lane >> 3 owns rows 8 rg + e (e < 8). At
// dim i:
//   * each thread sums V_i h over its lanes for its 8 rows, and a 3-level
//     transposed shuffle sum over the warp's 8 lane groups leaves row
//     `lane`'s partial in lane `lane` (7 shuffles a warp, where one hidden
//     lane a thread needed 31); the warp writes it to shared memory as its
//     partial of dim i: no barrier and no cross-warp sum per dim. Every
//     kFwdDims dims one barrier, then the CTA sums the block's partials over
//     its warps, in warp order, into the logits;
//   * a and h move only for the rows whose x_i != 0 (the per-dim row masks;
//     a branch per row of the thread's row group), so the sigmoids follow
//     the nonzeros of x, not N D H; a += x_i W_i in dim order, as before
//     (a + 0 W = a).
// W_i and V_i come from L2 a dim ahead. With C > 1 chunks each writes its
// partial logits to part (C, K, N, D), and a second pass adds them in
// chunk order to bv.
__global__ void __launch_bounds__(kFwdMaxLanes, 2)
    nade_ll_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ v,
                       const float* __restrict__ bv,
                       const float* __restrict__ bh,
                       float* __restrict__ logits, float* __restrict__ part,
                       float* __restrict__ a_end, int n, int d, int h,
                       int chunk) {
  constexpr int kL = kFwdLanes;
  static_assert(8 * kL == 32, "a warp's lane groups cover 32 hidden lanes");
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lg = lane & 7, rg = lane >> 3;
  const int n_warps = blockDim.x >> 5;
  const int block_floats = n_warps * kFwdDims * kRedPitch;
  float* red = smem;  // (2, n_warps, kFwdDims, kRedPitch) by block parity
  uint32_t* one_s = reinterpret_cast<uint32_t*>(red + 2 * block_floats);
  uint32_t* gen_s = one_s + d;  // per dim: rows where x = 1, x not 0 or 1
  const int track = blockIdx.y, c0 = blockIdx.z, n_chunks = gridDim.z;
  const int j0 = c0 * chunk, lanes = min(chunk, h - j0);
  bool on[kL];
  size_t wo[kL];
#pragma unroll
  for (int c = 0; c < kL; ++c) {
    const int jl = warp * 8 * kL + lg + 8 * c;
    on[c] = jl < lanes;
    wo[c] = static_cast<size_t>(track) * d * h + j0 + jl;
  }
  const int tiles = (n + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kRows, rows = min(kRows, n - row0);
    const size_t xo = (static_cast<size_t>(track) * n + row0) * d;
    const size_t ho = (static_cast<size_t>(track) * n + row0) * h + j0;
    __syncthreads();  // the last tile's masks and partials are read
    for (int i = tid; i < d; i += blockDim.x) {
      uint32_t one = 0, gen = 0;
#pragma unroll 8
      for (int r = 0; r < kRows; ++r) {
        const float xv = r < rows ? x[xo + static_cast<size_t>(r) * d + i]
                                  : 0.f;
        one |= static_cast<uint32_t>(xv == 1.f) << r;
        gen |= static_cast<uint32_t>(xv != 0.f && xv != 1.f) << r;
      }
      one_s[i] = one;
      gen_s[i] = gen;
    }
    float a[8][kL], hv[8][kL];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = rg * 8 + e;
#pragma unroll
      for (int c = 0; c < kL; ++c) {
        const int jl = warp * 8 * kL + lg + 8 * c;
        a[e][c] = (on[c] && r < rows)
                      ? bh[ho + static_cast<size_t>(r) * h + jl] : 0.f;
        hv[e][c] = sigmoid_exp2(a[e][c] * -kLog2e);
      }
    }
    __syncthreads();
    float wn[kL], vn[kL];
#pragma unroll
    for (int c = 0; c < kL; ++c) {
      wn[c] = on[c] ? w[wo[c]] : 0.f;
      vn[c] = on[c] ? v[wo[c]] : 0.f;
    }
    for (int i0 = 0; i0 < d; i0 += kFwdDims) {
      float* rb = red + ((i0 / kFwdDims) & 1) * block_floats;
      const int nd = min(kFwdDims, d - i0);
      for (int ii = 0; ii < nd; ++ii) {
        const int i = i0 + ii;
        float wi[kL], vi[kL];
#pragma unroll
        for (int c = 0; c < kL; ++c) {
          wi[c] = wn[c];
          vi[c] = vn[c];
          if (on[c] && i + 1 < d) {
            wn[c] = w[wo[c] + static_cast<size_t>(i + 1) * h];
            vn[c] = v[wo[c] + static_cast<size_t>(i + 1) * h];
          }
        }
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float t = 0.f;
#pragma unroll
          for (int c = 0; c < kL; ++c) t = fmaf(vi[c], hv[e][c], t);
          p[e] = t;
        }
        reduce_level<4>(p, lane);
        reduce_level<2>(p, lane);
        reduce_level<1>(p, lane);
        rb[(warp * kFwdDims + ii) * kRedPitch + lane] = p[0];
        // the masks are the same for every thread; the bits of its rows
        const uint32_t gen = gen_s[i] >> (8 * rg);
        const uint32_t any = (one_s[i] >> (8 * rg) | gen) & 0xFFu;
        if (any == 0) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (((any >> e) & 1u) == 0) continue;
          const float xr =
              ((gen >> e) & 1u)
                  ? x[xo + static_cast<size_t>(rg * 8 + e) * d + i]
                  : 1.f;
#pragma unroll
          for (int c = 0; c < kL; ++c) {
            a[e][c] = fmaf(xr, wi[c], a[e][c]);
            hv[e][c] = sigmoid_exp2(a[e][c] * -kLog2e);
          }
        }
      }
      __syncthreads();  // the block's partials are written
      for (int o = tid; o < rows * nd; o += blockDim.x) {
        const int r = o / nd, ii = o - r * nd;
        float t = 0.f;
        for (int q = 0; q < n_warps; ++q)
          t += rb[(q * kFwdDims + ii) * kRedPitch + r];
        const size_t at = xo + static_cast<size_t>(r) * d + i0 + ii;
        if (n_chunks == 1)
          logits[at] = bv[at] + t;
        else
          part[static_cast<size_t>(c0) * gridDim.y * n * d + at] = t;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = rg * 8 + e;
#pragma unroll
      for (int c = 0; c < kL; ++c)
        if (on[c] && r < rows)
          a_end[ho + static_cast<size_t>(r) * h + warp * 8 * kL + lg + 8 * c] =
              a[e][c];
    }
  }
}

// out[e] = (bias ? bias[e] : 0) + sum over c < n_parts, in order, of
// part[c * total + e]: the chunks' partial logits (with bv) or dx.
__global__ void sum_chunks_kernel(const float* __restrict__ part,
                                  const float* __restrict__ bias,
                                  float* __restrict__ out, int n_parts,
                                  int64_t total) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= total) return;
  float s = bias != nullptr ? bias[e] : 0.f;
  float t = 0.f;
  for (int c = 0; c < n_parts; ++c) t += part[c * total + e];
  out[e] = s + t;
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
                       int n, int d, int h, int chunk) {
  extern __shared__ float smem[];
  float* dv_acc = smem;               // (d, chunk): this CTA's dV, its tiles
  float* dw_acc = dv_acc + d * chunk;  // (d, chunk): its dW
  // (d, kGPitch): the tile's g by dim, a dim's rows read as float4s
  float* g_s = smem + round4(2 * d * chunk);
  float* red = g_s + kGPitch * d;  // (2, n_warps, kRows), when kWantDx
  const int tid = threadIdx.x, lane = tid & 31, n_warps = blockDim.x >> 5;
  // per dim of the tile: the rows where x = 1, and where x is neither 0
  // nor 1 (read from x itself)
  uint32_t* one_s = reinterpret_cast<uint32_t*>(red + 2 * n_warps * kRows);
  uint32_t* gen_s = one_s + d;
  const int track = blockIdx.y, n_ctas = gridDim.x;
  const int tiles = (n + kRows - 1) / kRows;
  // the CTA's chunk of hidden lanes: [j0, j0 + chunk) of H; dx is this
  // chunk's part, written to (C, K, N, D) when there are C > 1 chunks
  const int j0 = blockIdx.z * chunk;
  // a real hidden lane; it alone owns column tid of the accumulators
  const bool on = tid < min(chunk, h - j0);
  const size_t wo = static_cast<size_t>(track) * d * h + j0 + tid;
  float* dx_c =
      dx == nullptr
          ? nullptr
          : dx + static_cast<size_t>(blockIdx.z) * gridDim.y * n * d;
  if (on)
    for (int i = 0; i < d; ++i)
      dv_acc[i * chunk + tid] = dw_acc[i * chunk + tid] = 0.f;

  for (int tile = blockIdx.x; tile < tiles; tile += n_ctas) {
    const int row0 = tile * kRows, rows = min(kRows, n - row0);
    const size_t xo = (static_cast<size_t>(track) * n + row0) * d;
    const size_t ho = (static_cast<size_t>(track) * n + row0) * h + j0;
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
        if (tid < rows) dx_c[xo + static_cast<size_t>(tid) * d + i] = t;
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
        dv_acc[i * chunk + tid] += dv;
        dw_acc[i * chunk + tid] += dw;
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
        (static_cast<size_t>(track) * n_ctas + blockIdx.x) * d * h + j0 + tid;
    for (int i = 0; i < d; ++i) {
      dv_part[po + static_cast<size_t>(i) * h] = dv_acc[i * chunk + tid];
      dw_part[po + static_cast<size_t>(i) * h] = dw_acc[i * chunk + tid];
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

int threads_for(int64_t lanes) {
  return static_cast<int>(((lanes + 31) / 32) * 32);
}

// The backward's dynamic shared memory for a chunk of `chunk` hidden lanes:
// the dV and dW accumulators, the tile's g, the row-sum buffer and the two
// x masks per dim. The launch plan (ops/nade_ll.bwd_plan) counts the same
// bytes.
size_t bwd_smem_bytes(int64_t d, int64_t chunk) {
  return sizeof(float) * static_cast<size_t>(round4(2 * d * chunk) +
                                             kGPitch * d +
                                             2 * (threads_for(chunk) / 32) *
                                                 kRows) +
         sizeof(uint32_t) * 2 * static_cast<size_t>(d);
}

// The forward's: the two blocks of warp partials and the x masks
// (ops/nade_ll.fwd_plan counts the same bytes).
size_t fwd_smem_bytes(int64_t d, int64_t chunk) {
  return sizeof(float) * 2 * static_cast<size_t>(threads_for(chunk) / 32) *
             kFwdDims * kRedPitch +
         sizeof(uint32_t) * 2 * static_cast<size_t>(d);
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in,
// and the plans count on the SM's whole 228 KB as shared memory, not L1.
// A refusal is also cleared from CUDA's last-error state: the caller
// raises, and the next launch in the process must not report it again.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t e = cudaSuccess;
  if (bytes > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

const char* last_error() {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? nullptr : cudaGetErrorString(err);
}

// The C chunks' parts (C, total) summed in order into out (plus bias).
const char* sum_chunks(const float* part, const float* bias, float* out,
                       int64_t n_chunks, int64_t total, cudaStream_t s) {
  sum_chunks_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      part, bias, out, static_cast<int>(n_chunks), total);
  return last_error();
}

// The plan's sizes, checked where a bad one would fault.
const char* check_plan(int64_t n_ctas, int64_t chunk, int64_t max_lanes,
                       size_t smem) {
  if (n_ctas <= 0 || chunk <= 0 || chunk > max_lanes)
    return "nade_ll: the launch plan's CTAs or hidden chunk are out of range";
  if (smem > static_cast<size_t>(kSmemLimitBytes))
    return "nade_ll: the launch plan needs more than a CTA's 227 KB of "
           "shared memory";
  return nullptr;
}

}  // namespace

const char* launch_nade_ll_fwd(const float* x, const float* w, const float* v,
                               const float* bv, const float* bh,
                               float* logits, float* part, float* a_end,
                               int64_t k, int64_t n, int64_t d, int64_t h,
                               int64_t n_ctas, int64_t chunk, void* stream) {
  if (k <= 0 || n <= 0 || d <= 0) return nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_smem_bytes(d, chunk);
  if (const char* err = check_plan(n_ctas, chunk, kFwdMaxLanes, smem))
    return err;
  const int64_t n_chunks = (h + chunk - 1) / chunk;
  if (n_chunks > 1 && part == nullptr)
    return "nade_ll_fwd: more than one hidden chunk needs the partials";
  const dim3 grid(static_cast<unsigned>(n_ctas), static_cast<unsigned>(k),
                  static_cast<unsigned>(n_chunks));
  const cudaError_t e = allow_smem(nade_ll_fwd_kernel, smem);
  if (e != cudaSuccess) return cudaGetErrorString(e);
  nade_ll_fwd_kernel<<<grid, threads_for(chunk), smem, s>>>(
      x, w, v, bv, bh, logits, part, a_end, static_cast<int>(n),
      static_cast<int>(d), static_cast<int>(h), static_cast<int>(chunk));
  if (const char* err = last_error()) return err;
  return n_chunks > 1 ? sum_chunks(part, bv, logits, n_chunks, k * n * d, s)
                      : nullptr;
}

const char* launch_nade_ll_bwd(const float* x, const float* w, const float* v,
                               const float* g, const float* a_end,
                               float* dw_part, float* dv_part, float* dw,
                               float* dv, float* dx, float* dx_part,
                               float* dbh, int64_t k, int64_t n, int64_t d,
                               int64_t h, int64_t n_ctas, int64_t chunk,
                               void* stream) {
  if (k <= 0 || d <= 0 || h <= 0) return nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem_bytes(d, chunk);
  if (const char* err = check_plan(n_ctas, chunk, kMaxThreads, smem))
    return err;
  const int64_t n_chunks = (h + chunk - 1) / chunk;
  if (dx != nullptr && n_chunks > 1 && dx_part == nullptr)
    return "nade_ll_bwd: dx over more than one hidden chunk needs partials";
  const dim3 grid(static_cast<unsigned>(n_ctas), static_cast<unsigned>(k),
                  static_cast<unsigned>(n_chunks));
  const auto kernel =
      dx != nullptr ? nade_ll_bwd_kernel<true> : nade_ll_bwd_kernel<false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return cudaGetErrorString(e);
  float* dx_out = dx != nullptr && n_chunks > 1 ? dx_part : dx;
  kernel<<<grid, threads_for(chunk), smem, s>>>(
      x, w, v, g, a_end, dw_part, dv_part, dx_out, dbh, static_cast<int>(n),
      static_cast<int>(d), static_cast<int>(h), static_cast<int>(chunk));
  if (const char* err = last_error()) return err;
  const int64_t per_track = d * h, total = k * per_track;
  const int blocks = static_cast<int>((2 * total + 255) / 256);
  sum_parts_kernel<<<blocks, 256, 0, s>>>(dw_part, dv_part, dw, dv,
                                          static_cast<int>(n_ctas), per_track,
                                          total);
  if (const char* err = last_error()) return err;
  return dx_out != dx ? sum_chunks(dx_part, nullptr, dx, n_chunks, k * n * d, s)
                      : nullptr;
}

}  // namespace multinn_torch
