// k-sweep block-Gibbs chain of an RBM with per-row biases:
//   h ~ Bern(sigmoid(v W + bh)),  v ~ Bern(sigmoid(h W^T + bv)),  k times.
//
// Replaces multinn_tpu/ops/gibbs_pallas.py::_kernel (wrapper gibbs_chain).
// The Pallas kernel tiles the rows into blocks of bb (its _block_b rule)
// and keys each block's stream with seed[0] ^ block * 0x85EB; the counter
// of a draw is (row within the block) * n_cols + col. This kernel keeps
// that STREAM layout, so it and its plain version (ops/gibbs_cuda.py) draw
// the same bits as the JAX kernel, but not its thread layout: a CTA's rows
// may straddle two stream blocks, so every row finds its own block.
//
// The row map: a launch may hold rows row0 .. row0 + loc - 1 of every
// group of glob consecutive rows of a larger launch (one data shard of a
// time-major (T, B) batch: loc = B_local, glob = B_global, row0 = b0).
// A row's stream block and counter are those of its row in that larger
// launch, so a shard draws the bits the whole batch would draw for it; the
// default (0, n, n) is the launch itself.
//
// Bound on the H100: per row and sweep 2*D*H multiply-adds and D + H
// Threefry draws of about 80 integer operations each. At the flagship
// widths (D=84, H=150) the draws' integer work is about as large as the
// multiply-adds, and Hopper issues 32-bit integer work at half its f32
// rate; the bytes (W, v0, the biases and the output, once each) are small.
// So the chain is bound by issued instructions when it has many rows, and
// by the latency of its two passes when it has few.
//
// Design. W lives in shared memory, copied in once per CTA by cp.async, at
// a row pitch chosen per plan so that neither pass has bank conflicts (see
// w_pitch, split_pitch), and no W^T is built. The sums are dense — v and
// h are 0/1, so every product is exact — with no branch per term, and a
// pass's biases and uniforms are fetched before its sums (the uniforms'
// counters do not depend on the chain), so their latency and the Threefry
// integer work overlap the multiply-adds. Two launch plans, chosen
// from N by ops/gibbs_cuda.launch_plan:
//   * throughput (lanes per dot 1; CD-1 and the k=25 chain): each warp owns
//     kRpw consecutive rows and carries them through all k sweeps alone —
//     its hidden pass reads only its rows' v and writes only their h — so
//     after W is staged no barrier is needed. A lane keeps a register block
//     of kRpw rows x kCols columns (hidden pass) or kRpw rows x kDims dims
//     (visible pass): each load of W feeds kRpw multiply-adds, and the
//     rows' v and h come as float4 broadcasts. Each output is one
//     accumulator summed in index order, as a sequential dot product.
//   * latency (lanes per dot L > 1; the scan path's 8 rows): one row per
//     CTA, so the rows run on different SMs; each output's dot product is
//     split over L lanes and closed by a fixed xor-shuffle sum, so a pass is
//     a chain of about D / L (or H / 4L float4) steps; two more warps draw
//     the next sweep's uniforms into shared memory while this sweep runs.
// Where W at its pitch and the plan's rows exceed a CTA's 227 KB, the
// launch plan is the throughput plan with W left in device memory and read
// through L1 / L2 (W stays resident in L2); only the rows' v and h are in
// shared memory, so any (D, H) that a warp's rows fit runs.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include "launchers.h"
#include "sigmoid.cuh"
#include "threefry.cuh"

namespace multinn_torch {
namespace {

constexpr int kWarps = 8;          // throughput plan: warps per CTA
constexpr int kCols = 5;           // hidden pass: column slots per lane
constexpr int kDims = 3;           // visible pass: dim slots per lane
constexpr int kSplitThreads = 256;  // latency plan: compute threads per CTA
constexpr int kSplitLanes = 8;      // latency plan: lanes per dot product
constexpr int kDrawWarps = 2;       // latency plan: warps that only draw

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int round32(int x) { return (x + 31) & ~31; }
// W's row pitch in shared memory. Throughput plan: odd, and at least H
// rounded up to 4 (lanes over columns, or over rows at stride P). Latency
// plan: 4 more than H rounded up to 32, so the 8 lanes of a group reading 8
// rows (hidden pass) hit 8 bank quads, and a group's float4s of one row
// (visible pass) fill the 32 banks once.
__host__ __device__ constexpr int w_pitch(int h) { return round4(h) + 1; }
__host__ __device__ constexpr int split_pitch(int h) {
  return round32(h) + 4;
}

// W (d, h) into w_s: round4(d) rows of pitch p, zero past d rows and h
// columns (the passes read that padding against zero v and h entries). The
// copies are asynchronous (cp.async), so all of a thread's loads from L2 are
// in flight at once; the caller's barrier publishes w_s.
__device__ void stage_w(const float* __restrict__ w, float* w_s, int d,
                        int h, int p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < round4(d); i += blockDim.x >> 5)
    for (int j = lane; j < p; j += 32) {
      if (i < d && j < h)
        __pipeline_memcpy_async(w_s + i * p + j,
                                w + static_cast<size_t>(i) * h + j,
                                sizeof(float));
      else
        w_s[i * p + j] = 0.f;
    }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// The Threefry key word and the row within its stream block of row grow.
struct RowStream {
  uint32_t seed, lrow;
};

// Rows per stream block (bb) and the row map (row0, loc, glob).
struct RowMap {
  int bb, row0, loc, glob;
};

__device__ __forceinline__ RowStream row_stream(uint32_t s0, int lrow_in,
                                                RowMap rm) {
  const uint32_t r = static_cast<uint32_t>(lrow_in);
  const uint32_t loc = static_cast<uint32_t>(rm.loc);
  const uint32_t g = (r / loc) * static_cast<uint32_t>(rm.glob) +
                     static_cast<uint32_t>(rm.row0) + r % loc;
  const uint32_t blk = g / rm.bb;
  return {s0 ^ (blk * 0x85EBu), g - blk * static_cast<uint32_t>(rm.bb)};
}

__device__ __forceinline__ float component(const float4& x, int q) {
  return q == 0 ? x.x : q == 1 ? x.y : q == 2 ? x.z : x.w;
}

// Throughput plan: warp w of CTA b owns rows (b * kWarps + w) * kRpw + r.
// kWSmem false is the device-memory plan: W is too large for shared memory
// beside the rows, so it stays in device memory at its own pitch and is read
// through L1 / L2, as the first port of this kernel did; the rows' v and h
// stay in shared memory. Its reads of the padding (rows past d, columns past
// h) are clamped to W's last row or column, whose products with the zero v
// and h padding add nothing.
template <int kRpw, bool kWSmem>
__global__ void __launch_bounds__(kWarps * 32)
    gibbs_rows_kernel(const float* __restrict__ v0,
                      const float* __restrict__ w,   // (d, h)
                      const float* __restrict__ bv,  // (n, d)
                      const float* __restrict__ bh,  // (n, h)
                      const int32_t* __restrict__ seed,
                      float* __restrict__ out, int n, int d, int h, int k,
                      RowMap rm) {
  extern __shared__ __align__(16) float smem[];
  const int dq = round4(d), hq = round4(h);
  const int p = kWSmem ? w_pitch(h) : h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* w_s = smem;  // (dq, p) when kWSmem
  float* v_s = w_s + (kWSmem ? dq * p : 0) + warp * kRpw * (dq + hq);
  float* h_s = v_s + kRpw * dq;  // (kRpw, hq); v_s (kRpw, dq)
  if (kWSmem) stage_w(w, w_s, d, h, p);
  const float* wr = kWSmem ? w_s : w;
  const int row0 = (blockIdx.x * kWarps + warp) * kRpw;
  const uint32_t s0 = static_cast<uint32_t>(seed[0]);
  const uint32_t s1 = static_cast<uint32_t>(seed[1]);
  RowStream rs[kRpw];
  bool live[kRpw];
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    live[r] = row0 + r < n;
    rs[r] = row_stream(s0, row0 + r, rm);
    for (int i = lane; i < dq; i += 32)
      v_s[r * dq + i] =
          (live[r] && i < d) ? v0[static_cast<size_t>(row0 + r) * d + i] : 0.f;
    for (int j = lane; j < hq; j += 32) h_s[r * hq + j] = 0.f;
  }
  __syncthreads();  // W staged; from here each warp works alone

  for (int it = 0; it < k; ++it) {
    const uint32_t salt_h = s1 + 2u * static_cast<uint32_t>(it);
    const uint32_t salt_v = salt_h + 1u;
    // hidden pass: lane owns columns j0 + lane + 32 c
    for (int j0 = 0; j0 < h; j0 += 32 * kCols) {
      int jc[kCols];
      float b[kRpw][kCols], u[kRpw][kCols], acc[kRpw][kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + lane + 32 * c;
        jc[c] = min(j, h - 1);
#pragma unroll
        for (int r = 0; r < kRpw; ++r) {
          b[r][c] = live[r] ? bh[static_cast<size_t>(row0 + r) * h + jc[c]]
                            : 0.f;
          u[r][c] = random_uniform_at(
              rs[r].seed, salt_h, rs[r].lrow * static_cast<uint32_t>(h) + j);
          acc[r][c] = 0.f;
        }
      }
      for (int i = 0; i < dq; i += 4) {
        float4 x[kRpw];
#pragma unroll
        for (int r = 0; r < kRpw; ++r)
          x[r] = *reinterpret_cast<const float4*>(v_s + r * dq + i);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float wv[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            wv[c] = wr[(kWSmem ? i + q : min(i + q, d - 1)) * p + jc[c]];
#pragma unroll
          for (int r = 0; r < kRpw; ++r)
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              acc[r][c] = fmaf(component(x[r], q), wv[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRpw; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int j = j0 + lane + 32 * c;
          if (live[r] && j < h)
            h_s[r * hq + j] =
                u[r][c] < sigmoid_f32(acc[r][c] + b[r][c]) ? 1.f : 0.f;
        }
    }
    __syncwarp();
    // visible pass: lane owns dims i0 + lane + 32 c
    for (int i0 = 0; i0 < d; i0 += 32 * kDims) {
      int io[kDims];
      float b[kRpw][kDims], u[kRpw][kDims], acc[kRpw][kDims];
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        const int i = i0 + lane + 32 * c;
        io[c] = min(i, d - 1) * p;
#pragma unroll
        for (int r = 0; r < kRpw; ++r) {
          b[r][c] = live[r]
                        ? bv[static_cast<size_t>(row0 + r) * d + min(i, d - 1)]
                        : 0.f;
          u[r][c] = random_uniform_at(
              rs[r].seed, salt_v, rs[r].lrow * static_cast<uint32_t>(d) + i);
          acc[r][c] = 0.f;
        }
      }
      for (int j = 0; j < hq; j += 4) {
        float4 y[kRpw];
#pragma unroll
        for (int r = 0; r < kRpw; ++r)
          y[r] = *reinterpret_cast<const float4*>(h_s + r * hq + j);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float wv[kDims];
#pragma unroll
          for (int c = 0; c < kDims; ++c)
            wv[c] = wr[io[c] + (kWSmem ? j + q : min(j + q, h - 1))];
#pragma unroll
          for (int r = 0; r < kRpw; ++r)
#pragma unroll
            for (int c = 0; c < kDims; ++c)
              acc[r][c] = fmaf(component(y[r], q), wv[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRpw; ++r)
#pragma unroll
        for (int c = 0; c < kDims; ++c) {
          const int i = i0 + lane + 32 * c;
          if (live[r] && i < d)
            v_s[r * dq + i] =
                u[r][c] < sigmoid_f32(acc[r][c] + b[r][c]) ? 1.f : 0.f;
        }
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < kRpw; ++r)
    if (live[r])
      for (int i = lane; i < d; i += 32)
        out[static_cast<size_t>(row0 + r) * d + i] = v_s[r * dq + i];
}

// Sum of x over the L lanes of its group by a fixed xor butterfly: every
// lane of the group gets the same bits. Every lane of the warp must call it.
template <int L>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Latency plan: CTA b carries row b. Its kSplitThreads compute threads form
// lane groups g = tid / L (L = kSplitLanes), and group g owns outputs
// g + G s of a pass (G = kSplitThreads / L groups, s < kSlotsH or kSlotsV
// slots); its lanes split each output's dot product, carry the slots' sums
// side by side and close them with one xor-shuffle sum each; lane s of the
// group then finishes slot s. Two more warps only draw: the next sweep's
// uniforms, the h columns' during the hidden pass and the v dims' during
// the visible one, so no Threefry chain delays a pass.
constexpr int kSlotsH = 5;  // hidden pass: G * 5 = 160 >= H columns a chunk
constexpr int kSlotsV = 3;  // visible pass: G * 3 = 96 >= D dims a chunk

__global__ void __launch_bounds__(kSplitThreads + 32 * kDrawWarps)
    gibbs_split_kernel(const float* __restrict__ v0,
                       const float* __restrict__ w,
                       const float* __restrict__ bv,
                       const float* __restrict__ bh,
                       const int32_t* __restrict__ seed,
                       float* __restrict__ out, int n, int d, int h, int k,
                       RowMap rm) {
  constexpr int L = kSplitLanes;
  static_assert(kSlotsH <= L && kSlotsV <= L, "lane s finishes slot s");
  constexpr int kGroups = kSplitThreads / L;
  extern __shared__ __align__(16) float smem[];
  const int dq = round4(d), h32 = round32(h), p = split_pitch(h), dh = d + h;
  const int tid = threadIdx.x, sub = tid % L, grp = tid / L;
  const bool drawer = tid >= kSplitThreads;
  const int row = blockIdx.x;
  float* w_s = smem;           // (dq, p)
  float* v_s = w_s + dq * p;   // (dq)
  float* h_s = v_s + dq;       // (h32), zero past h
  float* b_s = h_s + h32;      // (h + d): the row's bh, then its bv
  float* u_s = b_s + dh;       // (2, h + d): uniforms by sweep parity
  stage_w(w, w_s, d, h, p);
  for (int i = tid; i < dq; i += blockDim.x)
    v_s[i] = i < d ? v0[static_cast<size_t>(row) * d + i] : 0.f;
  for (int j = tid; j < h32; j += blockDim.x) h_s[j] = 0.f;
  for (int c = tid; c < dh; c += blockDim.x)
    b_s[c] = c < h ? bh[static_cast<size_t>(row) * h + c]
                   : bv[static_cast<size_t>(row) * d + (c - h)];
  const uint32_t s1 = static_cast<uint32_t>(seed[1]);
  const RowStream rs = row_stream(static_cast<uint32_t>(seed[0]), row, rm);
  // the drawer warps: sweep it's uniforms for the h columns (v_pass false)
  // or the v dims, at u[c] and u[h + i]
  auto draw = [&](int it, bool v_pass) {
    float* u = u_s + (it & 1) * dh;
    const uint32_t salt = s1 + 2u * static_cast<uint32_t>(it);
    const int n_c = v_pass ? d : h;
#pragma unroll 2
    for (int c = tid - kSplitThreads; c < n_c; c += 32 * kDrawWarps) {
      if (v_pass)
        u[h + c] = random_uniform_at(rs.seed, salt + 1u, rs.lrow * d + c);
      else
        u[c] = random_uniform_at(rs.seed, salt, rs.lrow * h + c);
    }
  };
  if (drawer && k > 0) {
    draw(0, false);
    draw(0, true);
  }
  __syncthreads();

  for (int it = 0; it < k; ++it) {
    const float* u = u_s + (it & 1) * dh;
    // the next sweep's uniforms, half in each pass; read two barriers on
    if (drawer) {
      if (it + 1 < k) draw(it + 1, false);
    } else {
      for (int j0 = 0; j0 < h; j0 += kGroups * kSlotsH) {
        int jc[kSlotsH];
        float acc[kSlotsH];
#pragma unroll
        for (int s = 0; s < kSlotsH; ++s) {
          jc[s] = min(j0 + grp + kGroups * s, h - 1);
          acc[s] = 0.f;
        }
        for (int i = sub; i < d; i += L) {
          const float x = v_s[i];
#pragma unroll
          for (int s = 0; s < kSlotsH; ++s)
            acc[s] = fmaf(x, w_s[i * p + jc[s]], acc[s]);
        }
        float mine = 0.f;
#pragma unroll
        for (int s = 0; s < kSlotsH; ++s) {
          const float t = group_sum<kSplitLanes>(acc[s]);
          if (sub == s) mine = t;
        }
        const int j = j0 + grp + kGroups * sub;
        if (sub < kSlotsH && j < h)
          h_s[j] = u[j] < sigmoid_f32(mine + b_s[j]) ? 1.f : 0.f;
      }
    }
    __syncthreads();
    if (drawer) {
      if (it + 1 < k) draw(it + 1, true);
    } else {
      for (int i0 = 0; i0 < d; i0 += kGroups * kSlotsV) {
        int io[kSlotsV];
        float acc[kSlotsV];
#pragma unroll
        for (int s = 0; s < kSlotsV; ++s) {
          io[s] = min(i0 + grp + kGroups * s, d - 1) * p;
          acc[s] = 0.f;
        }
        for (int j = 4 * sub; j < h; j += 4 * L) {  // a float4 per lane
          const float4 y = *reinterpret_cast<const float4*>(h_s + j);
#pragma unroll
          for (int s = 0; s < kSlotsV; ++s) {
            const float4 wv =
                *reinterpret_cast<const float4*>(w_s + io[s] + j);
            acc[s] = fmaf(y.x, wv.x, acc[s]);
            acc[s] = fmaf(y.y, wv.y, acc[s]);
            acc[s] = fmaf(y.z, wv.z, acc[s]);
            acc[s] = fmaf(y.w, wv.w, acc[s]);
          }
        }
        float mine = 0.f;
#pragma unroll
        for (int s = 0; s < kSlotsV; ++s) {
          const float t = group_sum<kSplitLanes>(acc[s]);
          if (sub == s) mine = t;
        }
        const int i = i0 + grp + kGroups * sub;
        if (sub < kSlotsV && i < d)
          v_s[i] = u[h + i] < sigmoid_f32(mine + b_s[h + i]) ? 1.f : 0.f;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < d; i += blockDim.x)
    out[static_cast<size_t>(row) * d + i] = v_s[i];
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
// A refusal is also cleared from CUDA's last-error state: the caller
// raises, and the next launch in the process must not report it again.
template <typename Kernel>
const char* allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kSmemLimitBytes))
    return "gibbs_chain: the plan's W and rows do not fit in shared memory";
  if (bytes <= 48 * 1024) return nullptr;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) return nullptr;
  cudaGetLastError();
  return cudaGetErrorString(e);
}

const char* last_error() {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? nullptr : cudaGetErrorString(err);
}

}  // namespace

const char* launch_gibbs_chain(const float* v0, const float* w,
                               const float* bv, const float* bh,
                               const int32_t* seed, float* out, int64_t n,
                               int64_t d, int64_t h, int64_t k, int64_t bb,
                               int64_t row0, int64_t rows_loc,
                               int64_t rows_glob, int64_t rows_per_cta,
                               int64_t threads, int64_t lanes, int64_t w_smem,
                               void* stream) {
  if (n <= 0) return nullptr;
  if (rows_loc <= 0 || n % rows_loc != 0 || row0 < 0 ||
      row0 + rows_loc > rows_glob || (n / rows_loc) * rows_glob > INT32_MAX)
    return "gibbs_chain: the row map (row0, loc, glob) does not fit n rows";
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), di = static_cast<int>(d),
            hi = static_cast<int>(h), ki = static_cast<int>(k),
            rpc = static_cast<int>(rows_per_cta);
  const RowMap rm{static_cast<int>(bb), static_cast<int>(row0),
                  static_cast<int>(rows_loc), static_cast<int>(rows_glob)};
  const int blocks = static_cast<int>((n + rows_per_cta - 1) / rows_per_cta);
  const size_t w_floats =
      w_smem ? static_cast<size_t>(round4(di)) * w_pitch(hi) : 0;
  if (lanes == 1) {
    if (threads != kWarps * 32 || rpc % kWarps != 0)
      return "gibbs_chain: the throughput plan takes 256 threads and a "
             "multiple of 8 rows per CTA";
    const size_t smem =
        sizeof(float) *
        (w_floats + static_cast<size_t>(rpc) * (round4(di) + round4(hi)));
    auto go = [&](auto kernel) -> const char* {
      if (const char* e = allow_smem(kernel, smem)) return e;
      kernel<<<blocks, kWarps * 32, smem, s>>>(v0, w, bv, bh, seed, out, ni,
                                               di, hi, ki, rm);
      return last_error();
    };
    const int rpw = rpc / kWarps;
    if (rpw != 1 && rpw != 2)
      return "gibbs_chain: rows per warp must be 1 or 2";
    if (w_smem)
      return rpw == 1 ? go(gibbs_rows_kernel<1, true>)
                      : go(gibbs_rows_kernel<2, true>);
    return rpw == 1 ? go(gibbs_rows_kernel<1, false>)
                    : go(gibbs_rows_kernel<2, false>);
  }
  if (!w_smem)
    return "gibbs_chain: the latency plan keeps W in shared memory";
  if (threads != kSplitThreads || rpc != 1 || lanes != kSplitLanes)
    return "gibbs_chain: the latency plan takes 256 threads, one row per "
           "CTA and 8 lanes per dot";
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(round4(di)) * split_pitch(hi) +
                       round4(di) + round32(hi) +
                       3 * static_cast<size_t>(di + hi));
  if (const char* e = allow_smem(gibbs_split_kernel, smem)) return e;
  gibbs_split_kernel<<<blocks, kSplitThreads + 32 * kDrawWarps, smem, s>>>(
      v0, w, bv, bh, seed, out, ni, di, hi, ki, rm);
  return last_error();
}

}  // namespace multinn_torch
