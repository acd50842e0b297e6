// NADE ancestral sampling sweep of one frame over D dims, for n rows with
// per-row biases:
//   a = bh;  for i < D:  p = sigmoid(bv_i + V_i . sigmoid(a)),
//                        x_i = (u_i < p),  a += x_i * W_i.
//
// Replaces multinn_tpu/ops/nade_pallas.py::_kernel (wrapper _sample_2d), the
// per-step sampler of the RNN-NADE scan path. The Pallas kernel keeps W, V
// and the (H, B) running activation in VMEM and advances all rows together.
//
// Random stream: the Pallas kernel draws one (D, n) uniform matrix up front
// under key (seed[0] ^ block * 0x85EB, seed[1]) with block 0 (its grid is
// (1,), and under jax.vmap the batching rule prepends the vmapped axis to
// the grid, so program_id(0) stays 0): the draw of (dim i, row b) has
// counter i * n + b. This kernel draws the same counters into shared memory
// before the sweep, keeping Threefry off the serial chain. Under the row
// map a launch of n rows holds rows row0 .. row0 + n - 1 of a batch of
// rows_total (one data shard), and row b draws counter
// i * rows_total + row0 + b, the bits the whole batch's launch draws for it.
//
// Bound: the serial chain of the sweep, not bytes or operations (a few
// hundred thousand multiply-adds a row). The design shortens that chain:
//   * one CTA of four warps per row, and no block barrier per dim: a
//     window pays one barrier (the warps' hits), two where a dim is drawn
//     1 (then the refreshed h);
//   * lookahead over runs of zeros: a changes only where x_j = 1, so the
//     logits of the next kWin dims are computed at once from the current h,
//     each dim's dot split over 128 / kWin lanes of a warp (a fixed
//     xor-shuffle sum closes it). A ballot per warp finds the first j with
//     u_j < p_j; the dims before it are 0, a and h move by W_j, and the
//     next window starts at j + 1. Every logit sees the h the serial sweep
//     would give it, so the result is the serial sweep's, and the passes
//     fall from D to about (ones + D / kWin);
//   * W and V in shared memory where they fit beside the row's state: one
//     thread issues TMA bulk copies of them in dim order, four dims a
//     group, each group completing on its own mbarrier, so a window waits
//     only for the groups that hold its dims. Above that, or where W or V
//     is not 16-byte aligned (ops/nade_cuda.sample_plan decides), W_j and
//     V_j are read from L2.
// The compare keeps the IEEE sigmoid (sigmoid_f32), so a draw differs from
// the plain version only where u lands within the last ulp of p; h is
// refreshed with sigmoid_nr (within an ulp of torch.sigmoid).
#include <cuda_runtime.h>

#include <cstdint>

#include "launchers.h"
#include "sigmoid.cuh"
#include "threefry.cuh"

namespace multinn_torch {
namespace {

constexpr int kRowThreads = 128;  // threads that carry one row (4 warps)
constexpr int kWin = 16;          // dims of a lookahead window (PERF.md)
constexpr int kGroupDims = 4;     // dims a bulk copy of W and V carries
constexpr int kDotBlock = 8;      // terms of a dot a lane loads at once

__host__ __device__ constexpr int round32(int x) { return (x + 31) & ~31; }
__host__ __device__ constexpr int64_t round4(int64_t x) {
  return (x + 3) & ~int64_t{3};
}

// Floats of the staged copy's mbarriers (8 bytes each, one per group of
// kGroupDims dims), kept at a 16-byte multiple.
__host__ __device__ constexpr int64_t barrier_floats(int64_t d) {
  return round4(2 * ((d + kGroupDims - 1) / kGroupDims));
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Until the mbarrier's phase 0 has completed (its bytes have landed).
__device__ __forceinline__ void wait_landed(const uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// The dot of V row vj with h over this lane's terms c = sub, sub + L, ...:
// blocks of kDotBlock terms, their loads predicated and issued together,
// so a block costs one load latency, not one per term.
template <int L>
__device__ __forceinline__ float lane_dot(const float* vj, const float* h_s,
                                          int sub, int h) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = sub; c < h; c += kDotBlock * L) {
    float vv[kDotBlock], hh[kDotBlock];
#pragma unroll
    for (int k = 0; k < kDotBlock; ++k) {
      const int ck = c + k * L;
      vv[k] = ck < h ? vj[ck] : 0.f;
      hh[k] = ck < h ? h_s[ck] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kDotBlock; ++k)
      acc[k & 3] = fmaf(vv[k], hh[k], acc[k & 3]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// One thread: W and V (d, h), contiguous and 16-byte aligned, into w_s and
// v_s at the same layout by TMA bulk copies, group g (dims 4g .. 4g + 3) on
// mbarrier bars[g], in dim order. A group's floats are a multiple of 4
// (4h) but the last one's; the last group's tail of fewer than 4 floats is
// left to plain copies.
__device__ void stage_rows(const float* w, const float* v, float* w_s,
                           float* v_s, uint64_t* bars, int d, int h) {
  const int groups = (d + kGroupDims - 1) / kGroupDims;
  for (int gi = 0; gi < groups; ++gi)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_u32(bars + gi))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  for (int gi = 0; gi < groups; ++gi) {
    const int64_t f0 = static_cast<int64_t>(gi) * kGroupDims * h;
    const int64_t f1 =
        static_cast<int64_t>(min(d, (gi + 1) * kGroupDims)) * h;
    const uint32_t bytes = static_cast<uint32_t>(((f1 - f0) * 4) & ~15);
    const uint32_t bar = smem_u32(bars + gi);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(bar),
                 "r"(2 * bytes)
                 : "memory");
    if (bytes == 0) continue;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(w_s + f0)),
        "l"(w + f0), "r"(bytes), "r"(bar)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(v_s + f0)),
        "l"(v + f0), "r"(bytes), "r"(bar)
        : "memory");
  }
}

// One CTA of kRowThreads threads per row. A window of kWin dims gives each
// dim L = kRowThreads / kWin lanes of one warp. kStaged: W and V are copied
// into shared memory (stage_rows) and a window waits only for the groups
// that hold its dims; else they are read from L2.
template <bool kStaged>
__global__ void __launch_bounds__(kRowThreads)
    nade_sample_kernel(const float* __restrict__ w,   // (d, h)
                       const float* __restrict__ v,   // (d, h)
                       const float* __restrict__ bv,  // (n, d)
                       const float* __restrict__ bh,  // (n, h)
                       const int32_t* __restrict__ seed,
                       float* __restrict__ out,       // (n, d)
                       int n, int d, int h, int row0, int rows_total) {
  constexpr int L = kRowThreads / kWin;   // lanes per dim
  constexpr int kDimsPerWarp = 32 / L;
  constexpr int kWarps = kRowThreads / 32;
  static_assert(L >= 2 && L <= 32, "a dim's lanes lie in one warp");
  extern __shared__ __align__(16) float smem[];
  const int hp = round32(h);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* w_s = smem + (kStaged ? barrier_floats(d) : 0);  // (d, h), staged
  float* v_s = w_s + (kStaged ? round4(static_cast<int64_t>(d) * h) : 0);
  float* a_s = v_s + (kStaged ? round4(static_cast<int64_t>(d) * h) : 0);
  float* h_s = a_s + hp;   // (hp) sigmoid(a); a_s (hp) the activation
  float* u_s = h_s + hp;   // (d) this row's uniforms
  float* bv_s = u_s + d;   // (d) its visible biases
  // per window parity: each warp's dims drawn 1, as bits
  uint32_t* hit_s = reinterpret_cast<uint32_t*>(bv_s + d);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  if (kStaged) {
    if (tid == 0) stage_rows(w, v, w_s, v_s, bars, d, h);
    const int64_t total = static_cast<int64_t>(d) * h;
    for (int64_t f = (total & ~int64_t{3}) + tid; f < total;
         f += kRowThreads) {
      w_s[f] = w[f];
      v_s[f] = v[f];
    }
  }
  const uint32_t s0 = static_cast<uint32_t>(seed[0]);
  const uint32_t s1 = static_cast<uint32_t>(seed[1]);
  for (int j = tid; j < h; j += kRowThreads) {
    const float x = bh[static_cast<size_t>(b) * h + j];
    a_s[j] = x;
    h_s[j] = sigmoid_nr(x);
  }
  for (int i = tid; i < d; i += kRowThreads) {
    u_s[i] = random_uniform_at(
        s0, s1,
        static_cast<uint32_t>(i) * static_cast<uint32_t>(rows_total) +
            static_cast<uint32_t>(row0 + b));
    bv_s[i] = bv[static_cast<size_t>(b) * d + i];
  }
  __syncthreads();  // the mbarriers are initialised; a, h, u, bv written

  const int grp = tid / L, sub = tid % L;
  int landed = 0;  // groups of W and V known to be staged
  for (int i0 = 0, it = 0; i0 < d; ++it) {
    const int j = i0 + grp;  // the dim this lane group computes
    const bool live = j < d;
    if (kStaged) {
      const int need = (min(d, i0 + kWin) + kGroupDims - 1) / kGroupDims;
      for (; landed < need; ++landed) wait_landed(bars + landed);
    }
    const float* vj =
        (kStaged ? v_s : v) + static_cast<size_t>(live ? j : d - 1) * h;
    float s = lane_dot<L>(vj, h_s, sub, h);
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const int jc = live ? j : 0;
    const bool one = live && u_s[jc] < sigmoid_f32(s + bv_s[jc]);
    const uint32_t hits = __ballot_sync(0xffffffffu, one && sub == 0);
    uint32_t* hw = hit_s + (it & 1) * kWarps;
    if (lane == 0) {
      uint32_t mine = 0;  // the warp's dims, one bit each
#pragma unroll
      for (int k = 0; k < kDimsPerWarp; ++k)
        mine |= ((hits >> (k * L)) & 1u) << k;
      hw[warp] = mine;
    }
    __syncthreads();
    uint32_t mask = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) mask |= hw[q] << (q * kDimsPerWarp);
    // the first one in the window, or the window's end
    const int first = mask ? __ffs(mask) - 1 : kWin;
    if (sub == 0 && live && grp <= first)
      out[static_cast<size_t>(b) * d + j] = one ? 1.f : 0.f;
    if (first == kWin) {
      i0 += kWin;
      continue;
    }
    const float* wj =
        (kStaged ? w_s : w) + static_cast<size_t>(i0 + first) * h;
    // two lanes a thread per step, loads first, so their latencies and
    // sigmoids overlap
    for (int j0 = tid; j0 < h; j0 += 2 * kRowThreads) {
      const int j1 = j0 + kRowThreads;
      const float x0 = a_s[j0] + wj[j0];
      const float x1 = j1 < h ? a_s[j1] + wj[j1] : 0.f;
      a_s[j0] = x0;
      h_s[j0] = sigmoid_nr(x0);
      if (j1 < h) {
        a_s[j1] = x1;
        h_s[j1] = sigmoid_nr(x1);
      }
    }
    __syncthreads();
    i0 += first + 1;
  }
}

// The plan's shared memory (ops/nade_cuda.sample_smem_bytes counts the
// same bytes): when staged, the copy's mbarriers and W and V; a and h
// (round32(h) each), u and bv (d each) and the hit bits.
size_t nade_sample_smem_bytes(int64_t d, int64_t h, bool staged) {
  return sizeof(float) *
         static_cast<size_t>(
             (staged ? barrier_floats(d) + 2 * round4(d * h) : 0) +
             2 * round32(static_cast<int>(h)) + 2 * d +
             2 * (kRowThreads / 32));
}

}  // namespace

const char* launch_nade_sample(const float* w, const float* v,
                               const float* bv, const float* bh,
                               const int32_t* seed, float* out, int64_t n,
                               int64_t d, int64_t h, int64_t staged,
                               int64_t row0, int64_t rows_total,
                               void* stream) {
  if (n <= 0 || d <= 0) return nullptr;
  if (row0 < 0 || row0 + n > rows_total || rows_total > INT32_MAX)
    return "nade_sample: the row map (row0, rows_total) does not fit n rows";
  // the bulk copies need 16-byte aligned bases of W and V
  if (staged &&
      (reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(v)) % 16)
    return "nade_sample: a staged plan needs W and V 16-byte aligned";
  const size_t smem = nade_sample_smem_bytes(d, h, staged != 0);
  if (smem > static_cast<size_t>(kSmemLimitBytes))
    return "nade_sample: the plan needs more than a CTA's 227 KB of shared "
           "memory";
  const auto kernel =
      staged ? nade_sample_kernel<true> : nade_sample_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // cleared: the caller raises this error itself
      return cudaGetErrorString(e);
    }
  }
  kernel<<<static_cast<int>(n), kRowThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      w, v, bv, bh, seed, out, static_cast<int>(n), static_cast<int>(d),
      static_cast<int>(h), static_cast<int>(row0),
      static_cast<int>(rows_total));
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? nullptr : cudaGetErrorString(err);
}

}  // namespace multinn_torch
