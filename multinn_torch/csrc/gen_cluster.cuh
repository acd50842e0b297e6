// What the two whole-generation kernels (gen_fused_rbm.cu,
// gen_fused_nade.cu) have in common: the thread-block-cluster layout, the
// shared-memory plan, the lists of a frame's nonzero entries, the frame
// exchange through distributed shared memory, and the LSTM / vanilla cell
// stack.
//
// Layout. A cluster of C = min(K, 8) CTAs runs S samples; CTA r owns tracks
// r, r + C, ... (tpc = ceil(K / C) track slots). Each CTA keeps its tracks'
// per-step decoder weights (the RBM's W, Wuh, Wuv; the NADE's V, W, Wuh,
// Wuv) in shared memory when they fit, else the same code reads them from
// global memory through a pointer chosen at launch. The weights of the cell
// stack (Wx, Wh, Wctx: about 1 MB per track) stay in global memory and
// L2. A matrix stored in bf16 (the capacity modes) takes half the bytes in
// either place and is widened to f32 exactly where it is read. Per sample
// the CTA holds its tracks' h and c rows, a scratch row (biases and chain
// state, then the gates), the frames of ALL tracks at t - 1, its own
// tracks' frames at t (two buffers, by step parity), and the rows' lists
// of nonzero entries.
//
// Every sample of a CTA reads the same Wh, Wx_r (and in the RBM kernel
// Wuv, Wuh) in a step, so these dense products block samples per thread:
// a thread owns one gate of a track slot for a slice of the CTA's samples
// (block_slices: as many slices as keep the threads busy, at most
// kMaxBlock samples a slice), reads each element of the gate's Wh column
// once and multiplies it into one set of accumulators per sample, the h
// rows coming as 16-byte broadcast loads from shared memory. The
// per-sample gathers (Wx over the fresh row's list, Wctx over the previous
// frames' lists) share no reads, and run a thread per (sample, gate) in
// list order, 16 loads in flight, adding the sliced h Wh from the gate's
// slot. Where every slice holds one sample (a lone song, or few samples of
// narrow cells) the whole stack runs a thread per (sample, gate). Each sum
// keeps the order it has with one sample a thread, so the two agree bit
// for bit.
//
// The tracks of a sample couple only through the previous frame of all
// tracks (the feedback context). So a step is local to each CTA until its
// fresh frames are known; then each CTA writes its tracks' rows into its
// own buffer of the step's parity, and one cluster barrier follows. The
// cell stack reads the previous frames and the own fresh rows; after it,
// each CTA copies every track's fresh row into its previous frames (the
// other CTAs' through distributed shared memory) and lists them. A CTA
// rewrites a parity buffer two steps later, after a cluster barrier that
// every reader of it has passed, so one cluster barrier per step guards
// the exchange.
//
// No float atomics anywhere: every sum has a fixed order, so a replay is
// bit-equal.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "launchers.h"
#include "reduce.cuh"
#include "sigmoid.cuh"
#include "threefry.cuh"

namespace multinn_torch {
namespace gen_cluster {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kMaxMatrices = 4;     // per-step weight matrices per track
constexpr int kMaxBlock = 6;        // samples a thread blocks at most

__host__ __device__ constexpr int chunks_of(int n) { return (n + 31) / 32; }

// Slices of a CTA's ns samples for a phase of `outputs` (track slot,
// output) pairs a sample: a thread owns an output for one slice, so one
// read of the output's weight column serves the slice. As many slices as
// keep the CTA's threads busy, at least enough to hold a slice within
// kMaxBlock samples, at most ns (then one sample a thread).
// ops/gen_common.py::block_slices mirrors it for the host's counters. The
// sliced code's accumulators raise a kernel's register pressure even where
// it does not run, so each kernel is built with it (kSliced) and without,
// and a launch whose full clusters slice nothing takes the latter.
__host__ __device__ constexpr int block_slices(int ns, int outputs) {
  const int fill = kThreads / (outputs > 0 ? outputs : 1);
  const int least = (ns + kMaxBlock - 1) / kMaxBlock;
  const int n = fill > least ? fill : least;
  return n < ns ? n : ns;
}

__host__ __device__ constexpr int64_t align16(int64_t x) {
  return (x + 15) & ~int64_t{15};
}
// Bytes of the list of a frame row's nonzero entries: the count, then up
// to D increasing uint16 indices (padded to 4 bytes).
__host__ __device__ constexpr int64_t row_list_bytes(int d) {
  return 4 + 2 * int64_t{d + (d & 1)};
}

// Shared-memory plan of one launch; ops/gen_common.py::sample_bytes makes
// the same per-sample count for the dispatch gate, and the card-only tests
// read the whole plan through the gen_fused_plan op. Per CTA:
// [weights][sample 0]...[sample S-1]; per sample: the
// previous frames (K*D) and the own fresh rows (2, tpc, D) f32, tpc group
// slots of (h (L*U), c (L*U), scratch) f32, the lists of the previous
// rows (K) and of the own fresh rows (tpc).
struct Plan {
  int c;                         // CTAs per cluster
  int tpc;                       // track slots per CTA
  int s;                         // samples per cluster (set at launch)
  int s_max;                     // most samples the shared memory holds
  int scr;                       // scratch floats per group
  int w_smem;                    // bit m: matrix m lives in shared memory
  int64_t w_off[kMaxMatrices];   // byte offset of matrix m's slot 0
  int64_t w_bytes[kMaxMatrices]; // bytes of one track's matrix m (16-aligned)
  int64_t weight_bytes;          // the weight region
  int64_t sample_bytes;          // one sample's region
};

// Matrices in priority order (the most read first): each goes to shared
// memory if it fits beside what is already there and one sample's state.
inline Plan make_plan(int k, int d, int u, int n_layers, int scr,
                      const int64_t* mat_bytes, int n_mat, int64_t limit) {
  Plan p{};
  p.c = std::min(k, kMaxCluster);
  p.tpc = (k + p.c - 1) / p.c;
  p.scr = scr;
  p.sample_bytes = align16(
      4 * (int64_t{k} * d +
           p.tpc * (2 * int64_t{d} + 2 * int64_t{n_layers} * u + scr)) +
      (k + p.tpc) * row_list_bytes(d));
  int64_t used = 0;
  for (int m = 0; m < n_mat; ++m) {
    p.w_bytes[m] = align16(mat_bytes[m]);
    const int64_t bytes = p.tpc * p.w_bytes[m];
    if (used + bytes + p.sample_bytes <= limit) {
      p.w_smem |= 1 << m;
      p.w_off[m] = used;
      used += bytes;
    }
  }
  p.weight_bytes = used;
  p.s_max = used + p.sample_bytes <= limit
                ? static_cast<int>((limit - used) / p.sample_bytes)
                : 0;
  return p;
}

inline int64_t smem_bytes(const Plan& p, int s) {
  return p.weight_bytes + s * p.sample_bytes;
}

// The error string of a failed call, cleared from CUDA's last-error state
// so the next launch does not report it again.
inline const char* failed(cudaError_t e) {
  cudaGetLastError();
  return cudaGetErrorString(e);
}

// Launch `kernel(args, plan)` as clusters of plan.c CTAs: S samples per
// cluster, S = ceil(B / the clusters the card holds at once), within what
// the shared memory holds. With `shape`, make no launch and describe it
// instead (kLaunchShapeFields values, launchers.h).
template <typename Args>
const char* launch(void (*kernel)(Args, Plan), const Args& a, Plan p,
                   int batch, void* stream, int64_t* shape) {
  if (p.s_max < 1)
    return "one sample's state does not fit a CTA's shared memory";
  const int64_t smem_max = smem_bytes(p, p.s_max);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_max));
  if (e != cudaSuccess) return failed(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_max);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return failed(e);
  if (clusters < 1) return "no cluster of this size fits on the card";
  p.s = std::max(1, std::min(p.s_max, (batch + clusters - 1) / clusters));
  const int grid = (batch + p.s - 1) / p.s;
  if (shape != nullptr) {
    const int64_t v[kLaunchShapeFields] = {
        p.c, p.tpc, p.w_smem, p.weight_bytes, p.sample_bytes, p.s_max,
        p.s, grid, clusters};
    std::copy(v, v + kLaunchShapeFields, shape);
    return nullptr;
  }
  cfg.gridDim = dim3(grid * p.c);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes(p, p.s));
  e = cudaLaunchKernelEx(&cfg, kernel, a, p);
  if (e != cudaSuccess) return failed(e);
  e = cudaGetLastError();
  return e == cudaSuccess ? nullptr : cudaGetErrorString(e);
}

// A weight as f32: float as is, bf16 (its 16-bit word) widened exactly.
__device__ __forceinline__ float wload(const float* p) { return *p; }
__device__ __forceinline__ float wload(const uint16_t* p) {
  return bf16_to_f32(*p);
}

// acc + sum over a frame row's listed entries i (n of them, increasing),
// of x[i] * w[i * ld]: 16 independent loads in flight per round, for the
// cell stack's weights in L2.
template <typename T>
__device__ __forceinline__ float gather_row(const uint16_t* idx, int n,
                                            const float* x, const T* w,
                                            int64_t ld, float acc) {
#pragma unroll 16
  for (int q = 0; q < n; ++q) {
    const int i = idx[q];
    acc = fmaf(x[i], wload(w + i * ld), acc);
  }
  return acc;
}

// sum_{i < n} x[i] * w[i * ld] (x dense in shared memory) in four
// accumulators by i mod 4, added as (a0 + a1) + (a2 + a3) and then the
// tail: 16 independent loads in flight per round and a dependent chain of
// n / 4 multiply-adds. kRoundX: each x[i] rounded to bf16 first (the RBM
// kernel's conditioning products in its bf16 capacity mode).
template <bool kRoundX = false, typename T>
__device__ __forceinline__ float dot(const float* x, const T* w, int64_t ld,
                                     int n) {
  auto xv = [&](int i) { return kRoundX ? round_bf16(x[i]) : x[i]; };
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int i = 0;
#pragma unroll 4
  for (; i + 4 <= n; i += 4) {
    a0 = fmaf(xv(i), wload(w + i * ld), a0);
    a1 = fmaf(xv(i + 1), wload(w + (i + 1) * ld), a1);
    a2 = fmaf(xv(i + 2), wload(w + (i + 2) * ld), a2);
    a3 = fmaf(xv(i + 3), wload(w + (i + 3) * ld), a3);
  }
  float acc = (a0 + a1) + (a2 + a3);
  for (; i < n; ++i) acc = fmaf(xv(i), wload(w + i * ld), acc);
  return acc;
}

// dot over the rows x + q * xs of a slice's nb <= kB samples: out[q] =
// dot<kRoundX>(x + q * xs, w, ld, n) bit for bit (each sample's terms in
// its own four accumulators by i mod 4, then the tail), each w[i * ld]
// read once for all of them, 16 at a time in flight. kVec: x is 16-byte
// aligned (xs, a sample's floats, always is), so a sample's four x come
// in one broadcast load.
template <int kB, bool kRoundX, bool kVec, typename T>
__device__ __forceinline__ void dot_slice_rows(const float* x, int xs, int nb,
                                               const T* w, int64_t ld, int n,
                                               float (&out)[kB]) {
  float a[kB][4];
#pragma unroll
  for (int q = 0; q < kB; ++q) a[q][0] = a[q][1] = a[q][2] = a[q][3] = 0.f;
  auto four = [&](int i, float w0, float w1, float w2, float w3) {
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      if (q < nb) {
        const float* xq = x + q * xs + i;
        float4 v = kVec ? *reinterpret_cast<const float4*>(xq)
                        : make_float4(xq[0], xq[1], xq[2], xq[3]);
        if (kRoundX) {
          v.x = round_bf16(v.x);
          v.y = round_bf16(v.y);
          v.z = round_bf16(v.z);
          v.w = round_bf16(v.w);
        }
        a[q][0] = fmaf(v.x, w0, a[q][0]);
        a[q][1] = fmaf(v.y, w1, a[q][1]);
        a[q][2] = fmaf(v.z, w2, a[q][2]);
        a[q][3] = fmaf(v.w, w3, a[q][3]);
      }
    }
  };
  constexpr int kRows = 16;
  int i = 0;
  for (; i + kRows <= n; i += kRows) {
    float wv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) wv[r] = wload(w + (i + r) * ld);
#pragma unroll
    for (int r = 0; r < kRows; r += 4)
      four(i + r, wv[r], wv[r + 1], wv[r + 2], wv[r + 3]);
  }
  for (; i + 4 <= n; i += 4)
    four(i, wload(w + i * ld), wload(w + (i + 1) * ld),
         wload(w + (i + 2) * ld), wload(w + (i + 3) * ld));
#pragma unroll
  for (int q = 0; q < kB; ++q)
    out[q] = (a[q][0] + a[q][1]) + (a[q][2] + a[q][3]);
  for (; i < n; ++i) {
    const float wi = wload(w + i * ld);
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      if (q < nb) {
        const float xi = x[q * xs + i];
        out[q] = fmaf(kRoundX ? round_bf16(xi) : xi, wi, out[q]);
      }
    }
  }
}

template <int kB, bool kRoundX = false, typename T>
__device__ __forceinline__ void dot_slice(const float* x, int xs, int nb,
                                          const T* w, int64_t ld, int n,
                                          float (&out)[kB]) {
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0)
    dot_slice_rows<kB, kRoundX, true>(x, xs, nb, w, ld, n, out);
  else
    dot_slice_rows<kB, kRoundX, false>(x, xs, nb, w, ld, n, out);
}

// The CTA's view of its shared memory and of its samples and tracks.
struct Cta {
  unsigned char* smem;
  Plan p;
  int k, d, u, n_layers;
  int rank;          // block rank in the cluster
  int b0;            // first sample of the cluster
  int ns;            // samples of the cluster (<= p.s)
  int ntr;           // tracks this CTA owns (<= p.tpc)

  __device__ int track(int j) const { return rank + j * p.c; }
  __device__ int owner(int k_) const { return k_ % p.c; }
  __device__ int n_groups() const { return ns * ntr; }

  // matrix m of track slot j: shared memory, or `global` + track offset
  template <typename T>
  __device__ const T* matrix(int m, int j, const T* global,
                             int64_t elems) const {
    if ((p.w_smem >> m) & 1)
      return reinterpret_cast<const T*>(smem + p.w_off[m] + j * p.w_bytes[m]);
    return global + track(j) * elems;
  }
  __device__ unsigned char* sample(int s) const {
    return smem + p.weight_bytes + s * p.sample_bytes;
  }
  // the previous frames of all tracks (K*D)
  __device__ float* prev(int s) const {
    return reinterpret_cast<float*>(sample(s));
  }
  // track slot j's fresh row (D) in the buffer of parity `buf`
  __device__ float* fresh(int s, int j, int buf) const {
    return prev(s) + k * d + (buf * p.tpc + j) * d;
  }
  __device__ float* group(int s, int j) const {        // h, c, scratch
    return prev(s) + k * d + 2 * p.tpc * d + j * (2 * n_layers * u + p.scr);
  }
  __device__ float* h(int s, int j) const { return group(s, j); }
  __device__ float* c(int s, int j) const {
    return group(s, j) + n_layers * u;
  }
  __device__ float* scratch(int s, int j) const {
    return group(s, j) + 2 * n_layers * u;
  }
  __device__ unsigned char* lists(int s) const {
    return sample(s) +
           4 * (int64_t{k} * d +
                p.tpc * (2 * int64_t{d} + 2 * int64_t{n_layers} * u + p.scr));
  }
  // a row's list: its count, then its indices. Rows 0..K-1: the previous
  // frames; K + j: track slot j's fresh row.
  __device__ int* list_count(int s, int row) const {
    return reinterpret_cast<int*>(lists(s) + row * row_list_bytes(d));
  }
  __device__ uint16_t* list_idx(int s, int row) const {
    return reinterpret_cast<uint16_t*>(list_count(s, row) + 1);
  }
};

// Called by a whole warp: fetch the D values of a frame row with get(i),
// store them in x, and list the nonzero ones in increasing order.
template <typename Get>
__device__ __forceinline__ void build_row(float* x, int d, int* count,
                                          uint16_t* idx, Get get) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int c = 0; c < d; c += 32) {
    const int i = c + lane;
    float v = 0.f;
    if (i < d) {
      v = get(i);
      x[i] = v;
    }
    const bool on = v != 0.f;
    const uint32_t m = __ballot_sync(0xffffffffu, on);
    if (on) idx[base + __popc(m & ((1u << lane) - 1u))] =
        static_cast<uint16_t>(i);
    base += __popc(m);
  }
  if (lane == 0) *count = base;
}

__device__ __forceinline__ Cta make_cta(unsigned char* smem, const Plan& p,
                                        int k, int d, int u, int n_layers,
                                        int batch) {
  Cta c;
  c.smem = smem;
  c.p = p;
  c.k = k;
  c.d = d;
  c.u = u;
  c.n_layers = n_layers;
  c.rank = static_cast<int>(cg::this_cluster().block_rank());
  c.b0 = static_cast<int>(blockIdx.x / p.c) * p.s;
  c.ns = min(p.s, batch - c.b0);
  c.ntr = (k - c.rank + p.c - 1) / p.c;
  return c;
}

// Load the launch's initial state: h0 / c0 rows of the CTA's tracks, the
// previous frames of all tracks and their lists. Ends with a CTA barrier.
__device__ inline void load_state(const Cta& ct, const float* h0,
                                  const float* c0, const float* v0) {
  const int tid = threadIdx.x;
  const int K = ct.k, D = ct.d, U = ct.u, L = ct.n_layers;
  const int KD = K * D, LU = L * U;
  for (int o = tid; o < ct.n_groups() * LU; o += kThreads) {
    const int grp = o / LU, e = o - grp * LU;
    const int s = grp / ct.ntr, j = grp - s * ct.ntr;
    const int l = e / U, uu = e - l * U;
    const size_t src = static_cast<size_t>(ct.b0 + s) * L * K * U +
                       (static_cast<size_t>(l) * K + ct.track(j)) * U + uu;
    ct.h(s, j)[e] = h0[src];
    ct.c(s, j)[e] = c0[src];
  }
  for (int w = tid >> 5; w < ct.ns * K; w += kWarps) {
    const int s = w / K, k_ = w - s * K;
    const float* src = v0 + static_cast<size_t>(ct.b0 + s) * KD + k_ * D;
    build_row(ct.prev(s) + k_ * D, D, ct.list_count(s, k_),
              ct.list_idx(s, k_), [&](int i) { return src[i]; });
  }
  __syncthreads();
}

// The step's frame: a warp per (sample, track slot) stores the fresh row
// frame(s, j, i) in the buffer of parity `buf`, lists it, and writes it to
// the roll (B, T, K*D) at step t; then the cluster barrier after which the
// other CTAs may read it.
template <typename Frame>
__device__ inline void emit_frames(const Cta& ct, int buf, float* roll,
                                   int t, int n_steps, Frame frame) {
  const int K = ct.k, D = ct.d;
  for (int w = threadIdx.x >> 5; w < ct.n_groups(); w += kWarps) {
    const int s = w / ct.ntr, j = w - s * ct.ntr;
    float* out = roll +
                 (static_cast<size_t>(ct.b0 + s) * n_steps + t) * K * D +
                 ct.track(j) * D;
    build_row(ct.fresh(s, j, buf), D, ct.list_count(s, K + j),
              ct.list_idx(s, K + j), [&](int i) {
                const float x = frame(s, j, i);
                out[i] = x;
                return x;
              });
  }
  cg::this_cluster().sync();
}

// After the cell stack: every track's fresh row of parity `buf` becomes
// its previous frame, the other CTAs' rows read through distributed
// shared memory, and gets its list. Ends with a CTA barrier.
__device__ inline void gather_frames(const Cta& ct, int buf) {
  cg::cluster_group cluster = cg::this_cluster();
  const int K = ct.k, D = ct.d;
  for (int w = threadIdx.x >> 5; w < ct.ns * K; w += kWarps) {
    const int s = w / K, k_ = w - s * K, own = ct.owner(k_);
    float* row = ct.fresh(s, k_ / ct.p.c, buf);
    const float* src =
        own == ct.rank ? row : cluster.map_shared_rank(row, own);
    build_row(ct.prev(s) + k_ * D, D, ct.list_count(s, k_),
              ct.list_idx(s, k_), [&](int i) { return src[i]; });
  }
  __syncthreads();
}

// The cell stack's weights, compact per track (ops/gen_fused_*.py):
// wx_v (K, D, G) the layer-0 projection of the track's own frame, of type
// WxT; wxg the same rows in f32 for given tracks (nullptr: wx_v serves
// them); wx_r (L-1, K, U, G) and wh (L, K, U, G) of type WrT; wctx
// (K*D, K*G) of type WctxT, or nullptr without feedback context; b
// (L, K*G). Each type is float, or uint16_t for bf16 words widened at use.
template <typename WxT, typename WctxT, typename WrT = float>
struct CellWeights {
  const WxT* wx_v;
  const float* wxg;
  const WrT* wx_r;
  const WrT* wh;
  const WctxT* wctx;
  const float* b;
  int g;
  int given_mask;
};

// The dense products of layer l for `slices` slices of the CTA's samples
// (a thread per (slice, track slot, gate)), each summed as dot sums it:
// layer 0's h Wh into the gates' slots, for the per-sample gathers to add
// to; layer l >= 1's whole gate sum (x Wx_r + h Wh) + b.
template <typename WxT, typename WctxT, typename WrT>
__device__ __forceinline__ void gates_sliced(
    const Cta& ct, const CellWeights<WxT, WctxT, WrT>& cw, int l,
    int slices) {
  constexpr int kB = kMaxBlock;
  const int K = ct.k, U = ct.u, G = cw.g;
  const int xs = static_cast<int>(ct.p.sample_bytes / 4);
  for (int o = threadIdx.x; o < slices * ct.ntr * G; o += kThreads) {
    const int r = o / G, gg = o - r * G;
    const int sl = r / ct.ntr, j = r - sl * ct.ntr;
    const int s0 = sl * ct.ns / slices;
    const int nb = (sl + 1) * ct.ns / slices - s0;
    const int k_ = ct.track(j);
    float rec[kB], zin[kB];
    dot_slice<kB>(ct.h(s0, j) + l * U, xs, nb,
                  cw.wh + (static_cast<int64_t>(l) * K + k_) * U * G + gg, G,
                  U, rec);
    if (l > 0) {
      dot_slice<kB>(
          ct.h(s0, j) + (l - 1) * U, xs, nb,
          cw.wx_r + (static_cast<int64_t>(l - 1) * K + k_) * U * G + gg, G,
          U, zin);
      const float bias = cw.b[static_cast<int64_t>(l) * K * G + k_ * G + gg];
#pragma unroll
      for (int q = 0; q < kB; ++q) rec[q] = (zin[q] + rec[q]) + bias;
    }
#pragma unroll
    for (int q = 0; q < kB; ++q)
      if (q < nb) ct.scratch(s0 + q, j)[gg] = rec[q];
  }
}

// Advance the stacked cells of the CTA's groups: layer 0 reads the fresh
// frame (the own rows of parity `buf`, through their lists) plus, with
// wctx, the previous frame of all tracks; layer l >= 1 the fresh h of
// layer l - 1. The gate sum is ((x Wx + ctx) + h Wh) + b with ctx summed per
// source track (kNadeOrder, the NADE kernel's order), else
// ((x Wx + h Wh) + b) + ctx with ctx summed over all source rows. Uses
// each group's scratch row for the gates; ends with a CTA barrier. In a
// kernel built kSliced, where block_slices gives fewer slices than
// samples, gates_sliced first takes the dense products for slices of
// samples (layer 0's h Wh, kept in the gates' slots; layer l >= 1's whole
// sum), and layer 0's gathers then run a thread per (sample, gate), as
// every layer does otherwise.
template <bool kLstm, bool kNadeOrder, bool kSliced, typename WxT,
          typename WctxT, typename WrT>
__device__ void cell_stack(const Cta& ct,
                           const CellWeights<WxT, WctxT, WrT>& cw, int buf) {
  const int tid = threadIdx.x;
  const int K = ct.k, D = ct.d, U = ct.u, G = cw.g, L = ct.n_layers;
  const int KG = K * G;
  const int slices = kSliced ? block_slices(ct.ns, ct.ntr * G) : ct.ns;
  const bool sliced = slices < ct.ns;
  for (int l = 0; l < L; ++l) {
    if constexpr (kSliced) {
      if (sliced) {
        gates_sliced(ct, cw, l, slices);
        if (l == 0) __syncthreads();
      }
    }
    for (int o = tid; (!sliced || l == 0) && o < ct.n_groups() * G;
         o += kThreads) {
      const int grp = o / G, gg = o - grp * G;
      const int s = grp / ct.ntr, j = grp - s * ct.ntr;
      const int k_ = ct.track(j);
      float zin = 0.f, ctx = 0.f;
      if (l == 0) {
        const uint16_t* fi = ct.list_idx(s, K + j);
        const int fn = *ct.list_count(s, K + j);
        const float* fx = ct.fresh(s, j, buf);
        const int64_t off = static_cast<int64_t>(k_) * D * G + gg;
        if (cw.wxg != nullptr && ((cw.given_mask >> k_) & 1))
          zin = gather_row(fi, fn, fx, cw.wxg + off, G, 0.f);
        else
          zin = gather_row(fi, fn, fx, cw.wx_v + off, G, 0.f);
        if (cw.wctx != nullptr) {
          const float* px = ct.prev(s);
          for (int src = 0; src < K; ++src) {
            const WctxT* wk =
                cw.wctx + static_cast<int64_t>(src) * D * KG + k_ * G + gg;
            const uint16_t* pi = ct.list_idx(s, src);
            const int pn = *ct.list_count(s, src);
            if (kNadeOrder)
              ctx += gather_row(pi, pn, px + src * D, wk, KG, 0.f);
            else
              ctx = gather_row(pi, pn, px + src * D, wk, KG, ctx);
          }
        }
      } else {
        zin = dot(ct.h(s, j) + (l - 1) * U,
                  cw.wx_r + (static_cast<int64_t>(l - 1) * K + k_) * U * G + gg,
                  G, U);
      }
      const float rec =
          sliced ? ct.scratch(s, j)[gg]
                 : dot(ct.h(s, j) + l * U,
                       cw.wh + (static_cast<int64_t>(l) * K + k_) * U * G + gg,
                       G, U);
      const float bias = cw.b[static_cast<int64_t>(l) * KG + k_ * G + gg];
      float z;
      if (kNadeOrder) {
        if (l == 0 && cw.wctx != nullptr) zin = zin + ctx;
        z = (zin + rec) + bias;
      } else {
        z = (zin + rec) + bias;
        if (l == 0 && cw.wctx != nullptr) z += ctx;
      }
      ct.scratch(s, j)[gg] = z;
    }
    __syncthreads();
    for (int o = tid; o < ct.n_groups() * U; o += kThreads) {
      const int grp = o / U, uu = o - grp * U;
      const int s = grp / ct.ntr, j = grp - s * ct.ntr;
      const float* z = ct.scratch(s, j);
      float* hl = ct.h(s, j) + l * U;
      float* cl = ct.c(s, j) + l * U;
      if (kLstm) {
        const float c_new = sigmoid_nr(z[U + uu]) * cl[uu] +
                            sigmoid_nr(z[uu]) * tanhf(z[2 * U + uu]);
        cl[uu] = c_new;
        hl[uu] = sigmoid_nr(z[3 * U + uu]) * tanhf(c_new);
      } else {
        hl[uu] = tanhf(z[uu]);
      }
    }
    __syncthreads();
  }
}

// Write the CTA's final h / c rows (B, L*K*U), after a cluster barrier
// that keeps every CTA's shared memory alive until its peers stop reading.
__device__ inline void store_state(const Cta& ct, float* h_out, float* c_out) {
  cg::this_cluster().sync();
  const int K = ct.k, U = ct.u, L = ct.n_layers, LU = L * U;
  for (int o = threadIdx.x; o < ct.n_groups() * LU; o += kThreads) {
    const int grp = o / LU, e = o - grp * LU;
    const int s = grp / ct.ntr, j = grp - s * ct.ntr;
    const int l = e / U, uu = e - l * U;
    const size_t dst = static_cast<size_t>(ct.b0 + s) * L * K * U +
                       (static_cast<size_t>(l) * K + ct.track(j)) * U + uu;
    h_out[dst] = ct.h(s, j)[e];
    c_out[dst] = ct.c(s, j)[e];
  }
}

}  // namespace gen_cluster
}  // namespace multinn_torch
