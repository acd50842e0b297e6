// Whole RNN-RBM generation in one launch: for every step t < T, every
// track k < K and every sample b < B —
//   1. conditioned biases from the top layer's previous h:
//        bv(t) = bv + h_top Wuv,  bh(t) = bh + h_top Wuh;
//   2. gen_k block-Gibbs sweeps started at the previous frame v_prev;
//   3. the given-track merge (accompaniment: given tracks take `given`);
//   4. the stacked LSTM / vanilla advance, whose layer-0 input is the fresh
//      frame plus, in feedback mode, the PREVIOUS frame of all tracks;
//   5. the frame written to the roll.
//
// Replaces multinn_tpu/ops/gen_fused_rbm.py::_rbm_kernel (wrapper
// _generate_rbm), whose T steps run as a sequential grid with every weight
// resident in VMEM.
//
// Bound on an H100 (the flagship K=5, D=84, H=150, U=100, G=400, gen_k=10,
// one 64-bar song, B=1, T=1024): 5.29 GFLOP of dense f32 work, 79 us at
// 67 TFLOP/s; its bytes (5.55 MB of weights, 1.7 MB of roll) take 2.2 us.
// But the work is a chain: per step 23 dependent phases (biases, 2*gen_k
// Gibbs passes, gates, cell), each of a few hundred outputs. One CTA per
// sample reading every weight from L2 through serial per-thread loads, as
// this kernel first did, took 0.51 ms per step.
//
// Design (gen_cluster.cuh): a cluster of min(K, 8) CTAs per group of S
// samples; CTA r owns tracks r, r + C, .... Each CTA holds its tracks' W
// (row stride H | 1, so the visible pass's column reads hit distinct
// banks), Wuh and Wuv in shared memory, so the biases and all 2*gen_k
// Gibbs passes read no global memory and need only the CTA's own barrier.
// The cell stack reads Wx and Wctx over the active rows of the fresh and
// the previous frame, a thread per (sample, gate), and Wh densely, a
// thread per gate (coalesced) for a slice of the CTA's samples: each Wh
// element read from L2 serves the slice (gen_cluster::cell_stack). The
// conditioned biases are sliced the same way, a thread per output of Wuv
// or Wuh for a slice. Tracks swap their frames once per step through
// distributed shared memory. The S samples of a cluster share its
// shared-memory weights, S = ceil(B / the clusters the card holds), so
// large batches run in one wave.
//
// The Gibbs passes walk lists. One operand of every Gibbs product is a
// binary sample, so a pass sums only the weight rows of the units that
// are 1: the hidden pass (unit jj) bh(t)[jj] + sum over the listed v of
// W[i][jj]; the visible pass (unit i) bv(t)[i] + sum over the listed h of
// W[i][j]. The chain's state is its samples' mask words: the pass that
// samples a row has a warp on 32 consecutive units of it (rows padded to
// whole warps), and one ballot gives the word, so keeping the state costs
// no barrier. A warp of the next pass lists the row it reads from those
// words itself, into its own contiguous list (a few instructions per 32
// units), and reads the list eight indices per 16-byte load: a listed
// product costs one shared load and an eighth, where a dense one cost two
// (the weight and x[i]). So a list never costs more than the dense dot,
// whatever the density: there is no threshold and no second path. Sweep
// 0's hidden pass walks the previous frame's list (gather_frames' own),
// multiplying by the value, since a given row need not be binary. Each
// thread takes R units of its row, so one list walk feeds R sums and R
// draws overlap; R is 3 where that gives fewer rounds of warps for the
// launch's samples per cluster (rbm_outputs_per_thread), as at the
// flagship's B=256 (200 -> 175 ms), else 1, as for a lone song, whose
// passes want the most warps (at B=8, R = 3 took 61.8 ms, R = 1 49.1).
// Every sum keeps the list's order in a fixed set of accumulators, so a
// replay is bit-equal. At the flagship the visible samples hold about
// 0.06 of their units (the served songs' density) and the hidden ones
// about half, so a sweep does about a sixteenth of the hidden pass's
// products and half the visible pass's.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md, T=1024): with dense
// passes 55.6 ms a launch at B=8 (seeded weights), 44.3 at the served
// density, 270-272 at B=256; over lists 49.5, 35.1 and 175.6. A sweep at
// B=256 went from 15.4 to 6.1 us a step; the rest of the step (biases,
// cell stack, frame exchange) was then about two thirds of it. Sliced
// biases and h Wh (slices of up to 6 samples, a kernel built with and one
// without them) took B=256 at the served density from 174.9 to 157.2 ms,
// B=128 106.1 to 102.2, and left B=8 at 35.0. Before the clusters, one
// CTA per sample took 523 and 563 ms.
//
// Random stream: the TPU kernel draws (B, K*H) and (B, K*D) uniforms per
// sweep at salts seed[1] + t*2*gen_k + 2s (+1 for v), so the draw of sample
// b, lane o has counter b*K*H + o (b*K*D + o). This kernel draws the same
// counters, so it and its plain version agree bit for bit in the stream.
// Under the row map (a.row0, a.rows_total) sample b of the launch is sample
// a.row0 + b of a larger batch (one data shard) and draws that sample's
// counters.
//
// Weight storage (the TPU kernel's wdtype): f32, or with a.w_bf16 the
// capacity mode, W, Wuv, Wuh and Wctx as bf16 words (template type WT =
// uint16_t) in shared and global memory, each widened to f32 exactly where
// it is read. In that mode h_top is rounded to bf16 before the two
// conditioning products, as the TPU kernel feeds its matrix unit bf16 on
// both sides; the Gibbs and context products read binary operands, exact
// in bf16. Accumulation stays f32 and in the same order. Half the bytes
// let more of the matrices live in shared memory (the Lakh config's three
// fit only in bf16) and more samples share a cluster.
#include <cuda_runtime.h>

#include "gen_cluster.cuh"
#include "launchers.h"
#include "threefry.cuh"

namespace multinn_torch {
namespace {

using gen_cluster::Cta;
using gen_cluster::kThreads;
using gen_cluster::Plan;

// per-step weight matrices in shared-memory priority order
enum { kW = 0, kWuh = 1, kWuv = 2, kMatrices = 3 };

// scratch floats of a group: during the Gibbs sweeps bv(t) (D), bh(t) (H)
// and the chain's mask words (Chain); during the cell stack the gates (G)
inline int rbm_scratch(const RbmArgs& a) {
  const int gibbs = a.d + a.hid + gen_cluster::chunks_of(a.d) +
                    gen_cluster::chunks_of(a.hid);
  return a.g > gibbs ? a.g : gibbs;
}

// Bytes of a warp's list: up to max(D, H) uint16 indices and the 7 of a
// last eight's padding, 16-byte aligned. The plan keeps kWarps of them at
// the front of the weight region.
__host__ __device__ constexpr int64_t warp_bytes(int d, int h) {
  return gen_cluster::align16(2 * int64_t{(d > h ? d : h) + 7});
}

// A group's Gibbs chain, binary, kept as the mask words of its visible
// (DC words) and hidden (HC words) samples: bit l of word c is unit
// 32 c + l.
struct Chain {
  uint32_t* vmask;
  uint32_t* hmask;
};

__device__ __forceinline__ Chain chain_of(float* sc, int d, int h) {
  uint32_t* at = reinterpret_cast<uint32_t*>(sc + d + h);
  return {at, at + gen_cluster::chunks_of(d)};
}

// The next output of a thread's walk over (group, unit) pairs.
__device__ __forceinline__ void step(int& grp, int& unit, int2 by,
                                     int width) {
  grp += by.x;
  unit += by.y;
  if (unit >= width) {
    unit -= width;
    ++grp;
  }
}

// Called by whole warps, lane l at unit 32 c + l of a row, `on` its
// sample: the row's mask word c.
__device__ __forceinline__ void sample_word(bool on, int unit,
                                            uint32_t* mask) {
  const uint32_t m = __ballot_sync(0xffffffffu, on);
  if ((threadIdx.x & 31) == 0) mask[unit >> 5] = m;
}

// Called by a whole warp: list in `out` (the warp's own, 16-byte aligned)
// the units set in a row's `chunks` mask words, in increasing order, and
// pad the list with unit 0 to a whole number of eights. Returns the
// count.
__device__ __forceinline__ int list_row(const uint32_t* mask, int chunks,
                                        uint16_t* out) {
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1u;
  __syncwarp();                 // the warp is done with its last list
  int n = 0;
  for (int c = 0; c < chunks; ++c) {
    const uint32_t m = mask[c];
    if ((m >> lane) & 1u)
      out[n + __popc(m & below)] = static_cast<uint16_t>(32 * c + lane);
    n += __popc(m);
  }
  if (lane < (-n & 7)) out[n + lane] = 0;
  __syncwarp();
  return n;
}

// Called by whole warps: sample the R units unit[r] of a row of `width`
// (their input sums acc, biases bias[unit]), drawing counter ctr + unit at
// `salt`, into the row's mask words. The R draws lie in one block, so
// their chains overlap; a unit past the row draws a counter it does not
// own, and is dropped.
template <int R>
__device__ __forceinline__ void sample_units(const float (&acc)[R],
                                             const float* bias,
                                             const int (&unit)[R], int width,
                                             uint32_t ctr, uint32_t seed,
                                             uint32_t salt, uint32_t* mask) {
  bool on[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float uu = random_uniform_at(seed, salt, ctr + unit[r]);
    const float pr = sigmoid_nr(acc[r] + bias[min(unit[r], width - 1)]);
    on[r] = unit[r] < width && uu < pr;
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (unit[r] - lane < width) sample_word(on[r], unit[r], mask);
}

// The weights a pass walks, as f32 by list entry: row or column `i` of
// W at `stride` elements apart. SharedW reads W in shared memory through
// its 32-bit shared address (ld.shared: no generic 64-bit address a
// product), GlobalW from device memory where W did not fit.
template <typename WT>
struct SharedW {
  uint32_t base, stride;          // bytes
  __device__ __forceinline__ float operator()(uint32_t i) const {
    const uint32_t at = base + i * stride;
    if constexpr (sizeof(WT) == 4) {
      float x;
      asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(at));
      return x;
    } else {
      uint16_t x;
      asm volatile("ld.shared.u16 %0, [%1];" : "=h"(x) : "r"(at));
      return bf16_to_f32(x);
    }
  }
};

template <typename WT>
struct GlobalW {
  const WT* base;
  int stride;                     // elements
  __device__ __forceinline__ float operator()(uint32_t i) const {
    return gen_cluster::wload(base + static_cast<int>(i) * stride);
  }
};

template <typename WT>
__device__ __forceinline__ SharedW<WT> shared_w(const WT* at, int stride) {
  return {static_cast<uint32_t>(__cvta_generic_to_shared(at)),
          static_cast<uint32_t>(stride * sizeof(WT))};
}

// R sums over a list of n units (list_row's), out[r] of w[r](i): eight
// indices per 16-byte load, each index serving all R; the terms in list
// order into two accumulators per sum by position mod 2, added last; the
// last eight's padding enters times 0 (adds +0). The row's other terms are
// exact zeros, so each is the row's dot product with a column (row) of W
// up to the order of the sum.
template <int R, typename Load>
__device__ __forceinline__ void sum_list(const uint16_t* list, int n,
                                         const Load (&w)[R], float (&out)[R]) {
  float acc[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
  const uint4* q = reinterpret_cast<const uint4*>(list);
  int e = 0;
#pragma unroll 2
  for (; e + 8 <= n; e += 8) {
    const uint4 v = q[e >> 3];
    const uint32_t pair[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const uint32_t i = (pair[p >> 1] >> (16 * (p & 1))) & 0xffffu;
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r][p & 1] += w[r](i);
    }
  }
  if (e < n) {                  // the last 1..7, then padding
    const uint4 v = q[e >> 3];
    const uint32_t pair[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int p = 0; p < 7; ++p) {
      const uint32_t i = (pair[p >> 1] >> (16 * (p & 1))) & 0xffffu;
      const float f = e + p < n ? 1.f : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r][p & 1] = fmaf(w[r](i), f, acc[r][p & 1]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = acc[r][0] + acc[r][1];
}

// Row pitch (elements) of W in shared memory, so that the visible pass's
// column reads (thread i at row i) hit distinct banks: odd for f32 words;
// for bf16, 2 mod 4, an odd count of 4-byte words.
template <typename WT>
__host__ __device__ constexpr int w_pitch(int h) {
  return sizeof(WT) == 4 ? (h | 1) : h + ((2 - h) & 3);
}

template <bool kLstm, typename WT, int kR, bool kSliced>
__global__ void __launch_bounds__(kThreads, 1)
    gen_fused_rbm_kernel(RbmArgs a, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Cta ct = gen_cluster::make_cta(smem, p, a.k, a.d, a.u, a.n_layers,
                                       a.batch);
  const int K = a.k, D = a.d, H = a.hid, U = a.u, L = a.n_layers;
  const int KD = K * D, KH = K * H, T = a.n_steps;
  const int tid = threadIdx.x;
  const int NG = ct.n_groups();
  const bool w_in_smem = (p.w_smem >> kW) & 1;
  const int ldw = w_in_smem ? w_pitch<WT>(H) : H;
  constexpr bool kRound = sizeof(WT) == 2;   // the bf16 capacity mode
  const WT* gw = static_cast<const WT*>(a.w);
  const WT* gwuh = static_cast<const WT*>(a.wuh);
  const WT* gwuv = static_cast<const WT*>(a.wuv);

  // this CTA's tracks' per-step weights into shared memory
  for (int j = 0; j < ct.ntr; ++j) {
    const int k = ct.track(j);
    if (w_in_smem) {
      WT* dst = const_cast<WT*>(ct.matrix<WT>(kW, j, gw, 0));
      for (int o = tid; o < D * H; o += kThreads) {
        const int i = o / H, jj = o - i * H;
        dst[i * ldw + jj] = gw[static_cast<size_t>(k) * D * H + o];
      }
    }
    if ((p.w_smem >> kWuh) & 1) {
      WT* dst = const_cast<WT*>(ct.matrix<WT>(kWuh, j, gwuh, 0));
      for (int o = tid; o < U * H; o += kThreads)
        dst[o] = gwuh[static_cast<size_t>(k) * U * H + o];
    }
    if ((p.w_smem >> kWuv) & 1) {
      WT* dst = const_cast<WT*>(ct.matrix<WT>(kWuv, j, gwuv, 0));
      for (int o = tid; o < U * D; o += kThreads)
        dst[o] = gwuv[static_cast<size_t>(k) * U * D + o];
    }
  }
  gen_cluster::load_state(ct, a.h0, a.c0, a.v0);   // ends with a barrier

  const gen_cluster::CellWeights<float, WT> cw{
      a.wx_v, nullptr, a.wx_r, a.wh, static_cast<const WT*>(a.wctx), a.b,
      a.g, a.given_mask};
  const uint32_t seed0 = static_cast<uint32_t>(a.seed[0]);
  const uint32_t seed1 = static_cast<uint32_t>(a.seed[1]);
  // the rows' chunks of 32 units
  const int DC = gen_cluster::chunks_of(D), HC = gen_cluster::chunks_of(H);
  // this warp's list
  uint16_t* const wlist =
      reinterpret_cast<uint16_t*>(smem + (tid >> 5) * warp_bytes(D, H));
  const bool one_track = ct.ntr == 1;
  // A pass gives each thread R = kR (1 or 3) outputs of a row of X units
  // (XC chunks): thread u of a group takes unit u % 32 + 32 (R (u / 32) +
  // r) for r < R, so ceil(XC / R) warps a group, and one list walk feeds
  // R sums (rbm_outputs_per_thread).
  constexpr int R = kR;
  // a pass's threads o = tid + m kThreads as (group, u), stepped by
  // (kThreads / q, kThreads % q) for q threads a group, without a division
  auto walk = [&](auto body, int q) {
    const int2 by = {kThreads / q, kThreads % q};
    for (int grp = tid / q, u = tid - grp * q; grp < NG; step(grp, u, by, q))
      body(grp, u);
  };
  // v -> h: R hidden units a thread over the list of v (at sweep 0 the
  // previous frame's, its values multiplied), their samples into hmask
  auto hidden_pass = [&](int sw, uint32_t salt) {
    walk([&](int grp, int u) {
      const int s = one_track ? grp : grp / ct.ntr;
      const int j = grp - s * ct.ntr, k = ct.track(j);
      float* sc = ct.scratch(s, j);
      const Chain ch = chain_of(sc, D, H);
      const WT* w = ct.matrix(kW, j, gw, D * H);
      const int base = (R * (u >> 5)) * 32 + (u & 31);
      int jj[R];
      const WT* wc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        jj[r] = base + 32 * r;
        wc[r] = w + min(jj[r], H - 1);     // loads clamped into the row
      }
      float acc[R];
      if (sw == 0) {
        const uint16_t* li = ct.list_idx(s, k);
        const float* x = ct.prev(s) + k * D;
        const int nv = *ct.list_count(s, k);
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] = gen_cluster::gather_row(li, nv, x, wc[r], ldw, 0.f);
      } else {
        const int nv = list_row(ch.vmask, DC, wlist);
        if (w_in_smem) {
          SharedW<WT> ws[R];
#pragma unroll
          for (int r = 0; r < R; ++r) ws[r] = shared_w(wc[r], ldw);
          sum_list(wlist, nv, ws, acc);
        } else {
          GlobalW<WT> wg[R];
#pragma unroll
          for (int r = 0; r < R; ++r) wg[r] = GlobalW<WT>{wc[r], ldw};
          sum_list(wlist, nv, wg, acc);
        }
      }
      sample_units<R>(acc, sc + D, jj, H,
                      static_cast<uint32_t>(a.row0 + ct.b0 + s) * KH + k * H,
                      seed0, salt, ch.hmask);
    }, 32 * ((HC + R - 1) / R));
  };
  // h -> v: R visible units a thread over the list of h, into vmask
  auto visible_pass = [&](uint32_t salt) {
    walk([&](int grp, int u) {
      const int s = one_track ? grp : grp / ct.ntr;
      const int j = grp - s * ct.ntr, k = ct.track(j);
      float* sc = ct.scratch(s, j);
      const Chain ch = chain_of(sc, D, H);
      const WT* w = ct.matrix(kW, j, gw, D * H);
      const int base = (R * (u >> 5)) * 32 + (u & 31);
      int ii[R];
      const WT* wr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ii[r] = base + 32 * r;
        wr[r] = w + min(ii[r], D - 1) * ldw;
      }
      float acc[R];
      const int nh = list_row(ch.hmask, HC, wlist);
      if (w_in_smem) {
        SharedW<WT> ws[R];
#pragma unroll
        for (int r = 0; r < R; ++r) ws[r] = shared_w(wr[r], 1);
        sum_list(wlist, nh, ws, acc);
      } else {
        GlobalW<WT> wg[R];
#pragma unroll
        for (int r = 0; r < R; ++r) wg[r] = GlobalW<WT>{wr[r], 1};
        sum_list(wlist, nh, wg, acc);
      }
      sample_units<R>(acc, sc, ii, D,
                      static_cast<uint32_t>(a.row0 + ct.b0 + s) * KD + k * D,
                      seed0, salt, ch.vmask);
    }, 32 * ((DC + R - 1) / R));
  };

  // the conditioned biases' slices of the CTA's samples
  const int bias_slices =
      kSliced ? gen_cluster::block_slices(ct.ns, ct.ntr * (D + H)) : ct.ns;

  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;           // parity buffer of the fresh rows
    // 1. biases from the TOP layer's previous h: a thread per (slice,
    //    track slot, output) where the samples are sliced, each read of a
    //    Wuv or Wuh column serving the slice, else per (sample, output)
    if (kSliced && bias_slices < ct.ns) {
      constexpr int kB = gen_cluster::kMaxBlock;
      const int xs = static_cast<int>(p.sample_bytes / 4);
      for (int o = tid; o < bias_slices * ct.ntr * (D + H); o += kThreads) {
        const int r = o / (D + H), e = o - r * (D + H);
        const int sl = r / ct.ntr, j = r - sl * ct.ntr, k = ct.track(j);
        const int s0 = sl * ct.ns / bias_slices;
        const int nb = (sl + 1) * ct.ns / bias_slices - s0;
        const float* ht = ct.h(s0, j) + (L - 1) * U;
        float acc[kB];
        float bias;
        if (e < D) {
          const WT* wuv = ct.matrix(kWuv, j, gwuv, U * D);
          gen_cluster::dot_slice<kB, kRound>(ht, xs, nb, wuv + e, D, U, acc);
          bias = a.bv[k * D + e];
        } else {
          const int jj = e - D;
          const WT* wuh = ct.matrix(kWuh, j, gwuh, U * H);
          gen_cluster::dot_slice<kB, kRound>(ht, xs, nb, wuh + jj, H, U,
                                             acc);
          bias = a.bh[k * H + jj];
        }
#pragma unroll
        for (int q = 0; q < kB; ++q)
          if (q < nb) ct.scratch(s0 + q, j)[e] = bias + acc[q];
      }
    }
    for (int o = tid; bias_slices == ct.ns && o < NG * (D + H);
         o += kThreads) {
      const int grp = o / (D + H), e = o - grp * (D + H);
      const int s = grp / ct.ntr, j = grp - s * ct.ntr, k = ct.track(j);
      const float* ht = ct.h(s, j) + (L - 1) * U;
      float* sc = ct.scratch(s, j);
      if (e < D) {
        const WT* wuv = ct.matrix(kWuv, j, gwuv, U * D);
        sc[e] = a.bv[k * D + e] + gen_cluster::dot<kRound>(ht, wuv + e, D, U);
      } else {
        const int jj = e - D;
        const WT* wuh = ct.matrix(kWuh, j, gwuh, U * H);
        sc[D + jj] =
            a.bh[k * H + jj] + gen_cluster::dot<kRound>(ht, wuh + jj, H, U);
      }
    }
    __syncthreads();

    // 2. gen_k Gibbs sweeps, every group at once, each pass over the lists
    //    of its input and listing its output; the chain starts at the
    //    previous frame
    const uint32_t salt0 =
        seed1 + static_cast<uint32_t>(t) * 2u * static_cast<uint32_t>(a.gen_k);
    for (int sw = 0; sw < a.gen_k; ++sw) {
      const uint32_t salt_h = salt0 + 2u * static_cast<uint32_t>(sw);
      hidden_pass(sw, salt_h);
      __syncthreads();
      visible_pass(salt_h + 1u);
      __syncthreads();
    }

    // 3. given merge, 5. emit the frame into the roll and the fresh rows
    gen_cluster::emit_frames(ct, buf, a.roll, t, T, [&](int s, int j, int i) {
      const int k = ct.track(j);
      if (a.given != nullptr && ((a.given_mask >> k) & 1))
        return a.given[(static_cast<size_t>(ct.b0 + s) * T + t) * KD +
                       k * D + i];
      if (a.gen_k == 0) return ct.prev(s)[k * D + i];
      const uint32_t* vmask = chain_of(ct.scratch(s, j), D, H).vmask;
      return static_cast<float>((vmask[i >> 5] >> (i & 31)) & 1u);
    });

    // 4. the cell stack, then the fresh frames of all tracks become the
    //    previous ones
    gen_cluster::cell_stack<kLstm, false, kSliced>(ct, cw, buf);
    gen_cluster::gather_frames(ct, buf);
  }
  gen_cluster::store_state(ct, a.h_out, a.c_out);
}

}  // namespace

int rbm_outputs_per_thread(int groups, int d, int h) {
  const int dc = gen_cluster::chunks_of(d), hc = gen_cluster::chunks_of(h);
  auto rounds = [&](int r) {          // of both passes at R = r
    auto of = [&](int chunks) {
      const int warps = groups * ((chunks + r - 1) / r);
      return (warps + gen_cluster::kWarps - 1) / gen_cluster::kWarps;
    };
    return of(dc) + of(hc);
  };
  return rounds(3) < rounds(1) ? 3 : 1;
}

// The shared-memory plan, at the stored bytes of W (at its pitch), Wuh and
// Wuv, after the warps' lists; ops/gen_fused_rbm.py::_sample_bytes makes
// the same per-sample count and _lists_bytes the same lists.
gen_cluster::Plan plan_gen_fused_rbm(const RbmArgs& a, int64_t limit) {
  const int64_t e = a.w_bf16 ? 2 : 4;
  const int64_t pitch =
      a.w_bf16 ? w_pitch<uint16_t>(a.hid) : w_pitch<float>(a.hid);
  const int64_t mats[kMatrices] = {e * a.d * pitch, e * a.u * a.hid,
                                   e * a.u * a.d};
  // the warps' lists go first: the matrices and samples share the rest
  const int64_t lists = gen_cluster::kWarps * warp_bytes(a.d, a.hid);
  Plan p = gen_cluster::make_plan(a.k, a.d, a.u, a.n_layers, rbm_scratch(a),
                                  mats, kMatrices, limit - lists);
  p.weight_bytes += lists;
  for (int m = 0; m < kMatrices; ++m) p.w_off[m] += lists;
  return p;
}

const char* launch_gen_fused_rbm(const RbmArgs& a, void* stream,
                                 int64_t* shape) {
  if (a.batch <= 0 || a.n_steps <= 0) return nullptr;
  if (a.row0 < 0 || a.row0 + a.batch > a.rows_total)
    return "gen_fused_rbm: the row map (row0, rows_total) does not fit the "
           "batch";
  if (a.k > 31)
    return "gen_fused_rbm: the given-track mask takes at most 31 tracks";
  const Plan p = plan_gen_fused_rbm(a, kSmemLimitBytes);
  // [bf16][lstm][R == 3][sliced]
  using Kernel = void (*)(RbmArgs, Plan);
  const Kernel kernels[2][2][2][2] = {
      {{{gen_fused_rbm_kernel<false, float, 1, false>,
         gen_fused_rbm_kernel<false, float, 1, true>},
        {gen_fused_rbm_kernel<false, float, 3, false>,
         gen_fused_rbm_kernel<false, float, 3, true>}},
       {{gen_fused_rbm_kernel<true, float, 1, false>,
         gen_fused_rbm_kernel<true, float, 1, true>},
        {gen_fused_rbm_kernel<true, float, 3, false>,
         gen_fused_rbm_kernel<true, float, 3, true>}}},
      {{{gen_fused_rbm_kernel<false, uint16_t, 1, false>,
         gen_fused_rbm_kernel<false, uint16_t, 1, true>},
        {gen_fused_rbm_kernel<false, uint16_t, 3, false>,
         gen_fused_rbm_kernel<false, uint16_t, 3, true>}},
       {{gen_fused_rbm_kernel<true, uint16_t, 1, false>,
         gen_fused_rbm_kernel<true, uint16_t, 1, true>},
        {gen_fused_rbm_kernel<true, uint16_t, 3, false>,
         gen_fused_rbm_kernel<true, uint16_t, 3, true>}}}};
  const auto& by_r = kernels[a.w_bf16 != 0][a.lstm != 0];
  // the launch's shape (samples a cluster) decides R and the slicing
  int64_t sh[kLaunchShapeFields];
  const char* err =
      gen_cluster::launch(by_r[0][0], a, p, a.batch, stream, sh);
  if (err != nullptr || shape != nullptr) {
    if (err == nullptr) std::copy(sh, sh + kLaunchShapeFields, shape);
    return err;
  }
  const int tpc = static_cast<int>(sh[1]), s = static_cast<int>(sh[6]);
  const int r = rbm_outputs_per_thread(tpc * s, a.d, a.hid);
  const bool sliced =
      gen_cluster::block_slices(s, tpc * a.g) < s ||
      gen_cluster::block_slices(s, tpc * (a.d + a.hid)) < s;
  return gen_cluster::launch(by_r[r == 3][sliced], a, p, a.batch, stream,
                             nullptr);
}

}  // namespace multinn_torch
