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
// A pass is one thread per output summing its row in four independent
// accumulators (16 shared-memory loads in flight). The cell stack reads
// Wx and Wctx over the active rows of the fresh and the previous frame,
// Wh densely, one thread per gate (coalesced). Tracks swap their frames
// once per step through distributed shared memory. The S samples of a
// cluster share its shared-memory weights, S = ceil(B / the clusters the
// card holds), so large batches run in one wave.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): 55.0 ms per 64-bar
// song at B=1, 373 ms at B=256, against 523 and 563 ms for the one-CTA-
// per-sample design.
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

// scratch of a group during the Gibbs sweeps: bv(t) (D), bh(t) (H), the
// chain's visible (D) and hidden (H) samples; during the cell stack: the
// gates (G)
inline int rbm_scratch(const RbmArgs& a) {
  return a.g > 2 * (a.d + a.hid) ? a.g : 2 * (a.d + a.hid);
}

// Row pitch (elements) of W in shared memory, so that the visible pass's
// column reads (thread i at row i) hit distinct banks: odd for f32 words;
// for bf16, 2 mod 4, an odd count of 4-byte words.
template <typename WT>
__host__ __device__ constexpr int w_pitch(int h) {
  return sizeof(WT) == 4 ? (h | 1) : h + ((2 - h) & 3);
}

template <bool kLstm, typename WT>
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

  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;           // parity buffer of the fresh rows
    // 1. biases from the TOP layer's previous h
    for (int o = tid; o < NG * (D + H); o += kThreads) {
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

    // 2. gen_k Gibbs sweeps, every group at once; the chain starts at the
    //    previous frame
    const uint32_t salt0 =
        seed1 + static_cast<uint32_t>(t) * 2u * static_cast<uint32_t>(a.gen_k);
    for (int sw = 0; sw < a.gen_k; ++sw) {
      const uint32_t salt_h = salt0 + 2u * static_cast<uint32_t>(sw);
      for (int o = tid; o < NG * H; o += kThreads) {
        const int grp = o / H, jj = o - grp * H;
        const int s = grp / ct.ntr, j = grp - s * ct.ntr, k = ct.track(j);
        float* sc = ct.scratch(s, j);
        const float* v = sw == 0 ? ct.prev(s) + k * D : sc + D + H;
        const float acc =
            gen_cluster::dot(v, ct.matrix(kW, j, gw, D * H) + jj, ldw, D);
        const float pr = sigmoid_nr(acc + sc[D + jj]);
        const float uu = random_uniform_at(
            seed0, salt_h,
            static_cast<uint32_t>(a.row0 + ct.b0 + s) * KH + k * H + jj);
        sc[2 * D + H + jj] = uu < pr ? 1.f : 0.f;
      }
      __syncthreads();
      for (int o = tid; o < NG * D; o += kThreads) {
        const int grp = o / D, i = o - grp * D;
        const int s = grp / ct.ntr, j = grp - s * ct.ntr, k = ct.track(j);
        float* sc = ct.scratch(s, j);
        const float acc = gen_cluster::dot(
            sc + 2 * D + H, ct.matrix(kW, j, gw, D * H) + i * ldw, 1, H);
        const float pr = sigmoid_nr(acc + sc[i]);
        const float uu = random_uniform_at(
            seed0, salt_h + 1u,
            static_cast<uint32_t>(a.row0 + ct.b0 + s) * KD + k * D + i);
        sc[D + H + i] = uu < pr ? 1.f : 0.f;
      }
      __syncthreads();
    }

    // 3. given merge, 5. emit the frame into the roll and the fresh rows
    gen_cluster::emit_frames(ct, buf, a.roll, t, T, [&](int s, int j, int i) {
      const int k = ct.track(j);
      if (a.given != nullptr && ((a.given_mask >> k) & 1))
        return a.given[(static_cast<size_t>(ct.b0 + s) * T + t) * KD +
                       k * D + i];
      return a.gen_k > 0 ? ct.scratch(s, j)[D + H + i]
                         : ct.prev(s)[k * D + i];
    });

    // 4. the cell stack, then the fresh frames of all tracks become the
    //    previous ones
    gen_cluster::cell_stack<kLstm, false>(ct, cw, buf);
    gen_cluster::gather_frames(ct, buf);
  }
  gen_cluster::store_state(ct, a.h_out, a.c_out);
}

}  // namespace

// The shared-memory plan, at the stored bytes of W (at its pitch), Wuh and
// Wuv; ops/gen_fused_rbm.py::_sample_bytes makes the same per-sample
// count.
gen_cluster::Plan plan_gen_fused_rbm(const RbmArgs& a, int64_t limit) {
  const int64_t e = a.w_bf16 ? 2 : 4;
  const int64_t pitch =
      a.w_bf16 ? w_pitch<uint16_t>(a.hid) : w_pitch<float>(a.hid);
  const int64_t mats[kMatrices] = {e * a.d * pitch, e * a.u * a.hid,
                                   e * a.u * a.d};
  return gen_cluster::make_plan(a.k, a.d, a.u, a.n_layers, rbm_scratch(a),
                                mats, kMatrices, limit);
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
  void (*kernel)(RbmArgs, Plan);
  if (a.w_bf16)
    kernel = a.lstm ? gen_fused_rbm_kernel<true, uint16_t>
                    : gen_fused_rbm_kernel<false, uint16_t>;
  else
    kernel = a.lstm ? gen_fused_rbm_kernel<true, float>
                    : gen_fused_rbm_kernel<false, float>;
  return gen_cluster::launch(kernel, a, p, a.batch, stream, shape);
}

}  // namespace multinn_torch
