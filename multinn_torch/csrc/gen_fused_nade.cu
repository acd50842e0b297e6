// Whole RNN-NADE generation in one launch: for every step t < T, every
// track k < K and every sample b < B —
//   1. conditioned biases from the top layer's previous h:
//        bv'(t) = bv + h_top Wuv,  a = bh'(t) = bh + h_top Wuh;
//   2. the ancestral sweep over the D dims of each track:
//        s = V_i . sigmoid(a),  x_i = (u < sigmoid(s + bv'_i)),  a += x_i W_i;
//   3. the given-track merge (accompaniment: given tracks take `given`);
//   4. the stacked LSTM / vanilla advance, whose layer-0 input is the fresh
//      frame through Wx (for given tracks the f32 rows) plus, in feedback
//      mode, the PREVIOUS frame of all tracks through Wctx;
//   5. the frame written to the roll.
//
// Replaces multinn_tpu/ops/gen_fused_nade.py::_nade_kernel (wrapper
// _generate_nade), whose T steps run as a sequential grid with every
// weight in VMEM, in dim-major rows padded to 8 tracks and 128 lanes.
//
// Bound on an H100 (the flagship K=5, D=84, H=150, U=100, G=400, one
// 64-bar song, B=1, T=1024): 2.97 GFLOP of dense f32 work, 44 us at
// 67 TFLOP/s; about 5.2 MB of bytes, 1.5 us. The work is a chain of D
// dependent dims per step: a dim needs the sigmoid of the previous dim's
// update. One CTA per sample with all tracks sharing a block barrier per
// dim and the weights read from L2, as this kernel first did, took 2.5 us
// per dim and 0.46 ms per step.
//
// Design (gen_cluster.cuh): a cluster of K CTAs (K <= 8) per group of S
// samples, one track per CTA, its V, W (bf16), Wuh (f32) and Wuv (bf16)
// in shared memory. ONE WARP runs one sample's sweep of one track, with
// the track's H lanes of a and sigmoid(a) in registers (ceil(H/32) per
// lane): a dim costs shared-memory reads of V_i (the next dim's issued one
// dim ahead), a fixed xor-butterfly sum that leaves the same logit in every
// lane, one sigmoid and a compare, and when x_i = 1 the W_i update of the
// warp's own lanes. No block barrier inside the sweep. The own-frame
// projection z = sum_i x_i Wx_i leaves the serial loop: the cell stack
// gathers it over the sampled frame's active dims, in increasing i, which
// is the same sequence of exact f32 adds from 0 as the per-dim update. The
// cell stack and the frame exchange are the RBM kernel's. Measured on an
// H100 80GB HBM3 at 700 W (PERF.md): 75.7 ms per 64-bar song at B=1, 270
// ms at B=256, against 467 and 950 ms for the one-CTA-per-sample design.
//
// Numerics kept from the TPU kernel: w, v, wuv, the layer-0 own-frame Wx
// and wctx are bf16 (widened exactly at use); the gate sum is
// ((z + ctx) + h Wh) + b with ctx summed over source tracks in order; a
// given track's z is recomputed from the given frame with f32 rows.
//
// Random stream: the TPU kernel draws a (D*8, B) uniform matrix per step at
// salt seed[1] + t, so the draw of (dim i, track k, sample b) has counter
// (i*8 + k)*B + b. This kernel draws the same counters into shared memory
// before each step's sweep (K <= 8). Under the row map (a.row0,
// a.rows_total) sample b of the launch is sample a.row0 + b of a batch of
// B = a.rows_total (one data shard) and draws that sample's counters.
#include <cuda_runtime.h>

#include "gen_cluster.cuh"
#include "launchers.h"
#include "reduce.cuh"
#include "threefry.cuh"

namespace multinn_torch {
namespace {

using gen_cluster::chunks_of;
using gen_cluster::Cta;
using gen_cluster::kThreads;
using gen_cluster::kWarps;
using gen_cluster::Plan;

constexpr int kStreamRows = 8;  // tracks per dim in the random stream
constexpr int kMaxLaneRounds = 8;  // hidden lanes per warp lane: H <= 256
constexpr int kMaxDims = 1024;     // a lane keeps 32 dims' bits: D <= 1024

// per-step weight matrices in shared-memory priority order
enum { kV = 0, kW = 1, kWuh = 2, kWuv = 3, kMatrices = 4 };

// scratch of a group during the sweep: bv'(t) (D), the uniforms (D),
// bh'(t) (H); during the cell stack: the gates (G)
inline int nade_scratch(const NadeArgs& a) {
  return a.g > 2 * a.d + a.hid ? a.g : 2 * a.d + a.hid;
}

template <bool kLstm>
__global__ void __launch_bounds__(kThreads, 1)
    gen_fused_nade_kernel(NadeArgs a, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Cta ct = gen_cluster::make_cta(smem, p, a.k, a.d, a.u, a.n_layers,
                                       a.batch);
  const int K = a.k, D = a.d, H = a.hid, U = a.u, L = a.n_layers;
  const int KD = K * D, T = a.n_steps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nchd = chunks_of(D);
  const int NG = ct.n_groups();

  // this CTA's tracks' per-step weights into shared memory
  for (int j = 0; j < ct.ntr; ++j) {
    const size_t k = ct.track(j);
    if ((p.w_smem >> kV) & 1) {
      auto* dst = const_cast<uint16_t*>(ct.matrix<uint16_t>(kV, j, a.v, 0));
      for (int o = tid; o < D * H; o += kThreads) dst[o] = a.v[k * D * H + o];
    }
    if ((p.w_smem >> kW) & 1) {
      auto* dst = const_cast<uint16_t*>(ct.matrix<uint16_t>(kW, j, a.w, 0));
      for (int o = tid; o < D * H; o += kThreads) dst[o] = a.w[k * D * H + o];
    }
    if ((p.w_smem >> kWuh) & 1) {
      auto* dst = const_cast<float*>(ct.matrix<float>(kWuh, j, a.wuh, 0));
      for (int o = tid; o < U * H; o += kThreads)
        dst[o] = a.wuh[k * U * H + o];
    }
    if ((p.w_smem >> kWuv) & 1) {
      auto* dst =
          const_cast<uint16_t*>(ct.matrix<uint16_t>(kWuv, j, a.wuv, 0));
      for (int o = tid; o < U * D; o += kThreads)
        dst[o] = a.wuv[k * U * D + o];
    }
  }
  gen_cluster::load_state(ct, a.h0, a.c0, a.v0);   // ends with a barrier

  const gen_cluster::CellWeights<uint16_t, uint16_t> cw{
      a.wx_v, a.wxg, a.wx_r, a.wh, a.wctx, a.b, a.g, a.given_mask};
  const uint32_t seed0 = static_cast<uint32_t>(a.seed[0]);
  const uint32_t seed1 = static_cast<uint32_t>(a.seed[1]);

  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;           // parity buffer of the fresh rows
    // 1. biases from the TOP layer's previous h, and the step's uniforms
    const uint32_t salt = seed1 + static_cast<uint32_t>(t);
    const int W1 = 2 * D + H;
    for (int o = tid; o < NG * W1; o += kThreads) {
      const int grp = o / W1, e = o - grp * W1;
      const int s = grp / ct.ntr, j = grp - s * ct.ntr, k = ct.track(j);
      const float* ht = ct.h(s, j) + (L - 1) * U;
      float* sc = ct.scratch(s, j);
      if (e < D) {
        const uint16_t* wuv = ct.matrix(kWuv, j, a.wuv, U * D);
        sc[e] = a.bv[k * D + e] + gen_cluster::dot(ht, wuv + e, D, U);
      } else if (e < 2 * D) {
        const uint32_t i = e - D;
        sc[e] = random_uniform_at(
            seed0, salt,
            (i * kStreamRows + k) * static_cast<uint32_t>(a.rows_total) +
                a.row0 + ct.b0 + s);
      } else {
        const int jj = e - 2 * D;
        const float* wuh = ct.matrix(kWuh, j, a.wuh, U * H);
        sc[e] = a.bh[k * H + jj] + gen_cluster::dot(ht, wuh + jj, H, U);
      }
    }
    __syncthreads();

    // 2. the sweep: one warp per (sample, track slot); the sampled frame
    //    replaces the uniforms in the scratch row
    for (int grp = warp; grp < NG; grp += kWarps) {
      const int s = grp / ct.ntr, j = grp - s * ct.ntr;
      float* sc = ct.scratch(s, j);
      const uint16_t* vm = ct.matrix(kV, j, a.v, D * H);
      const uint16_t* wm = ct.matrix(kW, j, a.w, D * H);
      float act[kMaxLaneRounds], sg[kMaxLaneRounds], vn[kMaxLaneRounds];
#pragma unroll
      for (int q = 0; q < kMaxLaneRounds; ++q) {
        const int jj = lane + 32 * q;
        act[q] = jj < H ? sc[2 * D + jj] : 0.f;
        sg[q] = jj < H ? sigmoid_nr(act[q]) : 0.f;
        vn[q] = jj < H ? bf16_to_f32(vm[jj]) : 0.f;
      }
      uint32_t bits = 0;                 // bit c: dim 32c + lane sampled 1
      for (int i = 0; i < D; ++i) {
        float part = 0.f;
#pragma unroll
        for (int q = 0; q < kMaxLaneRounds; ++q) {
          const float vq = vn[q];
          const int jj = lane + 32 * q;
          if (i + 1 < D) vn[q] = jj < H ? bf16_to_f32(vm[(i + 1) * H + jj])
                                        : 0.f;
          part = fmaf(vq, sg[q], part);
        }
        const float logit = warp_allsum(part);
        const bool x = sc[D + i] < sigmoid_nr(logit + sc[i]);
        if (x) {                          // the same in every lane
#pragma unroll
          for (int q = 0; q < kMaxLaneRounds; ++q) {
            const int jj = lane + 32 * q;
            if (jj < H) {
              act[q] = act[q] + bf16_to_f32(wm[i * H + jj]);
              sg[q] = sigmoid_nr(act[q]);
            }
          }
        }
        if ((i & 31) == lane && x) bits |= 1u << (i >> 5);
      }
      for (int c = 0; c < nchd; ++c) {
        const int i = c * 32 + lane;
        if (i < D) sc[D + i] = (bits >> c) & 1u ? 1.f : 0.f;
      }
    }
    __syncthreads();

    // 3. given merge, 5. emit the frame into the roll and the fresh rows
    gen_cluster::emit_frames(ct, buf, a.roll, t, T, [&](int s, int j, int i) {
      const int k = ct.track(j);
      if (a.given != nullptr && ((a.given_mask >> k) & 1))
        return a.given[(static_cast<size_t>(ct.b0 + s) * T + t) * KD +
                       k * D + i];
      return ct.scratch(s, j)[D + i];
    });

    // 4. the cell stack, then the fresh frames of all tracks become the
    //    previous ones
    gen_cluster::cell_stack<kLstm, true>(ct, cw, buf);
    gen_cluster::gather_frames(ct, buf);
  }
  gen_cluster::store_state(ct, a.h_out, a.c_out);
}

}  // namespace

// The shared-memory plan; ops/gen_fused_nade.py::_sample_bytes makes the
// same per-sample count.
gen_cluster::Plan plan_gen_fused_nade(const NadeArgs& a, int64_t limit) {
  const int64_t dh = 2 * int64_t{a.d} * a.hid;
  const int64_t mats[kMatrices] = {dh, dh, 4 * int64_t{a.u} * a.hid,
                                   2 * int64_t{a.u} * a.d};
  return gen_cluster::make_plan(a.k, a.d, a.u, a.n_layers, nade_scratch(a),
                                mats, kMatrices, limit);
}

const char* launch_gen_fused_nade(const NadeArgs& a, void* stream,
                                  int64_t* shape) {
  if (a.batch <= 0 || a.n_steps <= 0) return nullptr;
  if (a.row0 < 0 || a.row0 + a.batch > a.rows_total)
    return "gen_fused_nade: the row map (row0, rows_total) does not fit the "
           "batch";
  if (a.k > kStreamRows || a.hid > 32 * kMaxLaneRounds || a.d > kMaxDims)
    return "gen_fused_nade: K > 8 (the stream's rows), H > 256 (the "
           "register-held lanes) or D > 1024";
  const Plan p = plan_gen_fused_nade(a, kSmemLimitBytes);
  return gen_cluster::launch(a.lstm ? gen_fused_nade_kernel<true>
                                    : gen_fused_nade_kernel<false>,
                             a, p, a.batch, stream, shape);
}

}  // namespace multinn_torch
