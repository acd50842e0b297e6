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
// samples, one track per CTA, its V, W (bf16), Wuh (f32, bf16 in the aux
// capacity mode) and Wuv (bf16) in shared memory. The own-frame
// projection z = sum_i x_i Wx_i leaves the serial loop: the cell stack
// gathers it over the sampled frame's active dims, in increasing i, which
// is the same sequence of exact f32 adds from 0 as the per-dim update.
// The cell stack (h Wh a thread per gate for a slice of the CTA's samples,
// one read of Wh serving the slice; the context summed per source track)
// and the frame exchange are the RBM kernel's. No block barrier inside the
// sweep.
//
// The sweep, at the depth a.spec (1, 2 or 4 dividing D; 0: auto, which
// the launcher resolves, nade_auto_depth):
// - Depth 1 (sweep): ONE WARP runs one sample's sweep of one track, with
//   the track's H lanes of a and sigmoid(a) in registers (ceil(H/32) per
//   lane): a dim costs shared-memory reads of V_i (issued a dim ahead),
//   the fixed xor butterfly warp_allsum that leaves the same logit in
//   every lane, one sigmoid and a compare, and when x_i = 1 the W_i update
//   of the warp's own lanes.
// - Depth s > 1, speculative, as the TPU kernel's pair_body / quad_body:
//   a dim's update is binary, so the logits of dims i .. i+s-1 are formed
//   under every branch of the earlier draws of the group (3 for a pair,
//   15 for a quad) and the s draws then only select. Branch b's activation
//   adds the W rows of b's bits one at a time in dim order, and each logit
//   is the same per-lane fmaf chain over the lane rounds followed by
//   warp_allsum's levels 16, 8, 4, 2, 1 (warp_allsum_slots sums the
//   partials together by a transposed butterfly that adds the same pairs),
//   so the realized branch is the sequential sweep's numbers: roll, h and
//   c equal depth 1's bit for bit. Where the CTA's groups leave a team of
//   2^(s-1) warps per group (team_fits), warp b of the team forms branch
//   b (sweep_team) and the team exchanges its ballots through shared
//   memory at one named barrier per s dims; else one warp forms every
//   branch (sweep), carrying 2^(s-1) - 1 extra sigmoids a lane round per
//   s dims.
// - Auto: quads where 4 divides D and the launch holds one (sample, track
//   slot) group per CTA, so that a team of 8 warps runs it with the
//   CTA's other warps idle (the flagship: B <= 22, the card's 22
//   clusters of 5 CTAs each a sample); else depth 1.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md; scripts/
// torch_nade_depths.py, seeded flagship weights, density 0.32; the
// cycles a step of CTA 0 from its --cycles): the depth-1 sweep is 65 %
// of a B=1 step, 979 cycles a dim; a quad in a team 895 a dim (joint
// D=420: 1372 and 1276), so a B=1 song takes 61.9 ms at depth 4 against
// 66.0 at depth 1 (joint 289.6 against 315.7). With two groups a CTA
// (B=24) the two teams fill its 16 warps and quads lose: 88.1 against
// 84.2 ms. Pairs, in a team or not, and quads on one warp (1.65x depth
// 1's sweep at B=256) do not beat depth 1; the one-warp sweep stays all
// the same: with it taken out of the kernel (a depth-1 fallback in its
// place, or none), the same team-quad source ran 67.7 and 69.1 ms at
// B=1, a code-generation effect not read yet (PERF.md).
//
// Numerics kept from the TPU kernel: w, v, wuv, the layer-0 own-frame Wx
// and wctx are bf16 (widened exactly at use); Wuh, Wh and the layer >= 1
// Wx are f32, or bf16 words in the aux capacity mode (a.aux_bf16,
// template type AuxT = uint16_t; Wuh then takes half its shared memory),
// widened at use with no rounding of activations; the gate sum is
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

// Whether the speculative sweep of depth `spec` runs as teams of
// 2^(spec-1) warps (sweep_team) for a CTA of `groups` (sample, track slot)
// groups: a team for each group among the CTA's warps, and two buffers of
// the team's words in a fresh row of D floats. Else one warp per group
// runs it (sweep).
__host__ __device__ constexpr bool team_fits(int groups, int spec, int d) {
  return spec > 1 && groups * (1 << (spec - 1)) <= kWarps &&
         2 * (1 << (spec - 1)) <= d;
}

// One warp's sweep over the D dims of one sample and track: sc is its
// scratch row (bv'(t), the uniforms, bh'(t)), vm and wm the track's V and
// W. Returns the sampled frame as bits: bit c of lane l is dim 32c + l.
// kSpec = 1 is the sequential sweep; 2 and 4 are the speculative sweep of
// the header, which returns the same bits.
template <int kSpec>
__device__ __forceinline__ uint32_t sweep(const float* sc, const uint16_t* vm,
                                          const uint16_t* wm, int D, int H,
                                          int lane) {
  float act[kMaxLaneRounds], sg[kMaxLaneRounds];
#pragma unroll
  for (int q = 0; q < kMaxLaneRounds; ++q) {
    const int jj = lane + 32 * q;
    act[q] = jj < H ? sc[2 * D + jj] : 0.f;
    sg[q] = jj < H ? sigmoid_nr(act[q]) : 0.f;
  }
  uint32_t bits = 0;                     // bit c: dim 32c + lane sampled 1
  if constexpr (kSpec == 1) {
    float vn[kMaxLaneRounds];
#pragma unroll
    for (int q = 0; q < kMaxLaneRounds; ++q) {
      const int jj = lane + 32 * q;
      vn[q] = jj < H ? bf16_to_f32(vm[jj]) : 0.f;
    }
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
      if (x) {                            // the same in every lane
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
  } else {
    // slot (1 << m) - 1 + b: the logit of dim i + m under branch b of the
    // draws x_i .. x_{i+m-1} (bit c of b is x_{i+c}); 2^kSpec - 1 slots,
    // padded to a power of two for the transposed butterfly, whose sum of
    // slot s lands in lane s << kShift
    constexpr int kSlots = 1 << kSpec;
    constexpr int kBranches = 1 << (kSpec - 1);   // of the last dim
    constexpr int kShift = 5 - kSpec;
    const int slot = lane >> kShift;
    int m_of = 0;                                 // the dim of that slot
#pragma unroll
    for (int m = 1; m < kSpec; ++m) m_of += slot >= (1 << m) - 1;
    for (int i = 0; i < D; i += kSpec) {
      float part[kSlots];
#pragma unroll
      for (int t = 0; t < kSlots; ++t) part[t] = 0.f;
      // a round with no live lane is fmaf(0, 0, part) in the sequential
      // sweep: part itself, or at most a zero's sign, which no sigmoid
      // reads. Skipped.
#pragma unroll
      for (int q = 0; q < kMaxLaneRounds; ++q) {
        if (32 * q >= H) break;
        const int jj = lane + 32 * q;
        const bool live = jj < H;
        // the branch activations, one W row added at a time in dim order:
        // br[b | 1 << c] = br[b] + w_{i+c}, the sequential sweep's adds
        float br[kBranches];
        br[0] = act[q];
#pragma unroll
        for (int c = 0; c + 1 < kSpec; ++c) {
          const float wc = live ? bf16_to_f32(wm[(i + c) * H + jj]) : 0.f;
#pragma unroll
          for (int b = 0; b < (1 << c); ++b) br[b + (1 << c)] = br[b] + wc;
        }
        float vq[kSpec];
#pragma unroll
        for (int m = 0; m < kSpec; ++m)
          vq[m] = live ? bf16_to_f32(vm[(i + m) * H + jj]) : 0.f;
        // each branch's sigmoid into the logits of the dims after its
        // last draw: one fmaf a round per slot, the sequential chain
#pragma unroll
        for (int b = 0; b < kBranches; ++b) {
          const float sb = b == 0 ? sg[q] : live ? sigmoid_nr(br[b]) : 0.f;
#pragma unroll
          for (int m = 0; m < kSpec; ++m)
            if (b < (1 << m)) {
              float& acc = part[(1 << m) - 1 + b];
              acc = fmaf(vq[m], sb, acc);
            }
        }
      }
      // every lane draws its slot's dim under its slot's branch; one
      // ballot brings all the outcomes to every lane, and the chain of
      // kSpec draws is then a walk over the ballot's bits
      const float logit = warp_allsum_slots<kSlots>(part);
      const bool cand = slot < kSlots - 1 &&
                        sc[D + i + m_of] < sigmoid_nr(logit + sc[i + m_of]);
      const uint32_t won = __ballot_sync(0xffffffffu, cand);
      uint32_t xs = 0;                    // bit m: x_{i+m}
#pragma unroll
      for (int m = 0; m < kSpec; ++m)
        xs |= ((won >> ((((1u << m) - 1) + xs) << kShift)) & 1u) << m;
      if (xs) {                           // the same in every lane
#pragma unroll
        for (int q = 0; q < kMaxLaneRounds; ++q) {
          const int jj = lane + 32 * q;
          if (jj < H) {
#pragma unroll
            for (int m = 0; m < kSpec; ++m)
              if ((xs >> m) & 1u)
                act[q] = act[q] + bf16_to_f32(wm[(i + m) * H + jj]);
            sg[q] = sigmoid_nr(act[q]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kSpec; ++m)
        if (((i + m) & 31) == lane && ((xs >> m) & 1u))
          bits |= 1u << ((i + m) >> 5);
    }
  }
  return bits;
}

// A barrier of the `threads` threads of the warps that name barrier `id`
// (1-15; 0 is __syncthreads'); it orders their shared-memory accesses.
__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The speculative sweep split over a team of 2^(kSpec-1) warps, where the
// CTA's groups leave them idle: warp b of the team forms branch b's
// activations (act plus the W rows of b's bits, in dim order), their
// sigmoids and the partial logits of the dims i + m that read them
// (b < 2^m), one fmaf a round per dim as the sequential chain; sums its
// kSpec partials by one transposed butterfly; draws its slots' dims and
// ballots the outcomes into `words` (two buffers of 2^(kSpec-1) words, by
// the group's parity); then, after the team's barrier, every warp walks
// the kSpec draws over the words and adds the realized W rows to its own
// copy of act, the same adds in every warp. Returns the bits as sweep().
// (Keeping act in shared memory instead, written by the drawn branch's
// warp, costs a second barrier a group and was slower: PERF.md.)
template <int kSpec>
__device__ __forceinline__ uint32_t sweep_team(const float* sc,
                                               const uint16_t* vm,
                                               const uint16_t* wm, int D,
                                               int H, int lane, int b,
                                               int bar, uint32_t* words) {
  constexpr int kBranches = 1 << (kSpec - 1);
  constexpr int kShift = kSpec == 4 ? 3 : 4;    // slot m in lane m << kShift
  const int m_lane = lane >> kShift;            // this lane's slot's dim
  const int m_first = 32 - __clz(b);            // the first dim reading b
  float act[kMaxLaneRounds];
#pragma unroll
  for (int q = 0; q < kMaxLaneRounds; ++q) {
    const int jj = lane + 32 * q;
    act[q] = jj < H ? sc[2 * D + jj] : 0.f;
  }
  uint32_t bits = 0;
  for (int i = 0, n = 0; i < D; i += kSpec, ++n) {
    float part[kSpec];
#pragma unroll
    for (int m = 0; m < kSpec; ++m) part[m] = 0.f;
    // no branch in the rounds, so that their loads and sigmoids overlap
    // (a round's control flow keeps the compiler from interleaving them)
#pragma unroll
    for (int q = 0; q < kMaxLaneRounds; ++q) {
      const int jj = lane + 32 * q;
      const bool live = jj < H;
      float a = act[q];
#pragma unroll
      for (int c = 0; c + 1 < kSpec; ++c) {
        const bool on = live && ((b >> c) & 1);
        const float w = on ? bf16_to_f32(wm[(i + c) * H + jj]) : 0.f;
        a = on ? a + w : a;
      }
      const float sb = live ? sigmoid_nr(a) : 0.f;
#pragma unroll
      for (int m = 0; m < kSpec; ++m)
        part[m] = fmaf(live ? bf16_to_f32(vm[(i + m) * H + jj]) : 0.f, sb,
                       part[m]);
    }
    const float logit = warp_allsum_slots<kSpec>(part);
    const bool cand = m_lane >= m_first &&
                      sc[D + i + m_lane] < sigmoid_nr(logit + sc[i + m_lane]);
    const uint32_t won = __ballot_sync(0xffffffffu, cand);
    uint32_t* buf = words + (n & 1) * kBranches;
    if (lane == 0) buf[b] = won;
    team_sync(bar, 32 * kBranches);
    uint32_t xs = 0;                            // bit m: x_{i+m}
#pragma unroll
    for (int m = 0; m < kSpec; ++m)
      xs |= ((buf[xs] >> (m << kShift)) & 1u) << m;
    if (xs) {                                   // the same in every lane
#pragma unroll
      for (int q = 0; q < kMaxLaneRounds; ++q) {
        const int jj = lane + 32 * q;
#pragma unroll
        for (int m = 0; m < kSpec; ++m) {
          const bool on = jj < H && ((xs >> m) & 1u);
          const float w = on ? bf16_to_f32(wm[(i + m) * H + jj]) : 0.f;
          act[q] = on ? act[q] + w : act[q];
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kSpec; ++m)
      if (((i + m) & 31) == lane && ((xs >> m) & 1u))
        bits |= 1u << ((i + m) >> 5);
  }
  return bits;
}

template <bool kLstm, int kSpec, typename AuxT, bool kSliced>
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
  const AuxT* gwuh = static_cast<const AuxT*>(a.wuh);

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
      auto* dst = const_cast<AuxT*>(ct.matrix<AuxT>(kWuh, j, gwuh, 0));
      for (int o = tid; o < U * H; o += kThreads)
        dst[o] = gwuh[k * U * H + o];
    }
    if ((p.w_smem >> kWuv) & 1) {
      auto* dst =
          const_cast<uint16_t*>(ct.matrix<uint16_t>(kWuv, j, a.wuv, 0));
      for (int o = tid; o < U * D; o += kThreads)
        dst[o] = a.wuv[k * U * D + o];
    }
  }
  gen_cluster::load_state(ct, a.h0, a.c0, a.v0);   // ends with a barrier

  const gen_cluster::CellWeights<uint16_t, uint16_t, AuxT> cw{
      a.wx_v, a.wxg, static_cast<const AuxT*>(a.wx_r),
      static_cast<const AuxT*>(a.wh), a.wctx, a.b, a.g, a.given_mask};
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
        const AuxT* wuh = ct.matrix(kWuh, j, gwuh, U * H);
        sc[e] = a.bh[k * H + jj] + gen_cluster::dot(ht, wuh + jj, H, U);
      }
    }
    __syncthreads();

    // 2. the sweep: one warp per (sample, track slot), or at depth > 1 a
    //    team of 2^(depth-1) warps where the CTA holds them; the sampled
    //    frame replaces the uniforms in the scratch row. A team exchanges
    //    its ballots through the group's fresh row of this step's parity,
    //    which nothing reads until emit_frames writes it (gen_cluster.cuh).
    bool teamed = false;
    if constexpr (kSpec > 1) {
      constexpr int kBranches = 1 << (kSpec - 1);
      teamed = team_fits(NG, kSpec, D);
      const int grp = warp / kBranches, b = warp % kBranches;
      if (teamed && grp < NG) {
        const int s = grp / ct.ntr, j = grp - s * ct.ntr;
        float* sc = ct.scratch(s, j);
        const uint32_t bits = sweep_team<kSpec>(
            sc, ct.matrix(kV, j, a.v, D * H), ct.matrix(kW, j, a.w, D * H), D,
            H, lane, b, 1 + grp,
            reinterpret_cast<uint32_t*>(ct.fresh(s, j, buf)));
        for (int c = 0; b == 0 && c < nchd; ++c) {
          const int i = c * 32 + lane;
          if (i < D) sc[D + i] = (bits >> c) & 1u ? 1.f : 0.f;
        }
      }
    }
    if (!teamed) {
      for (int grp = warp; grp < NG; grp += kWarps) {
        const int s = grp / ct.ntr, j = grp - s * ct.ntr;
        float* sc = ct.scratch(s, j);
        const uint32_t bits =
            sweep<kSpec>(sc, ct.matrix(kV, j, a.v, D * H),
                         ct.matrix(kW, j, a.w, D * H), D, H, lane);
        for (int c = 0; c < nchd; ++c) {
          const int i = c * 32 + lane;
          if (i < D) sc[D + i] = (bits >> c) & 1u ? 1.f : 0.f;
        }
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
    gen_cluster::cell_stack<kLstm, true, kSliced>(ct, cw, buf);
    gen_cluster::gather_frames(ct, buf);
  }
  gen_cluster::store_state(ct, a.h_out, a.c_out);
}

// The kernel of a launch: cells, sweep depth, aux storage type and
// whether its cell stack slices the samples (gen_cluster::block_slices).
template <typename AuxT, bool kSliced>
void (*nade_kernel(bool lstm, int depth))(NadeArgs, Plan) {
  if (depth == 4)
    return lstm ? gen_fused_nade_kernel<true, 4, AuxT, kSliced>
                : gen_fused_nade_kernel<false, 4, AuxT, kSliced>;
  if (depth == 2)
    return lstm ? gen_fused_nade_kernel<true, 2, AuxT, kSliced>
                : gen_fused_nade_kernel<false, 2, AuxT, kSliced>;
  return lstm ? gen_fused_nade_kernel<true, 1, AuxT, kSliced>
              : gen_fused_nade_kernel<false, 1, AuxT, kSliced>;
}

}  // namespace

// The shared-memory plan, Wuh at its stored bytes;
// ops/gen_fused_nade.py::_sample_bytes makes the same per-sample count.
gen_cluster::Plan plan_gen_fused_nade(const NadeArgs& a, int64_t limit) {
  const int64_t dh = 2 * int64_t{a.d} * a.hid;
  const int64_t mats[kMatrices] = {dh, dh,
                                   (a.aux_bf16 ? 2 : 4) * int64_t{a.u} * a.hid,
                                   2 * int64_t{a.u} * a.d};
  return gen_cluster::make_plan(a.k, a.d, a.u, a.n_layers, nade_scratch(a),
                                mats, kMatrices, limit);
}

int nade_auto_depth(int d, int groups) {
  return d % 4 == 0 && groups == 1 && team_fits(groups, 4, d) ? 4 : 1;
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
  const bool asked = a.spec != 0;
  if (asked && ((a.spec != 1 && a.spec != 2 && a.spec != 4) || a.d % a.spec))
    return "gen_fused_nade: the speculative depth must be 1, 2 or 4 and "
           "divide D (0: auto)";
  const Plan p = plan_gen_fused_nade(a, kSmemLimitBytes);
  auto kernel = [&](int depth, bool sliced) {
    if (sliced)
      return a.aux_bf16 ? nade_kernel<uint16_t, true>(a.lstm, depth)
                        : nade_kernel<float, true>(a.lstm, depth);
    return a.aux_bf16 ? nade_kernel<uint16_t, false>(a.lstm, depth)
                      : nade_kernel<float, false>(a.lstm, depth);
  };
  // the auto depth and the slicing follow the launch's samples a cluster:
  // the plan of the launch, made without launching
  int64_t plan[kLaunchShapeFields];
  const char* err = gen_cluster::launch(kernel(1, false), a, p, a.batch,
                                        stream, plan);
  if (err != nullptr) return err;
  const int spec =
      asked ? a.spec
            : nade_auto_depth(a.d, static_cast<int>(plan[1] * plan[6]));
  const int s = static_cast<int>(plan[6]);
  const bool sliced =
      gen_cluster::block_slices(s, static_cast<int>(plan[1]) * a.g) < s;
  return gen_cluster::launch(kernel(spec, sliced), a, p, a.batch, stream,
                             shape);
}

}  // namespace multinn_torch
