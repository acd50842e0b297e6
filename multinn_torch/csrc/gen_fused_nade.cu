// Whole RNN-NADE generation in one launch: for every step t < T, every
// track k < K and every sample b < B —
//   1. conditioned biases from the top layer's previous h:
//        bv'(t) = bv + h_top Wuv,  a = bh'(t) = bh + h_top Wuh;
//   2. the ancestral sweep over the D dims, all K tracks at once:
//        s = V_i . sigmoid(a),  x_i = (u < sigmoid(s + bv'_i)),
//        a += x_i W_i,  z += x_i Wx_i  (the layer-0 input projection of the
//        fresh frame, accumulated during the sweep);
//   3. the given-track merge (accompaniment: given tracks take `given`, and
//      their z is recomputed from the given frame with f32 rows);
//   4. the stacked LSTM / vanilla advance, whose layer-0 input adds, in
//      feedback mode, the PREVIOUS frame of all tracks through Wctx;
//   5. the frame written to the roll.
//
// Replaces multinn_tpu/ops/gen_fused_nade.py::_nade_kernel (wrapper
// _generate_nade). The TPU kernel runs the T steps as a sequential grid with
// every weight in VMEM, in dim-major block rows padded to 8 tracks and 128
// lanes for Mosaic. Here, as in gen_fused_rbm.cu, ONE CTA PER SAMPLE runs
// all T steps and all K tracks with compact per-track weights read through
// L2; the sample's state rows live in shared memory (~25 KB at the flagship
// K=5, D=84, H=150, U=100).
//
// Sweep layout: the hidden lanes of each track are cut into 32-lane chunks;
// warp w owns chunks w, w + 16, ... for the whole launch, so each thread
// updates only its own lanes of a and sigmoid(a), and each dim needs ONE
// barrier (between the chunk partials and the per-track sums, which every
// thread adds in chunk order). The z lanes are owned the same way. A dim's
// V, W and Wx words are loaded one dim ahead, so their L2 latency overlaps
// the previous dim's barrier; what remains serial per dim is a shuffle
// tree, a barrier, K sigmoids and the lane updates.
//
// Numerics kept from the TPU kernel: w, v, wuv, the layer-0 own-frame Wx
// and wctx are bf16 (upcast exactly at use); a and z grow one dim at a time
// in f32 by exact adds (x is 0 or 1); the gate sum is
// ((z_acc + ctx) + h Wh) + b with ctx summed over source tracks in order.
//
// Random stream: the TPU kernel draws a (D*8, B) uniform matrix per step at
// salt seed[1] + t, so the draw of (dim i, track k, sample b) has counter
// (i*8 + k)*B + b. This kernel draws the same counters into shared memory
// before each step's sweep (K <= 8).
//
// Cost: per step, D serial dims of about one L2 round trip each (the
// shuffle, the barrier and the sigmoids), then the cell stack, whose
// dot products read Wh, Wx and Wctx one thread per output like
// gen_fused_rbm.cu (skipping the zero entries of the binary frames).
#include <cuda_runtime.h>

#include "launchers.h"
#include "reduce.cuh"
#include "threefry.cuh"

namespace multinn_torch {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// register-held weights per thread and dim (ops/gen_fused_nade.py's gate
// refuses configs beyond them): chunk rounds cover K * ceil(H/32) <= 64
// chunks, z rounds K * G <= 4096 lanes
constexpr int kChunkRounds = 4;
constexpr int kZRounds = 8;
constexpr int kStreamRows = 8;  // tracks per dim in the random stream

// Dim i's weights for this thread's chunks (V and W) and z lanes (Wx).
struct DimWeights {
  float v[kChunkRounds];
  float w[kChunkRounds];
  float x[kZRounds];
};

__device__ __forceinline__ void load_dim(const NadeArgs& a, int i, int tid,
                                         int nchunks, int wpt,
                                         DimWeights& dw) {
  const int lane = tid & 31, warp = tid >> 5;
  const int H = a.hid, D = a.d, G = a.g, KG = a.k * a.g;
#pragma unroll
  for (int r = 0; r < kChunkRounds; ++r) {
    const int c = warp + r * kWarps;
    const int k = c / wpt, j = (c - k * wpt) * 32 + lane;
    const bool ok = c < nchunks && j < H;
    const size_t idx = (static_cast<size_t>(k) * D + i) * H + j;
    dw.v[r] = ok ? bf16_to_f32(a.v[idx]) : 0.f;
    dw.w[r] = ok ? bf16_to_f32(a.w[idx]) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kZRounds; ++r) {
    const int o = tid + r * kThreads;
    const int k = o / G, g = o - k * G;
    dw.x[r] = o < KG ? bf16_to_f32(
                           a.wx_v[(static_cast<size_t>(k) * D + i) * G + g])
                     : 0.f;
  }
}

template <bool kLstm>
__global__ void __launch_bounds__(kThreads) gen_fused_nade_kernel(NadeArgs a) {
  extern __shared__ float smem[];
  const int K = a.k, D = a.d, H = a.hid, U = a.u, G = a.g, L = a.n_layers;
  const int KD = K * D, KH = K * H, KU = K * U, KG = K * G, LKU = L * KU;
  const int T = a.n_steps, B = a.batch;
  const int wpt = (H + 31) / 32, nchunks = K * wpt;
  float* h_s = smem;            // (L, K, U) cell h, layer-major
  float* c_s = h_s + LKU;       // (L, K, U) cell c
  float* v_prev = c_s + LKU;    // (K, D) previous frame
  float* v_new = v_prev + KD;   // (K, D) fresh frame
  float* bv_row = v_new + KD;   // (K, D) conditioned visible bias
  float* u_s = bv_row + KD;     // (K, D) this step's uniforms
  float* act = u_s + KD;        // (K, H) running activation a
  float* sig = act + KH;        // (K, H) sigmoid(a)
  float* z = sig + KH;          // (K, G) layer-0 input projection, then gates
  float* red = z + KG;          // (2, nchunks) chunk partials of the logits

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int o = tid; o < LKU; o += nt) {
    h_s[o] = a.h0[static_cast<size_t>(b) * LKU + o];
    c_s[o] = a.c0[static_cast<size_t>(b) * LKU + o];
  }
  for (int o = tid; o < KD; o += nt)
    v_prev[o] = a.v0[static_cast<size_t>(b) * KD + o];
  const uint32_t seed0 = static_cast<uint32_t>(a.seed[0]);
  const uint32_t seed1 = static_cast<uint32_t>(a.seed[1]);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // 1. biases from the TOP layer's previous h; a = bh', z = 0; uniforms
    const float* h_top = h_s + (L - 1) * KU;
    const uint32_t salt = seed1 + static_cast<uint32_t>(t);
    for (int o = tid; o < KD; o += nt) {
      const int k = o / D, i = o - k * D;
      const float* hk = h_top + k * U;
      const uint16_t* wk = a.wuv + static_cast<size_t>(k) * U * D + i;
      float acc = 0.f;
      for (int uu = 0; uu < U; ++uu)
        acc = fmaf(hk[uu], bf16_to_f32(wk[static_cast<size_t>(uu) * D]), acc);
      bv_row[o] = a.bv[o] + acc;
      const uint32_t ctr =
          (static_cast<uint32_t>(i) * kStreamRows + k) * static_cast<uint32_t>(B) + b;
      u_s[o] = random_uniform_at(seed0, salt, ctr);
    }
    for (int o = tid; o < KH; o += nt) {
      const int k = o / H, j = o - k * H;
      const float* hk = h_top + k * U;
      const float* wk = a.wuh + static_cast<size_t>(k) * U * H + j;
      float acc = 0.f;
      for (int uu = 0; uu < U; ++uu)
        acc = fmaf(hk[uu], wk[static_cast<size_t>(uu) * H], acc);
      const float x = a.bh[o] + acc;
      act[o] = x;
      sig[o] = sigmoid_f32(x);
    }
    for (int o = tid; o < KG; o += nt) z[o] = 0.f;
    __syncthreads();

    // 2. the sweep: dim i's weights were loaded during dim i-1
    DimWeights cur, nxt;
    load_dim(a, 0, tid, nchunks, wpt, cur);
    for (int i = 0; i < D; ++i) {
      if (i + 1 < D) load_dim(a, i + 1, tid, nchunks, wpt, nxt);
      float* rd = red + (i & 1) * nchunks;
#pragma unroll
      for (int r = 0; r < kChunkRounds; ++r) {
        const int c = warp + r * kWarps;
        if (c < nchunks) {                     // warp-uniform
          const int k = c / wpt, j = (c - k * wpt) * 32 + lane;
          const float part = warp_sum(j < H ? cur.v[r] * sig[k * H + j] : 0.f);
          if (lane == 0) rd[c] = part;
        }
      }
      __syncthreads();
      uint32_t xmask = 0;                      // bit k: track k samples 1
      for (int k = 0; k < K; ++k) {
        float s = 0.f;
        for (int q = 0; q < wpt; ++q) s += rd[k * wpt + q];
        if (u_s[k * D + i] < sigmoid_f32(s + bv_row[k * D + i]))
          xmask |= 1u << k;
      }
      if (tid < K) v_new[tid * D + i] = ((xmask >> tid) & 1u) ? 1.f : 0.f;
      if (xmask != 0) {
#pragma unroll
        for (int r = 0; r < kChunkRounds; ++r) {
          const int c = warp + r * kWarps;
          const int k = c / wpt, j = (c - k * wpt) * 32 + lane;
          if (c < nchunks && j < H && ((xmask >> k) & 1u)) {
            const float x = act[k * H + j] + cur.w[r];
            act[k * H + j] = x;
            sig[k * H + j] = sigmoid_f32(x);
          }
        }
#pragma unroll
        for (int r = 0; r < kZRounds; ++r) {
          const int o = tid + r * kThreads;
          if (o < KG && ((xmask >> (o / G)) & 1u)) z[o] += cur.x[r];
        }
      }
      if (i + 1 < D) cur = nxt;
    }
    __syncthreads();

    // 3. given merge, 5. emit the frame
    const size_t frame = (static_cast<size_t>(b) * T + t) * KD;
    for (int o = tid; o < KD; o += nt) {
      if (a.given != nullptr && ((a.given_mask >> (o / D)) & 1))
        v_new[o] = a.given[frame + o];
      a.roll[frame + o] = v_new[o];
    }
    __syncthreads();

    // 4. the cell stack: layer 0 takes z (+ the previous frame through
    //    wctx), layer l >= 1 the fresh h of layer l - 1
    for (int l = 0; l < L; ++l) {
      const float* h_l = h_s + l * KU;
      const float* h_in = h_s + (l > 0 ? l - 1 : 0) * KU;
      for (int o = tid; o < KG; o += nt) {
        const int k = o / G, gg = o - k * G;
        float zin = 0.f;
        if (l == 0) {
          if (a.given != nullptr && ((a.given_mask >> k) & 1)) {
            // the sweep's z came from discarded samples: recompute it from
            // the given frame with the f32 rows
            const float* vk = v_new + k * D;
            const float* wk = a.wxg + static_cast<size_t>(k) * D * G + gg;
            for (int i = 0; i < D; ++i) {
              const float x = vk[i];
              if (x != 0.f) zin = fmaf(x, wk[static_cast<size_t>(i) * G], zin);
            }
          } else {
            zin = z[o];
          }
          if (a.wctx != nullptr) {
            float ctx = 0.f;
            for (int j = 0; j < K; ++j) {
              float part = 0.f;
              for (int i = 0; i < D; ++i) {
                const float x = v_prev[j * D + i];
                if (x != 0.f)
                  part = fmaf(
                      x,
                      bf16_to_f32(a.wctx[static_cast<size_t>(j * D + i) * KG + o]),
                      part);
              }
              ctx += part;
            }
            zin = zin + ctx;
          }
        } else {
          const float* xk = h_in + k * U;
          const float* wk =
              a.wx_r + (static_cast<size_t>(l - 1) * K + k) * U * G + gg;
          for (int uu = 0; uu < U; ++uu)
            zin = fmaf(xk[uu], wk[static_cast<size_t>(uu) * G], zin);
        }
        const float* hk = h_l + k * U;
        const float* whk = a.wh + (static_cast<size_t>(l) * K + k) * U * G + gg;
        float rec = 0.f;
        for (int uu = 0; uu < U; ++uu)
          rec = fmaf(hk[uu], whk[static_cast<size_t>(uu) * G], rec);
        z[o] = (zin + rec) + a.b[static_cast<size_t>(l) * KG + o];
      }
      __syncthreads();
      for (int o = tid; o < KU; o += nt) {
        const int k = o / U, uu = o - k * U;
        const float* zk = z + k * G;
        if (kLstm) {
          const float c_new = sigmoid_f32(zk[U + uu]) * c_s[l * KU + o] +
                              sigmoid_f32(zk[uu]) * tanhf(zk[2 * U + uu]);
          c_s[l * KU + o] = c_new;
          h_s[l * KU + o] = sigmoid_f32(zk[3 * U + uu]) * tanhf(c_new);
        } else {
          h_s[l * KU + o] = tanhf(zk[uu]);
        }
      }
      __syncthreads();
    }
    for (int o = tid; o < KD; o += nt) v_prev[o] = v_new[o];
    __syncthreads();
  }
  for (int o = tid; o < LKU; o += nt) {
    a.h_out[static_cast<size_t>(b) * LKU + o] = h_s[o];
    a.c_out[static_cast<size_t>(b) * LKU + o] = c_s[o];
  }
}

// Dynamic shared memory of one CTA (bytes): the rows laid out at the top of
// the kernel. ops/gen_fused_nade.py::_cta_smem_bytes makes the same count.
int64_t smem_bytes(const NadeArgs& a) {
  const int64_t kd = static_cast<int64_t>(a.k) * a.d;
  const int64_t kh = static_cast<int64_t>(a.k) * a.hid;
  const int64_t lku = static_cast<int64_t>(a.n_layers) * a.k * a.u;
  const int64_t kg = static_cast<int64_t>(a.k) * a.g;
  const int64_t nchunks = static_cast<int64_t>(a.k) * ((a.hid + 31) / 32);
  return static_cast<int64_t>(sizeof(float)) *
         (2 * lku + 4 * kd + 2 * kh + kg + 2 * nchunks);
}

}  // namespace

const char* launch_gen_fused_nade(const NadeArgs& a, void* stream) {
  if (a.batch <= 0 || a.n_steps <= 0) return nullptr;
  const int64_t nchunks = static_cast<int64_t>(a.k) * ((a.hid + 31) / 32);
  if (a.k > kStreamRows || nchunks > kChunkRounds * kWarps ||
      static_cast<int64_t>(a.k) * a.g > static_cast<int64_t>(kZRounds) * kThreads)
    return "gen_fused_nade: config beyond the kernel's register-held weights "
           "or the stream's 8 tracks";
  const int64_t smem = smem_bytes(a);
  auto kernel = a.lstm ? gen_fused_nade_kernel<true>
                       : gen_fused_nade_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return cudaGetErrorString(e);
  }
  kernel<<<a.batch, kThreads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(a);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? nullptr : cudaGetErrorString(err);
}

}  // namespace multinn_torch
