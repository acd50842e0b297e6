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
// _generate_rbm). The TPU kernel runs the T steps as a sequential grid with
// every weight resident in VMEM; here the sequential loop is inside the
// CTA. The cross-track coupling (feedback context, block-diagonal RBM)
// never leaves a sample, so ONE CTA PER SAMPLE runs all T steps and all K
// tracks with no inter-CTA communication. The per-sample state rows live in
// shared memory (~23 KB at the flagship K=5, D=84, H=150, U=100); the
// weights (~5.5 MB in f32) stay in global memory and are read through L2.
//
// Random stream: the TPU kernel draws (B, K*H) and (B, K*D) uniforms per
// sweep at salts seed[1] + t*2*gen_k + 2s (+1 for v), so the draw of sample
// b, lane o has counter b*K*H + o (b*K*D + o). This kernel draws the same
// counters, so it and its plain version agree bit for bit in the stream.
//
// Cost: each step re-reads every weight once per sample (gen_k * 2 passes
// over W plus the LSTM matrices) through L2, one thread per output, each
// thread's loads issued one after another. On an H100 80GB HBM3 at 700 W a
// step takes about 0.51 ms whatever the batch up to 264 samples (two CTAs
// per SM), about 5.6 times a bandwidth estimate, so load latency rather
// than L2 bandwidth is the likely bound (not yet measured). Skipping the
// zero entries of the binary frames cuts the reads of W, Wx and Wctx
// roughly by the frame density. Independent loads in flight, a warp per
// output, and a sample's tracks split over a cluster with the weights in
// shared memory are the next design steps.
#include <cuda_runtime.h>

#include "launchers.h"
#include "threefry.cuh"

namespace multinn_torch {
namespace {

constexpr int kThreads = 512;

template <bool kLstm>
__global__ void __launch_bounds__(kThreads) gen_fused_rbm_kernel(RbmArgs a) {
  extern __shared__ float smem[];
  const int K = a.k, D = a.d, H = a.hid, U = a.u, G = a.g, L = a.n_layers;
  const int KD = K * D, KH = K * H, KU = K * U, KG = K * G, LKU = L * KU;
  const int T = a.n_steps;
  float* h_s = smem;            // (L, K, U) cell h, layer-major
  float* c_s = h_s + LKU;       // (L, K, U) cell c
  float* v_prev = c_s + LKU;    // (K, D) previous frame
  float* v = v_prev + KD;       // (K, D) chain state / fresh frame
  float* hid = v + KD;          // (K, H) hidden sample
  float* bv_row = hid + KH;     // (K, D) conditioned visible bias
  float* bh_row = bv_row + KD;  // (K, H) conditioned hidden bias
  float* z = bh_row + KH;       // (K, G) gate pre-activations

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
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
    // 1. biases from the TOP layer's previous h
    const float* h_top = h_s + (L - 1) * KU;
    for (int o = tid; o < KD; o += nt) {
      const int k = o / D, i = o - k * D;
      const float* hk = h_top + k * U;
      const float* wk = a.wuv + static_cast<size_t>(k) * U * D + i;
      float acc = 0.f;
      for (int uu = 0; uu < U; ++uu)
        acc = fmaf(hk[uu], wk[static_cast<size_t>(uu) * D], acc);
      bv_row[o] = a.bv[o] + acc;
      v[o] = v_prev[o];
    }
    for (int o = tid; o < KH; o += nt) {
      const int k = o / H, j = o - k * H;
      const float* hk = h_top + k * U;
      const float* wk = a.wuh + static_cast<size_t>(k) * U * H + j;
      float acc = 0.f;
      for (int uu = 0; uu < U; ++uu)
        acc = fmaf(hk[uu], wk[static_cast<size_t>(uu) * H], acc);
      bh_row[o] = a.bh[o] + acc;
    }
    __syncthreads();

    // 2. gen_k Gibbs sweeps, all tracks at once
    const uint32_t salt0 =
        seed1 + static_cast<uint32_t>(t) * 2u * static_cast<uint32_t>(a.gen_k);
    for (int s = 0; s < a.gen_k; ++s) {
      const uint32_t salt_h = salt0 + 2u * static_cast<uint32_t>(s);
      for (int o = tid; o < KH; o += nt) {
        const int k = o / H, j = o - k * H;
        const float* vk = v + k * D;
        const float* wk = a.w + static_cast<size_t>(k) * D * H + j;
        float acc = 0.f;
        for (int i = 0; i < D; ++i) {
          const float x = vk[i];
          if (x != 0.f) acc = fmaf(x, wk[static_cast<size_t>(i) * H], acc);
        }
        const float p = sigmoid_f32(acc + bh_row[o]);
        const float u = random_uniform_at(
            seed0, salt_h, static_cast<uint32_t>(b) * KH + o);
        hid[o] = u < p ? 1.f : 0.f;
      }
      __syncthreads();
      for (int o = tid; o < KD; o += nt) {
        const int k = o / D, i = o - k * D;
        const float* hk = hid + k * H;
        const float* wk = a.wt + static_cast<size_t>(k) * H * D + i;
        float acc = 0.f;
        for (int j = 0; j < H; ++j) {
          const float x = hk[j];
          if (x != 0.f) acc = fmaf(x, wk[static_cast<size_t>(j) * D], acc);
        }
        const float p = sigmoid_f32(acc + bv_row[o]);
        const float u = random_uniform_at(
            seed0, salt_h + 1u, static_cast<uint32_t>(b) * KD + o);
        v[o] = u < p ? 1.f : 0.f;
      }
      __syncthreads();
    }

    // 3. given merge, 5. emit the frame
    const size_t frame = (static_cast<size_t>(b) * T + t) * KD;
    for (int o = tid; o < KD; o += nt) {
      if (a.given != nullptr && ((a.given_mask >> (o / D)) & 1))
        v[o] = a.given[frame + o];
      a.roll[frame + o] = v[o];
    }
    __syncthreads();

    // 4. the cell stack: layer 0 reads the fresh frame (+ the previous
    //    frame through wctx), layer l >= 1 the fresh h of layer l - 1
    for (int l = 0; l < L; ++l) {
      const float* h_l = h_s + l * KU;
      const float* h_in = h_s + (l > 0 ? l - 1 : 0) * KU;
      for (int o = tid; o < KG; o += nt) {
        const int k = o / G, gg = o - k * G;
        float acc = 0.f;
        if (l == 0) {
          const float* vk = v + k * D;
          const float* wk = a.wx_v + static_cast<size_t>(k) * D * G + gg;
          for (int i = 0; i < D; ++i) {
            const float x = vk[i];
            if (x != 0.f) acc = fmaf(x, wk[static_cast<size_t>(i) * G], acc);
          }
        } else {
          const float* xk = h_in + k * U;
          const float* wk =
              a.wx_r + (static_cast<size_t>(l - 1) * K + k) * U * G + gg;
          for (int uu = 0; uu < U; ++uu)
            acc = fmaf(xk[uu], wk[static_cast<size_t>(uu) * G], acc);
        }
        const float* hk = h_l + k * U;
        const float* whk = a.wh + (static_cast<size_t>(l) * K + k) * U * G + gg;
        float rec = 0.f;
        for (int uu = 0; uu < U; ++uu)
          rec = fmaf(hk[uu], whk[static_cast<size_t>(uu) * G], rec);
        float zz = (acc + rec) + a.b[static_cast<size_t>(l) * KG + o];
        if (l == 0 && a.wctx != nullptr) {
          float ctx = 0.f;
          for (int r = 0; r < KD; ++r) {
            const float x = v_prev[r];
            if (x != 0.f)
              ctx = fmaf(x, a.wctx[static_cast<size_t>(r) * KG + o], ctx);
          }
          zz += ctx;
        }
        z[o] = zz;
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
    for (int o = tid; o < KD; o += nt) v_prev[o] = v[o];
    __syncthreads();
  }
  for (int o = tid; o < LKU; o += nt) {
    a.h_out[static_cast<size_t>(b) * LKU + o] = h_s[o];
    a.c_out[static_cast<size_t>(b) * LKU + o] = c_s[o];
  }
}

// Dynamic shared memory of one CTA (bytes): the rows laid out at the top of
// the kernel. ops/gen_fused_rbm.py::_cta_smem_bytes makes the same count.
int64_t smem_bytes(const RbmArgs& a) {
  const int64_t kd = static_cast<int64_t>(a.k) * a.d;
  const int64_t kh = static_cast<int64_t>(a.k) * a.hid;
  const int64_t lku = static_cast<int64_t>(a.n_layers) * a.k * a.u;
  const int64_t kg = static_cast<int64_t>(a.k) * a.g;
  return static_cast<int64_t>(sizeof(float)) *
         (2 * lku + 3 * kd + 2 * kh + kg);
}

}  // namespace

const char* launch_gen_fused_rbm(const RbmArgs& a, void* stream) {
  if (a.batch <= 0 || a.n_steps <= 0) return nullptr;
  const int64_t smem = smem_bytes(a);
  auto kernel = a.lstm ? gen_fused_rbm_kernel<true>
                       : gen_fused_rbm_kernel<false>;
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
