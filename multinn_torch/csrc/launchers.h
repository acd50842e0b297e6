// Host-side launchers of the port's CUDA kernels.
//
// Plain pointers and sizes in, the launch's error string out (nullptr on
// success). Neither CUDA nor PyTorch headers appear here, so the PyTorch
// binding (ops.cpp) and the kernels (*.cu) compile without each other's
// headers. Every launcher enqueues on the stream it is given and never
// synchronises; outputs are allocated by the Python wrapper.
#pragma once

#include <cstdint>

namespace multinn_torch {

// Dynamic shared memory one CTA may use on Hopper (232,448 bytes).
constexpr int64_t kSmemLimitBytes = 227 * 1024;

// y = Threefry-2x32-20(key, (x0, x1)) elementwise over n counters.
const char* launch_threefry2x32(const int32_t* key, const int32_t* x0,
                                const int32_t* x1, int32_t* y0, int32_t* y1,
                                int64_t n, void* stream);

// k sweeps of block Gibbs over n rows (see gibbs_chain.cu) under the launch
// plan (rows per CTA, threads, lanes per dot, W in shared memory 1 / in
// device memory 0) of ops/gibbs_cuda.launch_plan. The row map: the launch
// holds rows row0 .. row0 + rows_loc - 1 of each group of rows_glob rows of
// the launch whose stream it draws ((0, n, n): its own).
const char* launch_gibbs_chain(const float* v0, const float* w,
                               const float* bv, const float* bh,
                               const int32_t* seed, float* out, int64_t n,
                               int64_t d, int64_t h, int64_t k, int64_t bb,
                               int64_t row0, int64_t rows_loc,
                               int64_t rows_glob, int64_t rows_per_cta,
                               int64_t threads, int64_t lanes, int64_t w_smem,
                               void* stream);

// Inputs of the whole-generation RNN-RBM kernel (see gen_fused_rbm.cu and
// multinn_torch/ops/gen_fused_rbm.py::_rbm_args for the layouts). w, wuv,
// wuh and wctx are f32, or with w_bf16 all four bf16 words.
struct RbmArgs {
  const void* w;        // (K, D, H)
  const void* wuv;      // (K, U, D)
  const void* wuh;      // (K, U, H)
  const float* bv;      // (K*D)
  const float* bh;      // (K*H)
  const float* wx_v;    // (K, D, G)
  const float* wx_r;    // (L-1, K, U, G), or nullptr when L == 1
  const float* wh;      // (L, K, U, G)
  const void* wctx;     // (K*D, K*G), or nullptr without feedback context
  const float* b;       // (L, K*G)
  const float* h0;      // (B, L*K*U)
  const float* c0;      // (B, L*K*U)
  const float* v0;      // (B, K*D)
  const float* given;   // (B, T, K*D), or nullptr
  const int32_t* seed;  // (2,) the Threefry key words
  float* roll;          // (B, T, K*D)
  float* h_out;         // (B, L*K*U)
  float* c_out;         // (B, L*K*U)
  int32_t batch, n_steps, gen_k;
  int32_t k, d, hid, u, g, n_layers;
  int32_t lstm;         // 1: LSTM cells (g = 4u); 0: vanilla tanh (g = u)
  int32_t w_bf16;       // 1: the bf16 capacity mode (w, wuv, wuh, wctx)
  int32_t given_mask;   // bit k set: track k takes `given`
  int32_t row0;         // the row map: sample b draws the stream of sample
  int32_t rows_total;   //   row0 + b of a batch of rows_total (0, batch)
};

// The whole-generation launchers (RBM and NADE) take `shape`: nullptr
// launches the kernel; otherwise nothing is launched and shape receives
// the launch's plan for a.batch (only the sizes of `a` and its storage
// flag, w_bf16 / aux_bf16, are read): CTAs
// per cluster, track slots per CTA, the bit set of per-step weight
// matrices held in shared memory, the bytes of that weight region and of
// one sample's state, the most samples the shared memory holds, the
// samples per cluster, the clusters of the grid and the clusters the card
// holds at once.
constexpr int kLaunchShapeFields = 9;

const char* launch_gen_fused_rbm(const RbmArgs& a, void* stream,
                                 int64_t* shape = nullptr);

// Outputs R a thread of the RBM kernel's Gibbs passes takes, for a launch
// of `groups` (sample, track slot) groups per CTA: 3 where that gives
// fewer rounds of both passes (ceil(chunks of 32 units / R) warps a group,
// on the CTA's 16 warps) than 1, else 1. One sample a cluster takes 1; the
// flagship's B=256 (11 or 12 samples a cluster) 3.
int rbm_outputs_per_thread(int groups, int d, int h);

// NADE ancestral sampling sweep over n rows with per-row biases (see
// nade_sample.cu), one CTA a row, under the plan of
// ops/nade_cuda.sample_plan: W and V staged in shared memory (1; both must
// be 16-byte aligned) or read from L2 (0). Row b draws the stream of row
// row0 + b of rows_total rows ((0, n): its own).
const char* launch_nade_sample(const float* w, const float* v,
                               const float* bv, const float* bh,
                               const int32_t* seed, float* out, int64_t n,
                               int64_t d, int64_t h, int64_t staged,
                               int64_t row0, int64_t rows_total,
                               void* stream);

// Inputs of the whole-generation RNN-NADE kernel (see gen_fused_nade.cu and
// multinn_torch/ops/gen_fused_nade.py::_nade_args for the layouts). bf16
// matrices are passed as their 16-bit words; wuh, wx_r and wh are f32, or
// with aux_bf16 all three bf16 (the aux capacity mode).
struct NadeArgs {
  const uint16_t* w;     // (K, D, H) bf16 NADE encode weights
  const uint16_t* v;     // (K, D, H) bf16 NADE decode weights
  const uint16_t* wuv;   // (K, U, D) bf16 visible-bias conditioning
  const void* wuh;       // (K, U, H)
  const float* bv;       // (K*D)
  const float* bh;       // (K*H)
  const uint16_t* wx_v;  // (K, D, G) bf16 layer-0 own-frame input projection
  const float* wxg;      // (K, D, G) the same rows in f32 (given merge), or
                         //   nullptr without given tracks
  const void* wx_r;      // (L-1, K, U, G), or nullptr when L == 1
  const void* wh;        // (L, K, U, G)
  const uint16_t* wctx;  // (K*D, K*G) bf16, or nullptr without feedback
  const float* b;        // (L, K*G)
  const float* h0;       // (B, L*K*U)
  const float* c0;       // (B, L*K*U)
  const float* v0;       // (B, K*D)
  const float* given;    // (B, T, K*D), or nullptr
  const int32_t* seed;   // (2,) the Threefry key words
  float* roll;           // (B, T, K*D)
  float* h_out;          // (B, L*K*U)
  float* c_out;          // (B, L*K*U)
  int32_t batch, n_steps;
  int32_t k, d, hid, u, g, n_layers;
  int32_t lstm;          // 1: LSTM cells (g = 4u); 0: vanilla tanh (g = u)
  int32_t aux_bf16;      // 1: the bf16 aux capacity mode (wuh, wx_r, wh)
  int32_t given_mask;    // bit k set: track k takes `given`
  int32_t spec;          // the sweep's speculative depth: 1, 2 or 4
                         //   dividing D; 0: auto (4 if 4 divides D)
  int32_t row0;          // the row map: sample b draws the stream of sample
  int32_t rows_total;    //   row0 + b of a batch of rows_total (0, batch)
};

const char* launch_gen_fused_nade(const NadeArgs& a, void* stream,
                                  int64_t* shape = nullptr);

// The NADE sweep's auto depth for a launch of `groups` (sample, track
// slot) groups per CTA: 4 where 4 divides D and one group's team of 8
// warps has the CTA to itself, else 1.
int nade_auto_depth(int d, int groups);

// Rows per tile of the NADE likelihood kernels, which walk the tiles with
// persistent grids (ops/nade_ll.fwd_plan, bwd_plan).
constexpr int kNadeLLTileRows = 32;

// Teacher-forced NADE logits of k tracks x n rows (see nade_ll.cu): x, bv,
// logits (k, n, d); bh, a_end (k, n, h); w, v (k, d, h). The plan: n_ctas
// CTAs per track and hidden chunk of `chunk` lanes; with more than one
// chunk, part (chunks, k, n, d) holds their partial logits, else nullptr.
const char* launch_nade_ll_fwd(const float* x, const float* w, const float* v,
                               const float* bv, const float* bh,
                               float* logits, float* part, float* a_end,
                               int64_t k, int64_t n, int64_t d, int64_t h,
                               int64_t n_ctas, int64_t chunk, void* stream);

// Its reverse sweep from a_end for the logits' cotangent g (k, n, d), on
// n_ctas CTAs per track and hidden chunk: dw, dv (k, d, h) through the
// per-CTA partials dw_part, dv_part (k, n_ctas, d, h); dx (k, n, d), or
// nullptr when no input gradient is wanted, through dx_part (chunks, k, n,
// d) when there is more than one chunk; dbh (k, n, h).
const char* launch_nade_ll_bwd(const float* x, const float* w, const float* v,
                               const float* g, const float* a_end,
                               float* dw_part, float* dv_part, float* dw,
                               float* dv, float* dx, float* dx_part,
                               float* dbh, int64_t k, int64_t n, int64_t d,
                               int64_t h, int64_t n_ctas, int64_t chunk,
                               void* stream);

// The LSTM recurrence of one layer over t steps (see lstm_scan.cu), for k
// tracks x n rows of u <= 256 units: xz (t, k, n, 4u); wf, the forward's
// gate-interleaved Wh (k, u', u, 4); h0, c0 (k, n, u); out: hbuf, cbuf
// (t + 1, k, n, u), slot 0 the initial state, and the pre-activations zbuf
// (t, k, n, 4u), or nullptr for none. The plan of
// ops/lstm_scan.launch_plan: rows per CTA (1-4), Wh staged in shared
// memory (1) or read from device memory (0).
const char* launch_lstm_scan_fwd(const float* xz, const float* wf,
                                 const float* h0, const float* c0,
                                 float* hbuf, float* cbuf, float* zbuf,
                                 int64_t t, int64_t k, int64_t n, int64_t u,
                                 int64_t rows, int64_t w_smem, void* stream);

// Its reverse recurrence under the same plan: z (t, k, n, 4u), the
// pre-activations the forward kept; wb, the backward's gate-interleaved Wh
// (k, u, u', 4); cbuf as the forward wrote it; dhbuf, dcbuf (t + 1, k, n,
// u), the carries' gradients, or nullptr for none; out: dz (t, k, n, 4u),
// dh0, dc0 (k, n, u).
const char* launch_lstm_scan_bwd(const float* z, const float* wb,
                                 const float* cbuf, const float* dhbuf,
                                 const float* dcbuf, float* dz, float* dh0,
                                 float* dc0, int64_t t, int64_t k, int64_t n,
                                 int64_t u, int64_t rows, int64_t w_smem,
                                 void* stream);

}  // namespace multinn_torch
