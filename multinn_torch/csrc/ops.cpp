// PyTorch binding of the port's CUDA kernels: registers them as
// torch.ops.multinn_torch.* (TORCH_LIBRARY, loaded with
// torch.ops.load_library — no pybind, no Python.h). Each op checks what its
// kernel takes and writes into outputs the Python wrapper allocated; the
// stream is the caller's current CUDA stream, passed as an integer.
#include <ATen/core/Tensor.h>
#include <torch/library.h>

#include <initializer_list>
#include <utility>
#include <vector>

#include "launchers.h"

namespace multinn_torch {
namespace {

void check(const at::Tensor& t, c10::ScalarType dtype, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == dtype, name, " must be ", dtype, ", got ",
              t.scalar_type());
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

// An absent optional input is passed as an empty tensor.
const float* optional_f32(const at::Tensor& t, const char* name) {
  if (t.numel() == 0) return nullptr;
  check(t, at::kFloat, name);
  return t.data_ptr<float>();
}

// An output the caller did not ask for is passed as an empty tensor.
float* optional_out(at::Tensor& t, const char* name) {
  if (t.numel() == 0) return nullptr;
  check(t, at::kFloat, name);
  return t.data_ptr<float>();
}

// The storage of a capacity-mode weight group: every tensor of `group`
// (empty ones skipped: absent optional inputs) is a contiguous CUDA tensor
// of the first one's dtype, float32 or bfloat16. Returns 1 for bfloat16.
int32_t storage_bf16(std::initializer_list<std::pair<const at::Tensor*,
                                                     const char*>> group,
                     const char* op) {
  const at::ScalarType dtype = group.begin()->first->scalar_type();
  TORCH_CHECK(dtype == at::kFloat || dtype == at::kBFloat16, op, ": ",
              group.begin()->second, " must be float32 or bfloat16, got ",
              dtype);
  for (auto [t, name] : group)
    if (t->numel() != 0) check(*t, dtype, name);
  return dtype == at::kBFloat16;
}

void raise_on(const char* err, const char* op) {
  TORCH_CHECK(err == nullptr, op, ": kernel launch failed: ", err);
}

void* as_stream(int64_t s) { return reinterpret_cast<void*>(s); }

void threefry2x32(at::Tensor y0, at::Tensor y1, const at::Tensor& key,
                  const at::Tensor& x0, const at::Tensor& x1,
                  int64_t stream) {
  for (auto* p : {&y0, &y1}) check(*p, at::kInt, "y");
  check(key, at::kInt, "key");
  check(x0, at::kInt, "x0");
  check(x1, at::kInt, "x1");
  TORCH_CHECK(key.numel() == 2, "key must hold 2 words");
  const int64_t n = x0.numel();
  TORCH_CHECK(x1.numel() == n && y0.numel() == n && y1.numel() == n,
              "threefry2x32: counter and output sizes differ");
  raise_on(launch_threefry2x32(key.data_ptr<int32_t>(), x0.data_ptr<int32_t>(),
                               x1.data_ptr<int32_t>(), y0.data_ptr<int32_t>(),
                               y1.data_ptr<int32_t>(), n, as_stream(stream)),
           "threefry2x32");
}

void gibbs_chain(at::Tensor out, const at::Tensor& v0, const at::Tensor& w,
                 const at::Tensor& bv, const at::Tensor& bh,
                 const at::Tensor& seed, int64_t k, int64_t bb,
                 int64_t row0, int64_t rows_loc, int64_t rows_glob,
                 int64_t rows_per_cta, int64_t threads, int64_t lanes,
                 int64_t w_smem, int64_t stream) {
  check(out, at::kFloat, "out");
  check(v0, at::kFloat, "v0");
  check(w, at::kFloat, "w");
  check(bv, at::kFloat, "bv");
  check(bh, at::kFloat, "bh");
  check(seed, at::kInt, "seed");
  TORCH_CHECK(w.dim() == 2 && v0.dim() == 2, "gibbs_chain: v0, w must be 2D");
  const int64_t n = v0.size(0), d = w.size(0), h = w.size(1);
  TORCH_CHECK(v0.size(1) == d && out.sizes() == v0.sizes() &&
                  bv.numel() == n * d && bh.numel() == n * h &&
                  seed.numel() == 2 && bb > 0 && k >= 0 && d > 0 && h > 0,
              "gibbs_chain: inconsistent shapes");
  TORCH_CHECK(rows_per_cta > 0 && threads > 0 && lanes > 0,
              "gibbs_chain: the launch plan must be positive");
  raise_on(launch_gibbs_chain(v0.data_ptr<float>(), w.data_ptr<float>(),
                              bv.data_ptr<float>(), bh.data_ptr<float>(),
                              seed.data_ptr<int32_t>(), out.data_ptr<float>(),
                              n, d, h, k, bb, row0, rows_loc, rows_glob,
                              rows_per_cta, threads, lanes, w_smem,
                              as_stream(stream)),
           "gibbs_chain");
}

void gen_fused_rbm(at::Tensor roll, at::Tensor h_out, at::Tensor c_out,
                   const at::Tensor& w, const at::Tensor& wuv,
                   const at::Tensor& wuh,
                   const at::Tensor& bv, const at::Tensor& bh,
                   const at::Tensor& wx_v, const at::Tensor& wx_r,
                   const at::Tensor& wh, const at::Tensor& wctx,
                   const at::Tensor& b, const at::Tensor& h0,
                   const at::Tensor& c0, const at::Tensor& v0,
                   const at::Tensor& given, const at::Tensor& seed,
                   int64_t gen_k, int64_t lstm, int64_t given_mask,
                   int64_t row0, int64_t rows_total, int64_t stream) {
  check(roll, at::kFloat, "roll");
  check(h_out, at::kFloat, "h_out");
  check(c_out, at::kFloat, "c_out");
  for (auto [t, name] : {std::pair<const at::Tensor*, const char*>{&bv, "bv"},
                         {&bh, "bh"}, {&wx_v, "wx_v"}, {&wh, "wh"}, {&b, "b"},
                         {&h0, "h0"}, {&c0, "c0"}, {&v0, "v0"}})
    check(*t, at::kFloat, name);
  check(seed, at::kInt, "seed");
  TORCH_CHECK(w.dim() == 3 && wuv.dim() == 3 && wx_v.dim() == 3 &&
                  wh.dim() == 4 && roll.dim() == 3,
              "gen_fused_rbm: unexpected ranks");
  RbmArgs a{};
  // the storage mode: W, Wuv, Wuh and Wctx all f32 or all bf16
  a.w_bf16 = storage_bf16(
      {{&w, "w"}, {&wuv, "wuv"}, {&wuh, "wuh"}, {&wctx, "wctx"}},
      "gen_fused_rbm");
  a.k = static_cast<int32_t>(w.size(0));
  a.d = static_cast<int32_t>(w.size(1));
  a.hid = static_cast<int32_t>(w.size(2));
  a.u = static_cast<int32_t>(wuv.size(1));
  a.g = static_cast<int32_t>(wx_v.size(2));
  a.n_layers = static_cast<int32_t>(wh.size(0));
  a.batch = static_cast<int32_t>(h0.size(0));
  a.n_steps = static_cast<int32_t>(roll.size(1));
  a.gen_k = static_cast<int32_t>(gen_k);
  a.lstm = static_cast<int32_t>(lstm);
  a.given_mask = static_cast<int32_t>(given_mask);
  a.row0 = static_cast<int32_t>(row0);
  a.rows_total = static_cast<int32_t>(rows_total);
  const int64_t kd = int64_t{a.k} * a.d, lku = int64_t{a.n_layers} * a.k * a.u;
  TORCH_CHECK(a.g == (lstm ? 4 * a.u : a.u), "gen_fused_rbm: gate width");
  TORCH_CHECK(roll.size(0) == a.batch && roll.size(2) == kd &&
                  h0.numel() == a.batch * lku && c0.numel() == a.batch * lku &&
                  h_out.numel() == a.batch * lku &&
                  c_out.numel() == a.batch * lku &&
                  v0.numel() == a.batch * kd && seed.numel() == 2,
              "gen_fused_rbm: inconsistent shapes");
  TORCH_CHECK(a.n_layers == 1 || wx_r.numel() == int64_t{a.n_layers - 1} *
                                                     a.k * a.u * a.g,
              "gen_fused_rbm: wx_r shape");
  TORCH_CHECK(given.numel() == 0 || given.numel() == roll.numel(),
              "gen_fused_rbm: given shape");
  a.w = w.data_ptr();
  a.wuv = wuv.data_ptr();
  a.wuh = wuh.data_ptr();
  a.bv = bv.data_ptr<float>();
  a.bh = bh.data_ptr<float>();
  a.wx_v = wx_v.data_ptr<float>();
  a.wx_r = optional_f32(wx_r, "wx_r");
  a.wh = wh.data_ptr<float>();
  a.wctx = wctx.numel() == 0 ? nullptr : wctx.data_ptr();
  a.b = b.data_ptr<float>();
  a.h0 = h0.data_ptr<float>();
  a.c0 = c0.data_ptr<float>();
  a.v0 = v0.data_ptr<float>();
  a.given = optional_f32(given, "given");
  a.seed = seed.data_ptr<int32_t>();
  a.roll = roll.data_ptr<float>();
  a.h_out = h_out.data_ptr<float>();
  a.c_out = c_out.data_ptr<float>();
  raise_on(launch_gen_fused_rbm(a, as_stream(stream)), "gen_fused_rbm");
}

void nade_sample(at::Tensor out, const at::Tensor& w, const at::Tensor& v,
                 const at::Tensor& bv, const at::Tensor& bh,
                 const at::Tensor& seed, int64_t staged, int64_t row0,
                 int64_t rows_total, int64_t stream) {
  check(out, at::kFloat, "out");
  check(w, at::kFloat, "w");
  check(v, at::kFloat, "v");
  check(bv, at::kFloat, "bv");
  check(bh, at::kFloat, "bh");
  check(seed, at::kInt, "seed");
  TORCH_CHECK(w.dim() == 2 && bv.dim() == 2, "nade_sample: w, bv must be 2D");
  const int64_t n = bv.size(0), d = w.size(0), h = w.size(1);
  TORCH_CHECK(v.sizes() == w.sizes() && bv.size(1) == d &&
                  bh.numel() == n * h && out.sizes() == bv.sizes() &&
                  seed.numel() == 2,
              "nade_sample: inconsistent shapes");
  raise_on(launch_nade_sample(w.data_ptr<float>(), v.data_ptr<float>(),
                              bv.data_ptr<float>(), bh.data_ptr<float>(),
                              seed.data_ptr<int32_t>(), out.data_ptr<float>(),
                              n, d, h, staged, row0, rows_total,
                              as_stream(stream)),
           "nade_sample");
}

const uint16_t* bf16_words(const at::Tensor& t, const char* name) {
  check(t, at::kBFloat16, name);
  return reinterpret_cast<const uint16_t*>(t.data_ptr());
}

void gen_fused_nade(at::Tensor roll, at::Tensor h_out, at::Tensor c_out,
                    const at::Tensor& w, const at::Tensor& v,
                    const at::Tensor& wuv, const at::Tensor& wuh,
                    const at::Tensor& bv, const at::Tensor& bh,
                    const at::Tensor& wx_v, const at::Tensor& wxg,
                    const at::Tensor& wx_r, const at::Tensor& wh,
                    const at::Tensor& wctx, const at::Tensor& b,
                    const at::Tensor& h0, const at::Tensor& c0,
                    const at::Tensor& v0, const at::Tensor& given,
                    const at::Tensor& seed, int64_t lstm, int64_t spec,
                    int64_t given_mask, int64_t row0, int64_t rows_total,
                    int64_t stream) {
  check(roll, at::kFloat, "roll");
  check(h_out, at::kFloat, "h_out");
  check(c_out, at::kFloat, "c_out");
  for (auto [t, name] : {std::pair<const at::Tensor*, const char*>{&bv, "bv"},
                         {&bh, "bh"}, {&b, "b"}, {&h0, "h0"}, {&c0, "c0"},
                         {&v0, "v0"}})
    check(*t, at::kFloat, name);
  check(seed, at::kInt, "seed");
  TORCH_CHECK(w.dim() == 3 && wuv.dim() == 3 && wx_v.dim() == 3 &&
                  wh.dim() == 4 && roll.dim() == 3,
              "gen_fused_nade: unexpected ranks");
  NadeArgs a{};
  // the aux storage mode: Wuh, Wh and Wx_r all f32 or all bf16
  a.aux_bf16 = storage_bf16({{&wuh, "wuh"}, {&wh, "wh"}, {&wx_r, "wx_r"}},
                            "gen_fused_nade");
  a.k = static_cast<int32_t>(w.size(0));
  a.d = static_cast<int32_t>(w.size(1));
  a.hid = static_cast<int32_t>(w.size(2));
  a.u = static_cast<int32_t>(wuv.size(1));
  a.g = static_cast<int32_t>(wx_v.size(2));
  a.n_layers = static_cast<int32_t>(wh.size(0));
  a.batch = static_cast<int32_t>(h0.size(0));
  a.n_steps = static_cast<int32_t>(roll.size(1));
  a.lstm = static_cast<int32_t>(lstm);
  a.spec = static_cast<int32_t>(spec);
  a.given_mask = static_cast<int32_t>(given_mask);
  a.row0 = static_cast<int32_t>(row0);
  a.rows_total = static_cast<int32_t>(rows_total);
  const int64_t kd = int64_t{a.k} * a.d, lku = int64_t{a.n_layers} * a.k * a.u;
  TORCH_CHECK(a.g == (lstm ? 4 * a.u : a.u), "gen_fused_nade: gate width");
  TORCH_CHECK(v.sizes() == w.sizes() && roll.size(0) == a.batch &&
                  roll.size(2) == kd && h0.numel() == a.batch * lku &&
                  c0.numel() == a.batch * lku &&
                  h_out.numel() == a.batch * lku &&
                  c_out.numel() == a.batch * lku &&
                  v0.numel() == a.batch * kd && seed.numel() == 2,
              "gen_fused_nade: inconsistent shapes");
  TORCH_CHECK(a.n_layers == 1 || wx_r.numel() == int64_t{a.n_layers - 1} *
                                                     a.k * a.u * a.g,
              "gen_fused_nade: wx_r shape");
  TORCH_CHECK(given.numel() == 0 ||
                  (given.numel() == roll.numel() && wxg.numel() == wx_v.numel()),
              "gen_fused_nade: given / wxg shape");
  a.w = bf16_words(w, "w");
  a.v = bf16_words(v, "v");
  a.wuv = bf16_words(wuv, "wuv");
  a.wuh = wuh.data_ptr();
  a.bv = bv.data_ptr<float>();
  a.bh = bh.data_ptr<float>();
  a.wx_v = bf16_words(wx_v, "wx_v");
  a.wxg = optional_f32(wxg, "wxg");
  a.wx_r = wx_r.numel() == 0 ? nullptr : wx_r.data_ptr();
  a.wh = wh.data_ptr();
  a.wctx = wctx.numel() == 0 ? nullptr : bf16_words(wctx, "wctx");
  a.b = b.data_ptr<float>();
  a.h0 = h0.data_ptr<float>();
  a.c0 = c0.data_ptr<float>();
  a.v0 = v0.data_ptr<float>();
  a.given = optional_f32(given, "given");
  a.seed = seed.data_ptr<int32_t>();
  a.roll = roll.data_ptr<float>();
  a.h_out = h_out.data_ptr<float>();
  a.c_out = c_out.data_ptr<float>();
  raise_on(launch_gen_fused_nade(a, as_stream(stream)), "gen_fused_nade");
}

// The launch plan a whole-generation kernel (nade: 0 the RBM, 1 the NADE)
// makes for these sizes and storage (bf16: the RBM's wdtype or the NADE's
// aux dtype is bfloat16), without launching it: the kLaunchShapeFields
// values of launchers.h, then for the NADE the depth its sweep runs at the
// auto depth (nade_auto_depth of the plan's groups per CTA), for the RBM
// the outputs a thread of its Gibbs passes takes (rbm_outputs_per_thread).
std::vector<int64_t> gen_fused_plan(int64_t nade, int64_t k, int64_t d,
                                    int64_t hid, int64_t u, int64_t n_layers,
                                    int64_t lstm, int64_t batch,
                                    int64_t bf16) {
  std::vector<int64_t> shape(kLaunchShapeFields, 0);
  TORCH_CHECK(batch > 0, "gen_fused_plan: batch must be positive");
  auto sizes = [&](auto& a) {
    a.k = static_cast<int32_t>(k);
    a.d = static_cast<int32_t>(d);
    a.hid = static_cast<int32_t>(hid);
    a.u = static_cast<int32_t>(u);
    a.g = static_cast<int32_t>(lstm ? 4 * u : u);
    a.n_layers = static_cast<int32_t>(n_layers);
    a.lstm = static_cast<int32_t>(lstm);
    a.batch = static_cast<int32_t>(batch);
    a.rows_total = static_cast<int32_t>(batch);
    a.n_steps = 1;
  };
  const char* err;
  if (nade) {
    NadeArgs a{};
    sizes(a);
    a.aux_bf16 = static_cast<int32_t>(bf16 != 0);
    err = launch_gen_fused_nade(a, nullptr, shape.data());
    if (err == nullptr)                  // track slots x samples per cluster
      shape.push_back(
          nade_auto_depth(a.d, static_cast<int>(shape[1] * shape[6])));
  } else {
    RbmArgs a{};
    sizes(a);
    a.w_bf16 = static_cast<int32_t>(bf16 != 0);
    err = launch_gen_fused_rbm(a, nullptr, shape.data());
    if (err == nullptr)                  // track slots x samples per cluster
      shape.push_back(rbm_outputs_per_thread(
          static_cast<int>(shape[1] * shape[6]), a.d, a.hid));
  }
  raise_on(err, "gen_fused_plan");
  return shape;
}

void nade_ll_fwd(at::Tensor logits, at::Tensor a_end, at::Tensor part,
                 const at::Tensor& x, const at::Tensor& w,
                 const at::Tensor& v, const at::Tensor& bv,
                 const at::Tensor& bh, int64_t n_ctas, int64_t chunk,
                 int64_t stream) {
  check(logits, at::kFloat, "logits");
  check(a_end, at::kFloat, "a_end");
  check(x, at::kFloat, "x");
  check(w, at::kFloat, "w");
  check(v, at::kFloat, "v");
  check(bv, at::kFloat, "bv");
  check(bh, at::kFloat, "bh");
  TORCH_CHECK(x.dim() == 3 && w.dim() == 3, "nade_ll_fwd: x, w must be 3D");
  const int64_t k = w.size(0), n = x.size(1), d = w.size(1), h = w.size(2);
  TORCH_CHECK(x.size(0) == k && x.size(2) == d && v.sizes() == w.sizes() &&
                  bv.sizes() == x.sizes() && logits.sizes() == x.sizes() &&
                  bh.dim() == 3 && bh.size(0) == k && bh.size(1) == n &&
                  bh.size(2) == h && a_end.sizes() == bh.sizes(),
              "nade_ll_fwd: inconsistent shapes");
  TORCH_CHECK(chunk > 0, "nade_ll_fwd: the hidden chunk must be positive");
  const int64_t n_chunks = (h + chunk - 1) / chunk;
  TORCH_CHECK(n_chunks == 1 ? part.numel() == 0
                            : part.numel() == n_chunks * x.numel(),
              "nade_ll_fwd: part must be empty or (chunks, k, n, d)");
  raise_on(launch_nade_ll_fwd(x.data_ptr<float>(), w.data_ptr<float>(),
                              v.data_ptr<float>(), bv.data_ptr<float>(),
                              bh.data_ptr<float>(), logits.data_ptr<float>(),
                              optional_out(part, "part"),
                              a_end.data_ptr<float>(), k, n, d, h, n_ctas,
                              chunk, as_stream(stream)),
           "nade_ll_fwd");
}

void nade_ll_bwd(at::Tensor dw, at::Tensor dv, at::Tensor dx, at::Tensor dbh,
                 at::Tensor dw_part, at::Tensor dv_part, at::Tensor dx_part,
                 const at::Tensor& x, const at::Tensor& w,
                 const at::Tensor& v, const at::Tensor& g,
                 const at::Tensor& a_end, int64_t chunk, int64_t stream) {
  for (auto [t, name] : {std::pair<const at::Tensor*, const char*>{&dw, "dw"},
                         {&dv, "dv"}, {&dbh, "dbh"}, {&dw_part, "dw_part"},
                         {&dv_part, "dv_part"}, {&x, "x"}, {&w, "w"},
                         {&v, "v"}, {&g, "g"}, {&a_end, "a_end"}})
    check(*t, at::kFloat, name);
  TORCH_CHECK(x.dim() == 3 && w.dim() == 3, "nade_ll_bwd: x, w must be 3D");
  const int64_t k = w.size(0), n = x.size(1), d = w.size(1), h = w.size(2);
  // the partials' second dim is the launch plan's CTAs per track
  TORCH_CHECK(x.size(0) == k && x.size(2) == d && v.sizes() == w.sizes() &&
                  g.sizes() == x.sizes() && dw.sizes() == w.sizes() &&
                  dv.sizes() == w.sizes() && a_end.dim() == 3 &&
                  a_end.size(0) == k && a_end.size(1) == n &&
                  a_end.size(2) == h && dbh.sizes() == a_end.sizes() &&
                  dw_part.dim() == 4 && dw_part.size(0) == k &&
                  dw_part.size(1) >= 1 && dw_part.size(2) == d &&
                  dw_part.size(3) == h && dv_part.sizes() == dw_part.sizes(),
              "nade_ll_bwd: inconsistent shapes");
  TORCH_CHECK(dx.numel() == 0 || dx.sizes() == x.sizes(),
              "nade_ll_bwd: dx must be empty or x's shape");
  TORCH_CHECK(chunk > 0, "nade_ll_bwd: the hidden chunk must be positive");
  const int64_t n_chunks = (h + chunk - 1) / chunk;
  TORCH_CHECK((dx.numel() == 0 || n_chunks == 1)
                  ? dx_part.numel() == 0
                  : dx_part.numel() == n_chunks * x.numel(),
              "nade_ll_bwd: dx_part must be empty or (chunks, k, n, d)");
  raise_on(launch_nade_ll_bwd(x.data_ptr<float>(), w.data_ptr<float>(),
                              v.data_ptr<float>(), g.data_ptr<float>(),
                              a_end.data_ptr<float>(),
                              dw_part.data_ptr<float>(),
                              dv_part.data_ptr<float>(), dw.data_ptr<float>(),
                              dv.data_ptr<float>(), optional_out(dx, "dx"),
                              optional_out(dx_part, "dx_part"),
                              dbh.data_ptr<float>(), k, n, d, h,
                              dw_part.size(1), chunk, as_stream(stream)),
           "nade_ll_bwd");
}

// An (t + 1, k, n, u) carry buffer, an (k, n, u) state or an (t, k, n, 4u)
// gate tensor of the LSTM recurrence.
void check_shape(const at::Tensor& t, std::initializer_list<int64_t> sizes,
                 const char* name) {
  TORCH_CHECK(t.sizes() == at::IntArrayRef(sizes), "lstm_scan: ", name,
              " must be ", at::IntArrayRef(sizes), ", got ", t.sizes());
}

void lstm_scan_fwd(at::Tensor hbuf, at::Tensor cbuf, at::Tensor zbuf,
                   const at::Tensor& xz, const at::Tensor& wf,
                   const at::Tensor& h0, const at::Tensor& c0, int64_t rows,
                   int64_t w_smem, int64_t stream) {
  for (auto [t, name] :
       {std::pair<const at::Tensor*, const char*>{&hbuf, "hbuf"},
        {&cbuf, "cbuf"}, {&xz, "xz"}, {&wf, "wf"}, {&h0, "h0"}, {&c0, "c0"}})
    check(*t, at::kFloat, name);
  TORCH_CHECK(xz.dim() == 4 && xz.size(3) % 4 == 0,
              "lstm_scan_fwd: xz must be (t, k, n, 4u)");
  const int64_t t = xz.size(0), k = xz.size(1), n = xz.size(2),
                u = xz.size(3) / 4;
  check_shape(wf, {k, u, u, 4}, "wf");
  check_shape(h0, {k, n, u}, "h0");
  check_shape(c0, {k, n, u}, "c0");
  check_shape(hbuf, {t + 1, k, n, u}, "hbuf");
  check_shape(cbuf, {t + 1, k, n, u}, "cbuf");
  // the pre-activations are not asked for without a backward to read them
  if (zbuf.numel() != 0) check_shape(zbuf, {t, k, n, 4 * u}, "zbuf");
  raise_on(launch_lstm_scan_fwd(xz.data_ptr<float>(), wf.data_ptr<float>(),
                                h0.data_ptr<float>(), c0.data_ptr<float>(),
                                hbuf.data_ptr<float>(), cbuf.data_ptr<float>(),
                                optional_out(zbuf, "zbuf"), t, k, n, u, rows,
                                w_smem, as_stream(stream)),
           "lstm_scan_fwd");
}

void lstm_scan_bwd(at::Tensor dz, at::Tensor dh0, at::Tensor dc0,
                   const at::Tensor& z, const at::Tensor& wb,
                   const at::Tensor& cbuf, const at::Tensor& dhbuf,
                   const at::Tensor& dcbuf, int64_t rows, int64_t w_smem,
                   int64_t stream) {
  for (auto [t, name] :
       {std::pair<const at::Tensor*, const char*>{&dz, "dz"}, {&dh0, "dh0"},
        {&dc0, "dc0"}, {&z, "z"}, {&wb, "wb"}, {&cbuf, "cbuf"}})
    check(*t, at::kFloat, name);
  TORCH_CHECK(z.dim() == 4 && z.size(3) % 4 == 0,
              "lstm_scan_bwd: z must be (t, k, n, 4u)");
  const int64_t t = z.size(0), k = z.size(1), n = z.size(2),
                u = z.size(3) / 4;
  check_shape(wb, {k, u, u, 4}, "wb");
  check_shape(cbuf, {t + 1, k, n, u}, "cbuf");
  check_shape(dz, {t, k, n, 4 * u}, "dz");
  check_shape(dh0, {k, n, u}, "dh0");
  check_shape(dc0, {k, n, u}, "dc0");
  // an absent carry gradient is an empty tensor
  for (const at::Tensor* g : {&dhbuf, &dcbuf})
    if (g->numel() != 0)
      check_shape(*g, {t + 1, k, n, u}, "a carry gradient");
  raise_on(launch_lstm_scan_bwd(z.data_ptr<float>(), wb.data_ptr<float>(),
                                cbuf.data_ptr<float>(),
                                optional_f32(dhbuf, "dhbuf"),
                                optional_f32(dcbuf, "dcbuf"),
                                dz.data_ptr<float>(), dh0.data_ptr<float>(),
                                dc0.data_ptr<float>(), t, k, n, u, rows,
                                w_smem, as_stream(stream)),
           "lstm_scan_bwd");
}

}  // namespace
}  // namespace multinn_torch

TORCH_LIBRARY(multinn_torch, m) {
  m.def("threefry2x32(Tensor(a!) y0, Tensor(b!) y1, Tensor key, Tensor x0, "
        "Tensor x1, int stream) -> ()");
  m.def("gibbs_chain(Tensor(a!) out, Tensor v0, Tensor w, Tensor bv, "
        "Tensor bh, Tensor seed, int k, int bb, int row0, int rows_loc, "
        "int rows_glob, int rows_per_cta, int threads, int lanes, "
        "int w_smem, int stream) -> ()");
  m.def("gen_fused_rbm(Tensor(a!) roll, Tensor(b!) h_out, Tensor(c!) c_out, "
        "Tensor w, Tensor wuv, Tensor wuh, Tensor bv, Tensor bh, "
        "Tensor wx_v, Tensor wx_r, Tensor wh, Tensor wctx, Tensor b, "
        "Tensor h0, Tensor c0, Tensor v0, Tensor given, Tensor seed, "
        "int gen_k, int lstm, int given_mask, int row0, int rows_total, "
        "int stream) -> ()");
  m.def("nade_sample(Tensor(a!) out, Tensor w, Tensor v, Tensor bv, "
        "Tensor bh, Tensor seed, int staged, int row0, int rows_total, "
        "int stream) -> ()");
  m.def("gen_fused_nade(Tensor(a!) roll, Tensor(b!) h_out, Tensor(c!) c_out, "
        "Tensor w, Tensor v, Tensor wuv, Tensor wuh, Tensor bv, Tensor bh, "
        "Tensor wx_v, Tensor wxg, Tensor wx_r, Tensor wh, Tensor wctx, "
        "Tensor b, Tensor h0, Tensor c0, Tensor v0, Tensor given, "
        "Tensor seed, int lstm, int spec, int given_mask, int row0, "
        "int rows_total, int stream) -> ()");
  // no tensor arguments: a kernel for every dispatch key
  m.def("gen_fused_plan(int nade, int k, int d, int hid, int u, "
        "int n_layers, int lstm, int batch, int bf16=0) -> int[]",
        &multinn_torch::gen_fused_plan);
  m.def("nade_ll_fwd(Tensor(a!) logits, Tensor(b!) a_end, Tensor(c!) part, "
        "Tensor x, Tensor w, Tensor v, Tensor bv, Tensor bh, int n_ctas, "
        "int chunk, int stream) -> ()");
  m.def("nade_ll_bwd(Tensor(a!) dw, Tensor(b!) dv, Tensor(c!) dx, "
        "Tensor(d!) dbh, Tensor(e!) dw_part, Tensor(f!) dv_part, "
        "Tensor(g!) dx_part, Tensor x, Tensor w, Tensor v, Tensor g, "
        "Tensor a_end, int chunk, int stream) -> ()");
  m.def("lstm_scan_fwd(Tensor(a!) hbuf, Tensor(b!) cbuf, Tensor(c!) zbuf, "
        "Tensor xz, Tensor wf, Tensor h0, Tensor c0, int rows, int w_smem, "
        "int stream) -> ()");
  m.def("lstm_scan_bwd(Tensor(a!) dz, Tensor(b!) dh0, Tensor(c!) dc0, "
        "Tensor z, Tensor wb, Tensor cbuf, Tensor dhbuf, Tensor dcbuf, "
        "int rows, int w_smem, int stream) -> ()");
}

TORCH_LIBRARY_IMPL(multinn_torch, CUDA, m) {
  m.impl("threefry2x32", &multinn_torch::threefry2x32);
  m.impl("gibbs_chain", &multinn_torch::gibbs_chain);
  m.impl("gen_fused_rbm", &multinn_torch::gen_fused_rbm);
  m.impl("nade_sample", &multinn_torch::nade_sample);
  m.impl("gen_fused_nade", &multinn_torch::gen_fused_nade);
  m.impl("nade_ll_fwd", &multinn_torch::nade_ll_fwd);
  m.impl("nade_ll_bwd", &multinn_torch::nade_ll_bwd);
  m.impl("lstm_scan_fwd", &multinn_torch::lstm_scan_fwd);
  m.impl("lstm_scan_bwd", &multinn_torch::lstm_scan_bwd);
}
