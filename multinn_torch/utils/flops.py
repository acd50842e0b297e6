"""Closed-form FLOP counts, the H100's peak rates, and the roofline of each
CUDA kernel — the port's counterpart of multinn_tpu/utils/flops.py.

Scanned and captured programs hide their per-step work from any counter
that reads one traced body, so the utilisation numbers come from closed
forms. Convention: one multiply-accumulate = 2 FLOPs; an add or a sigmoid
counts 1.

Two FLOP notions:

  * MODEL flops — the mathematically necessary work (the MFU convention).
    ``train_step_flops``, ``gen_step_flops_rbm(...)["model"]`` and
    ``gen_step_flops_nade(...)["model"]`` equal the JAX package's integers
    for every configuration, so an MFU reads the same in both packages.
  * EXECUTED flops — what the CUDA whole-generation kernels
    (csrc/gen_fused_rbm.cu, gen_fused_nade.cu, gen_cluster.cuh) multiply.
    Each track runs on its own CTA of a thread-block cluster, with its
    compact per-track weights: there is no block-diagonal layout and no row
    or lane padding of the TPU kernels. The cell stack's layer-0 products
    (own frame through Wx, the feedback context through Wctx) run over the
    listed nonzero entries of the frames, so they scale with the frame
    density; ``density=1.0`` gives the most the kernel can multiply. The
    NADE sweep holds a track's hidden lanes in 8 register rounds of 32
    lanes: the sequential sweep's logit dots run over all 256 whatever H
    is, the speculative sweep's over the rounds that hold live lanes, in
    each of a group's 2^(s-1) warps.

Roofline (``bound`` and the ``*_work`` functions): the least time the card
could take for a kernel's call — the bytes it must move (each input read
once, each output written once) at the memory rate, or the operations this
call's inputs need at the f32 rate outside the tensor cores, whichever is
larger. Work that depends on draws a kernel does not show is left out, so
each bound stays a lower bound.
"""

from __future__ import annotations

from typing import NamedTuple


class Peak(NamedTuple):
    name: str
    flops_per_s: float


# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
# power limit (a card set below it runs slower under load)
H100_SXM_F32 = Peak("H100 SXM f32 (outside the tensor cores)", 67e12)
H100_SXM_TF32 = Peak("H100 SXM TF32 dense", 494.7e12)
H100_SXM_BF16 = Peak("H100 SXM bf16 dense", 989.4e12)
H100_SXM_HBM_BYTES_PER_S = 3.35e12          # HBM3, the same data sheet

# csrc/gen_fused_nade.cu: a warp holds a track's hidden lanes in
# kMaxLaneRounds = 8 rounds of its 32 lanes
NADE_SWEEP_LANES = 8 * 32
# per dim, in each of the warp's 32 lanes: the 5 adds of warp_allsum's
# xor butterfly (csrc/reduce.cuh), the logit's bias add and its sigmoid
NADE_SWEEP_LANE_OPS = (5 + 2) * 32
# about 80 32-bit integer operations per Threefry-2x32 counter (20 rounds
# of add / rotate / xor, 5 key injections)
THREEFRY_OPS = 80


def _dims(cfg):
    """(K, D, H, U, ctx) as the compute paths see them: ``joint`` mode is ONE
    decoder over the concatenated tracks, and D is the decoder FEATURE
    width (the DBN encoder's latent, not raw pitches)."""
    k = 1 if cfg.mode == "joint" else cfg.n_tracks
    d = cfg.feature_dim()
    h, u = cfg.n_hidden, cfg.n_rnn
    return k, d, h, u, cfg.ctx_dim()


def _gate_mult(cfg) -> int:
    """Recurrent gate width multiple: LSTM computes 4U gate pre-activations
    per step, a vanilla tanh cell computes U."""
    return 4 if cfg.cell == "lstm" else 1


def lstm_frame_flops(xin: int, u: int, layers: int = 1,
                     gate_mult: int = 4) -> int:
    """One recurrent-cell step, one batch row: z = x@wx + h@wh, gate width
    ``gate_mult``*U (4 for LSTM + ~12U elementwise, 1 for vanilla tanh)."""
    elementwise = 12 * u if gate_mult == 4 else u
    total = 0
    for layer in range(layers):
        inp = xin if layer == 0 else u
        total += 2 * (inp + u) * gate_mult * u + elementwise
    return total


def train_step_flops(cfg, batch: int, t: int) -> int:
    """MODEL flops of ONE optimizer step (fwd + bwd) of the trainer's hot
    path (``detailed=False`` loss), all K tracks. Counting: backward costs
    2x the differentiable forward; CD's Gibbs chain runs without gradient,
    so it is forward-only."""
    k, d, h, u, ctx = _dims(cfg)
    lstm = lstm_frame_flops(d + ctx, u, cfg.rnn_layers, _gate_mult(cfg))
    biases = 2 * u * (d + h)
    if cfg.decoder_type == "rnn-rbm":
        fe2 = 2 * (2 * d * h)                  # free energy at v0 and vk
        chain = 4 * d * h * cfg.cd_k           # forward only
        per_frame_track = 3 * (lstm + biases + fe2) + chain
    else:                                      # rnn-nade exact LL
        # v_i*W_i products + exclusive cumsum + sigma(a) grid + V_i.h_i dots
        nade = 6 * d * h
        per_frame_track = 3 * (lstm + biases + nade)
    return batch * t * k * per_frame_track


def _cell_executed(cfg, density: float) -> float:
    """The cell stack of gen_cluster.cuh for one track and sample: layer 0
    gathers the fresh own frame (D) and, with feedback, the previous frames
    of all tracks (ctx) over their nonzero entries; the recurrence and the
    upper layers' inputs are dense dots over U."""
    k, d, h, u, ctx = _dims(cfg)
    g = _gate_mult(cfg) * u
    elementwise = 12 * u if cfg.cell == "lstm" else u
    layer0 = 2 * density * (d + ctx) * g + 2 * u * g + elementwise
    upper = (cfg.rnn_layers - 1) * (4 * u * g + elementwise)
    return layer0 + upper


def gen_step_flops_rbm(cfg, batch: int, gen_k: int = None,
                       density: float = 1.0) -> dict:
    """One generated frame through the fused RBM kernel. Returns
    {"model": ..., "executed": ...}. Executed: per track and sample the
    conditioned biases (dense dots over U), gen_k sweeps of two dense
    passes over (D, H) — the chain starts at the previous frame — and the
    cell stack at the frames' ``density``. At density 1 it equals the
    model count."""
    k, d, h, u, ctx = _dims(cfg)
    gm = _gate_mult(cfg)
    gk = cfg.gen_k if gen_k is None else gen_k
    gibbs = 4 * d * h * gk                     # per track
    biases = 2 * u * (d + h)
    lstm = lstm_frame_flops(d + ctx, u, cfg.rnn_layers, gm)
    model = batch * k * (gibbs + biases + lstm)
    executed = batch * k * (gibbs + biases + _cell_executed(cfg, density))
    return {"model": model, "executed": executed}


def _sweep_group_executed(spec: int, h: int, density: float) -> float:
    """The work on a group of ``spec`` dims of the NADE sweep
    (csrc/gen_fused_nade.cu). Depth 1, one warp: the logit dot, an fmaf
    per lane of each of the 256 register lanes; in each of the 32 lanes
    warp_allsum's 5 adds, the bias add and the sigmoid; on a sampled dim
    (``density`` of them) the W row add and the H sigmoids it refreshes.
    Depth s > 1, a team of 2^(s-1) warps, each running the same code over
    the register rounds that hold a live lane: its branch's activation (s
    - 1 adds), sigmoid and s logit fmafs per lane; in each of the 32 lanes
    the transposed butterfly's adds and selects over s partials, the
    slot's bias add and sigmoid and the chain's s - 1 selects; and each
    warp's own realized update, a W row add per sampled dim on H lanes."""
    if spec == 1:
        return 2 * NADE_SWEEP_LANES + NADE_SWEEP_LANE_OPS + density * 2 * h
    lanes = 32 * -(-h // 32)
    log_s = spec.bit_length() - 1
    rounds = lanes * (2 * spec + spec)
    lane_ops = 32 * ((spec - 1) + (5 - log_s) + 2 * (spec - 1) + 2
                     + spec - 1)
    realized = h * density * spec
    return (1 << (spec - 1)) * (rounds + lane_ops + realized)


def gen_step_flops_nade(cfg, batch: int, density: float = 1.0,
                        spec: int = None) -> dict:
    """One generated frame through the fused NADE kernel. Returns
    {"model": ..., "executed": ...}; the model count is the JAX package's,
    whose per-dim accumulation bills the own-frame Wx product once more on
    top of the cell's, at every depth.

    Executed, per track and sample: the conditioned biases; the sweep at
    the depth ``spec`` it runs, D / spec groups of
    ``_sweep_group_executed``; then the cell stack, which gathers the
    own-frame projection over the sampled dims. ``spec`` None: the
    kernel's auto depth at a batch whose CTAs hold one (sample, track)
    group each, 4 where 4 divides D, else 1; where they hold more the
    auto depth is 1 (``ops.gen_fused_nade.auto_depth`` reads it): pass
    ``spec=1`` for such a batch. Depths 2 and 4 are billed as the teams
    of warps run them; an explicit depth on a launch that leaves no team
    per group runs every branch on one warp, which is not billed here.
    Where H is far below 256 the padded
    lanes make the executed count exceed the model's; at the flagship
    (H=150) the model's dense 6DH grid and its second Wx product make it
    the larger at depth 1, while depth 4's eight warps a quad make the
    executed count the larger."""
    k, d, h, u, ctx = _dims(cfg)
    gm = _gate_mult(cfg)
    if spec is None:
        spec = 4 if d % 4 == 0 else 1
    lstm = lstm_frame_flops(d + ctx, u, cfg.rnn_layers, gm)
    model = batch * k * (6 * d * h + 2 * d * gm * u + lstm)
    sweep = d // spec * _sweep_group_executed(spec, h, density)
    executed = batch * k * (2 * u * (d + h) + sweep
                            + _cell_executed(cfg, density))
    return {"model": model, "executed": executed}


def peak_for(matmul_policy: str = "f32", allow_tf32: bool = False) -> Peak:
    """The H100 peak the training step's matmuls run at: bf16 feeds
    (ops/precision.py's ``bf16`` policy) on the tensor cores at the bf16
    rate; f32 feeds at the TF32 rate where PyTorch may use TF32
    (``torch.backends.cuda.matmul.allow_tf32``), else at the f32 rate
    outside the tensor cores."""
    if matmul_policy in ("bf16", "bfloat16"):
        return H100_SXM_BF16
    if matmul_policy not in (None, "f32", "float32"):
        raise ValueError(f"unknown matmul policy {matmul_policy!r}")
    return H100_SXM_TF32 if allow_tf32 else H100_SXM_F32


def mfu(flops: float, seconds: float, peak: Peak) -> float:
    """Fraction of the named one-card peak achieved: flops / (seconds *
    peak.flops_per_s)."""
    return flops / (seconds * peak.flops_per_s) if seconds > 0 else 0.0


# -- roofline -----------------------------------------------------------------

def bound(nbytes: float, ops: float):
    """The least time the card could take for this work (ms), and what
    bounds it: the bytes at the memory rate or the operations at the f32
    rate (the integer work of Threefry is counted at the same rate)."""
    t_bytes = nbytes / H100_SXM_HBM_BYTES_PER_S
    t_ops = ops / H100_SXM_F32.flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def threefry_work(n: int = 1):
    """(bytes, operations) of Threefry-2x32 over n counters: the key, two
    counter words and two output words per counter, THREEFRY_OPS integer
    operations each."""
    return 8 + 16 * n, THREEFRY_OPS * n


def gibbs_work(n: int, k: int, out, d: int = 84, h: int = 150):
    """(bytes, operations) of a k-sweep Gibbs chain over n rows: v0, bv and
    the output (n, d), bh (n, h) and W once each; per sweep the hidden
    pass's products over the nonzero visible entries (each sweep's chain
    taken at the output's density) and d + h Threefry draws per row. The
    visible pass, whose products run over hidden samples the kernel does
    not show, is left out: a lower bound."""
    return (4 * (3 * n * d + d * h + n * h),
            2 * k * h * float(out.sum()) + THREEFRY_OPS * n * k * (d + h))


def nade_sample_work(n: int, d: int, h: int, out):
    """(bytes, operations) of the NADE sampler over n rows: V and W once,
    the row biases (n, d) and the output (n, d), the hidden biases (n, h);
    a dense V_i . sigmoid(a) dot per row and dim, and the W_i update of
    each sampled dim of ``out``."""
    return (4 * (2 * d * h + n * d * 2 + n * h),
            2 * n * d * h + h * float(out.sum()))


def nade_ll_fwd_work(k: int, n: int, d: int, h: int, x):
    """(bytes, operations) of the likelihood forward over k tracks of n
    rows: x, the row biases and the logits (k, n, d), the hidden biases and
    the saved a_D (k, n, h), W and V; a dense V . sigmoid(a) per row and
    dim, and the W updates where x = 1."""
    return (4 * (3 * k * n * d + 2 * k * n * h + 2 * k * d * h),
            2 * k * n * d * h + h * float(x.sum()))


def nade_ll_bwd_work(k: int, n: int, d: int, h: int, x):
    """(bytes, operations) of the likelihood backward without dx: x and the
    cotangent (k, n, d), a_D and dbh (k, n, h), W and V in, dW and dV out;
    the dense dV and the logit gradient's V products, the a downdate and dW
    where x = 1."""
    return (4 * (2 * k * n * d + 2 * k * n * h + 4 * k * d * h),
            4 * k * n * d * h + 2 * h * float(x.sum()))


def lstm_scan_fwd_work(k: int, n: int, u: int, t: int):
    """(bytes, operations) of the LSTM recurrence forward over t steps of k
    tracks x n rows of u units: xz (t, k, n, 4u), Wh, h0 and c0 in; hbuf
    and cbuf (t + 1, k, n, u) and the kept pre-activations z out; the h Wh
    products (the cell's elementwise work left out: a lower bound)."""
    return (4 * (8 * t * k * n * u + 4 * k * u * u + 2 * k * n * u
                 + 2 * (t + 1) * k * n * u),
            8 * t * k * n * u * u)


def lstm_scan_bwd_work(k: int, n: int, u: int, t: int):
    """(bytes, operations) of its backward: z, cbuf, one carry's cotangent
    and Wh in; dz (t, k, n, 4u), dh0 and dc0 out; the dz Wh^T products."""
    return (4 * (8 * t * k * n * u + 2 * (t + 1) * k * n * u
                 + 4 * k * u * u + 2 * k * n * u),
            8 * t * k * n * u * u)


def fused_work(params, roll, v0, gen_k: int, storage=None):
    """(bytes, operations) of one whole generation: every decoder weight
    read once at the bytes it is stored in (bf16 where the NADE kernel
    always keeps it; ``storage`` bfloat16: the capacity mode of the run,
    the RBM's W, Wuv, Wuh and Wctx or the NADE's Wuh, Wh and layer >= 1 Wx
    in bf16 too; None or float32: f32), the state in and out,
    the roll written once; the dense products (biases, recurrence, the
    NADE's per-dim sums) plus the products over the frames' nonzero
    entries that this run's roll holds (the RBM's hidden pass, with each
    sweep's chain taken at the frame's density; the own-frame projection;
    the feedback context over the previous frame; the NADE's W updates).
    The RBM's visible pass needs products only over the chain's nonzero
    hidden samples, which the kernel's run does not show, so it is left
    out: a lower bound."""
    import torch

    from multinn_torch.models import multinn
    cfg = params.cfg
    k, d, h, u, n_layers = (multinn.n_decoders(cfg), cfg.feature_dim(),
                            cfg.n_hidden, cfg.n_rnn, cfg.rnn_layers)
    g = 4 * u if cfg.cell == "lstm" else u
    b, t = roll.shape[:2]
    steps = b * t * k
    nnz = float(roll.sum())
    nnz_prev = float(v0.sum() + roll[:, :-1].sum())
    ctx = k * g * nnz_prev if cfg.ctx_dim() else 0.0
    dense = steps * ((d + h) * u + g * u * (2 * n_layers - 1))
    dec = params.decoder
    numel = sum(x.numel() for x in multinn.tree_leaves(dec))
    capacity = storage == torch.bfloat16
    if cfg.decoder_type == "rnn-rbm":
        ops = 2 * (dense + gen_k * h * nnz + g * nnz + ctx)
        half = (dec.w.numel() + dec.wuv.numel() + dec.wuh.numel()
                + dec.cell[0].wx[:, d:].numel()) if capacity else 0
    else:
        ops = 2 * (dense + steps * d * h + ctx) + h * nnz + g * nnz
        half = (dec.w.numel() + dec.v.numel() + dec.wuv.numel()
                + dec.cell[0].wx.numel())
        if capacity:
            half += (dec.wuh.numel() + sum(c.wh.numel() for c in dec.cell)
                     + sum(c.wx.numel() for c in dec.cell[1:]))
    wbytes = 2 * half + 4 * (numel - half)
    nbytes = wbytes + 4 * (roll.numel() + 4 * b * n_layers * k * u
                           + b * k * d)
    return nbytes, ops
