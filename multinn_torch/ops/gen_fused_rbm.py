"""Whole RNN-RBM generation in one kernel launch: wrapper of
csrc/gen_fused_rbm.cu, its plain PyTorch version, and the dispatch gate —
port of multinn_tpu/ops/gen_fused_rbm.py.

Each step t, for all K tracks and B samples: conditioned biases from the
top layer's previous h; gen_k Gibbs sweeps started at the previous frame,
drawing uniforms at salt ``seed[1] + t*2*gen_k + 2s`` (``+1`` for v) and
counter ``b*K*H + lane`` (``b*K*D + lane``) exactly as the TPU kernel's
(B, K*H) / (B, K*D) draws; the optional given-track merge; the stacked
LSTM / vanilla advance, whose layer-0 input is the fresh frame plus the
PREVIOUS frame of all tracks through ``wctx`` (feedback mode).

Under the row map ``rows=(b0, B_global)`` the batch is samples b0 ..
b0 + B - 1 of a batch of B_global (one data shard of a mesh) and sample b
draws the counters of sample b0 + b, so the shards' rolls together are the
whole batch's roll; None is ``(0, B)``.

The plain version equals the Pallas kernel in interpret mode bit for bit
in the roll (CPU tests); the CUDA kernel equals the plain version up to the
rare draw a last-ulp difference in a probability flips, after which that
sample's trajectory diverges (chip_smoke compares by matching samples).

Weight storage follows the JAX package's capacity mode: with ``wdtype``
bfloat16, W, Wuv, Wuh and Wctx are stored in bf16 and the conditioning
products take h_top rounded to bf16 against them; the Gibbs and context
products take binary operands, exact in bf16; accumulation stays f32 and
every other matrix f32. ``wdtype=None`` resolves through
``rbm_weight_dtype``'s rule, the reference's choice for this config and
batch (ops/gen_common.py: its VMEM budget, applied for its numerics
only): bf16 where its f32 layout exceeds the budget and its bf16 one
fits, else f32 (also where it falls back to its scan path).

The kernel's Gibbs passes sum only the weight rows of the units their
binary input holds (the chain's samples as mask words, each warp walking
its own list of them).

The gate is a Hopper resource check of the kernel's design — a cluster of
min(K, 8) CTAs per group of samples, each CTA with its 16 warps' lists,
its tracks' W, Wuh and Wuv in shared memory where they fit (else read
from global memory) and each sample's state rows beside them — computed
from the same arguments the dispatch builds (not the TPU kernel's VMEM
rule): one sample's state must fit beside the lists. The storage dtype
changes which matrices fit beside it (the launch's plan), not what the
gate admits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from multinn_torch.ops import _build, gen_common, kernel_prng
from multinn_torch.ops.gen_common import (SMEM_LIMIT_BYTES, _common_gate,
                                          _ctx_rows, _decoder_param_shapes,
                                          _eff_dims, _from_state_rows,
                                          _given_fits, _state_rows)
from multinn_torch.ops.sampling import key_to_seeds

MAX_TRACKS = 31             # the given-track merge is a 32-bit lane mask


class RbmArgs(NamedTuple):
    """Kernel inputs from track-STACKED rnn_rbm.Params + state, in compact
    per-track layouts (the TPU kernel's block-diagonal matrices only served
    its matrix unit); w, wuv, wuh and wctx in the storage dtype, the rest
    f32:

        w     (K, D, H)   RBM weights
        wuv   (K, U, D)   bias conditioning wuh  (K, U, H)
        bv    (K*D,)      bh   (K*H,)
        wx_v  (K, D, G)   layer-0 input projection of the track's frame
        wh    (L, K, U, G) recurrent weights, G = 4U (LSTM) | U (vanilla)
        wctx  (K*D, K*G)  feedback projection, rows [source track j][pitch i],
                          columns [target track k][gate]; None without ctx
        b     (L, K*G)    gate biases
        h0/c0 (B, L*K*U)  state rows, layer-major then per-track
        v0    (B, K*D)    previous frame rows
        wx_r  (L-1, K, U, G) input projections of layers >= 1; None if L = 1
    """
    w: torch.Tensor
    wuv: torch.Tensor
    wuh: torch.Tensor
    bv: torch.Tensor
    bh: torch.Tensor
    wx_v: torch.Tensor
    wh: torch.Tensor
    wctx: Optional[torch.Tensor]
    b: torch.Tensor
    h0: torch.Tensor
    c0: torch.Tensor
    v0: torch.Tensor
    wx_r: Optional[torch.Tensor]


def _rbm_args(dec_params, h0, c0, v0, wdtype=torch.float32) -> RbmArgs:
    """h0/c0: (L, K, B, U); v0: (K, B, D); ``wdtype`` the storage dtype of
    w, wuv, wuh and wctx."""
    cells = dec_params.cell
    n_layers = len(cells)
    d = dec_params.w.shape[1]
    b = h0.shape[2]
    wctx = _ctx_rows(cells[0].wx, d)
    store = lambda x: x.to(wdtype).contiguous()
    return RbmArgs(
        w=store(dec_params.w),
        wuv=store(dec_params.wuv),
        wuh=store(dec_params.wuh),
        bv=dec_params.bv.reshape(-1).contiguous(),
        bh=dec_params.bh.reshape(-1).contiguous(),
        wx_v=cells[0].wx[:, :d, :].contiguous(),
        wh=torch.stack([c.wh for c in cells]).contiguous(),
        wctx=None if wctx is None else store(wctx),
        b=torch.stack([c.b.reshape(-1) for c in cells]).contiguous(),
        h0=_state_rows(h0), c0=_state_rows(c0),
        v0=v0.movedim(1, 0).reshape(b, -1).contiguous(),
        wx_r=(torch.stack([c.wx for c in cells[1:]]).contiguous()
              if n_layers > 1 else None))


def _reference_dtype(dims: gen_common.LayoutDims, batch: int,
                     conditioned: bool):
    """The JAX package's weight storage for these sizes: float32, bfloat16,
    or None where it runs its scan path (gen_common's contract)."""
    return gen_common.storage_dtype(lambda nbytes: gen_common.rbm_layout_bytes(
        dims, batch, nbytes, conditioned))


def rbm_weight_dtype(cfg, batch: int, conditioned: bool = False
                     ) -> torch.dtype:
    """The weight storage dtype the JAX package's fused RBM kernel uses for
    this config and batch (its ``rbm_weight_dtype``): float32 while its
    f32 layout fits its VMEM budget, else bfloat16 while the bf16 one does;
    float32 past both, where the reference runs its scan path with f32
    weights. ``conditioned``: an accompaniment's given stream."""
    dtype = _reference_dtype(gen_common.dims_of_cfg(cfg), batch, conditioned)
    return torch.float32 if dtype is None else dtype


def _scratch(d: int, hid: int, g: int) -> int:
    """A group's scratch floats, as rbm_scratch in csrc/gen_fused_rbm.cu:
    bv(t), bh(t) and the chain's mask words, one per 32 units of the
    visible and of the hidden row; then the gates."""
    return max(g, d + hid + -(-d // 32) + -(-hid // 32))


def _lists_bytes(d: int, hid: int) -> int:
    """The warps' lists at the front of the weight region, as
    plan_gen_fused_rbm keeps them: 16 warps, each a list of up to max(D, H)
    uint16 indices and 7 of padding, 16-byte aligned."""
    return 16 * ((2 * (max(d, hid) + 7) + 15) & ~15)


def _sample_bytes(args: RbmArgs) -> int:
    """One sample's shared memory, as plan_gen_fused_rbm in
    csrc/gen_fused_rbm.cu counts it (its scratch row ``_scratch``)."""
    k, d, hid = args.w.shape
    n_layers, _, u, g = args.wh.shape
    return gen_common.sample_bytes(k, d, u, n_layers, _scratch(d, hid, g))


def _fits(args: RbmArgs) -> bool:
    """One sample's state fits beside the warps' lists."""
    _, d, hid = args.w.shape
    return (args.w.shape[0] <= MAX_TRACKS
            and _sample_bytes(args) + _lists_bytes(d, hid)
            <= SMEM_LIMIT_BYTES)


def supported(cfg, batch: int, n_steps: int = 2048,
              gen_k: Optional[int] = None, conditioned: bool = False) -> bool:
    """Gate for the auto-dispatch: the config is one the kernel takes and
    one sample's state rows fit a CTA's shared memory (batch sets only the
    samples per cluster and the grid; n_steps and gen_k set only the loop
    trip counts). ``conditioned``: an accompaniment's given stream, which
    the kernel reads from device memory (gen_common._given_fits)."""
    if (not _common_gate(cfg, "rnn-rbm") or batch < 1 or n_steps < 1
            or not _given_fits(cfg, int(conditioned))):
        return False
    from multinn_torch.models import rnn_rbm
    (k, d), u, nl = _eff_dims(cfg), cfg.n_rnn, cfg.rnn_layers
    params = _decoder_param_shapes(cfg, rnn_rbm)
    st = torch.empty((nl, k, batch, u), device="meta")
    v0 = torch.empty((k, batch, d), device="meta")
    return _fits(_rbm_args(params, st, st, v0))


def generate_rbm(key: torch.Tensor, dec_params, h0, c0, v0, n_steps: int,
                 gen_k: int, impl=None, wdtype=None, given=None,
                 given_tracks: Tuple[int, ...] = (), rows=None):
    """Run the whole generation. dec_params: track-STACKED rnn_rbm.Params;
    h0/c0: (L, K, B, U) ((K, B, U) for one layer); v0: (K, B, D);
    ``given`` (B, n_steps, K, D) with ``given_tracks``: those tracks' frames
    replace the sampled ones (accompaniment); ``rows``: the row map (b0,
    B_global). Returns (roll (B, n_steps, K, D) float32, h_final (L, K, B,
    U), c_final (L, K, B, U)).

    ``wdtype``: the storage dtype of W, Wuv, Wuh and Wctx, float32 or
    bfloat16; None: ``rbm_weight_dtype``'s rule at the whole batch
    (B_global under a row map, so every shard stores what one device
    would) and ``given``.
    ``impl``: None = the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; "cuda" / "plain" force one."""
    n_layers = len(dec_params.cell)
    if h0.dim() == 3 and n_layers == 1:
        h0, c0 = h0[None], c0[None]
    given_tracks = tuple(sorted(set(int(t) for t in given_tracks)))
    if (given is None) != (not given_tracks):
        raise ValueError("given and given_tracks must be passed together")
    b = h0.shape[2]
    rmap = kernel_prng.row_map(b, rows)
    wdtype = gen_common.resolve_storage(
        wdtype, lambda: _reference_dtype(gen_common.dims_of_params(dec_params),
                                         rmap[1], given is not None),
        "wdtype")
    args = _rbm_args(dec_params, h0, c0, v0, wdtype)
    k, d, hid = args.w.shape
    u, g = args.wuv.shape[1], args.wx_v.shape[2]
    lstm = g == 4 * u
    seeds = key_to_seeds(key).to(args.w.device)
    if given is not None:
        given = given.reshape(b, n_steps, k * d).to(torch.float32).contiguous()
    if _build.impl_for(impl, args.w) == "cuda":
        roll, h_out, c_out = _generate_cuda(seeds, args, n_steps, gen_k,
                                            lstm, given, given_tracks, rmap)
    else:
        roll, h_out, c_out = _generate_plain(seeds, args, n_steps, gen_k,
                                             lstm, given, given_tracks, rmap)

    return (roll.reshape(b, n_steps, k, d),
            _from_state_rows(h_out, n_layers, k, u),
            _from_state_rows(c_out, n_layers, k, u))


def _generate_cuda(seeds, args: RbmArgs, n_steps, gen_k, lstm, given,
                   given_tracks, rmap):
    if not _fits(args):
        raise ValueError(
            f"generate_rbm: one sample's state needs "
            f"{_sample_bytes(args)} bytes of shared memory beside "
            f"{_lists_bytes(*args.w.shape[1:])} of lists (limit "
            f"{SMEM_LIMIT_BYTES}) or K > {MAX_TRACKS}; gen_fused.supported "
            f"refuses this config — use the scan path")
    b = args.h0.shape[0]
    kd = args.v0.shape[1]
    dev = args.w.device
    roll = torch.empty((b, n_steps, kd), device=dev)
    h_out, c_out = torch.empty_like(args.h0), torch.empty_like(args.c0)
    none = torch.empty(0, device=dev)
    mask = sum(1 << t for t in given_tracks)
    with torch.cuda.device(dev):
        _build.launches["gen_fused_rbm"] += 1
        _build.ops().gen_fused_rbm(
            roll, h_out, c_out, args.w, args.wuv, args.wuh, args.bv,
            args.bh, args.wx_v, none if args.wx_r is None else args.wx_r,
            args.wh, none if args.wctx is None else args.wctx, args.b,
            args.h0, args.c0, args.v0, none if given is None else given,
            seeds, gen_k, int(lstm), mask, *rmap, _build.stream_of(args.w))
    return roll, h_out, c_out


def _generate_plain(seeds, args: RbmArgs, n_steps, gen_k, lstm, given,
                    given_tracks, rmap=(0, None)):
    """Plain PyTorch version of the kernel, same signature and stream.
    Track-major (K, B, X) tensors; torch.matmul batches over the tracks.
    bf16 weights are widened exactly and h_top rounded to bf16 for the
    conditioning, as the reference's products of bf16 operands with f32
    accumulation."""
    k, d, hid = args.w.shape
    n_layers, _, u, g = args.wh.shape
    b = args.h0.shape[0]
    dev = args.w.device
    s0, s1 = (int(s) & kernel_prng.MASK for s in seeds.tolist())
    # counters (b0 + b)*K*X + lane, as (K, B, X) to line up with the
    # track-major rows
    def ctr(x):
        c = rmap[0] * k * x + torch.arange(b * k * x, dtype=torch.int64,
                                           device=dev)
        return c.reshape(b, k, x).transpose(0, 1)
    ctr_h, ctr_v = ctr(hid), ctr(d)
    rounded = args.w.dtype == torch.bfloat16
    w, wuv, wuh = args.w.float(), args.wuv.float(), args.wuh.float()
    wctx = None if args.wctx is None else args.wctx.float()
    wt = w.transpose(1, 2).contiguous()

    def uniform(salt, counter):
        return kernel_prng.uniform_from_bits(
            kernel_prng.bits_at_plain(s0, salt & kernel_prng.MASK, counter))

    def track_major(rows, width):          # (B, K*X) -> (K, B, X)
        return rows.reshape(b, k, width).transpose(0, 1)

    h = [track_major(args.h0[:, l * k * u:(l + 1) * k * u], u)
         for l in range(n_layers)]
    c = [track_major(args.c0[:, l * k * u:(l + 1) * k * u], u)
         for l in range(n_layers)]
    v_prev = track_major(args.v0, d)
    bv, bh = args.bv.reshape(k, 1, d), args.bh.reshape(k, 1, hid)
    gmask = torch.zeros(k, 1, 1, dtype=torch.bool, device=dev)
    gmask[list(given_tracks)] = True
    frames = []
    for t in range(n_steps):
        h_top = h[-1].to(torch.bfloat16).float() if rounded else h[-1]
        bv_row = bv + h_top @ wuv
        bh_row = bh + h_top @ wuh
        salt0 = s1 + t * 2 * gen_k
        v = v_prev
        for s in range(gen_k):
            ph = torch.sigmoid(v @ w + bh_row)
            hs = (uniform(salt0 + 2 * s, ctr_h) < ph).to(torch.float32)
            pv = torch.sigmoid(hs @ wt + bv_row)
            v = (uniform(salt0 + 2 * s + 1, ctr_v) < pv).to(torch.float32)
        if given is not None:
            v = torch.where(gmask, track_major(given[:, t], d), v)
        frames.append(v.transpose(0, 1).reshape(b, k * d))
        inp = v
        for l in range(n_layers):
            w_in = args.wx_v if l == 0 else args.wx_r[l - 1]
            z = inp @ w_in + h[l] @ args.wh[l]
            z = z + args.b[l].reshape(k, 1, g)
            if l == 0 and wctx is not None:
                ctx = v_prev.transpose(0, 1).reshape(b, k * d) @ wctx
                z = z + track_major(ctx, g)
            if lstm:
                c[l] = (torch.sigmoid(z[..., u:2 * u]) * c[l]
                        + torch.sigmoid(z[..., :u]) * torch.tanh(z[..., 2 * u:3 * u]))
                h[l] = torch.sigmoid(z[..., 3 * u:]) * torch.tanh(c[l])
            else:
                h[l] = torch.tanh(z)
            inp = h[l]
        v_prev = v

    def rows(xs):                          # L x (K, B, U) -> (B, L*K*U)
        return torch.stack(xs).permute(2, 0, 1, 3).reshape(b, -1)

    return torch.stack(frames, dim=1), rows(h), rows(c)
