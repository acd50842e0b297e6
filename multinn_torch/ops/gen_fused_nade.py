"""Whole RNN-NADE generation in one kernel launch: wrapper of
csrc/gen_fused_nade.cu, its plain PyTorch version, and the dispatch gate —
port of multinn_tpu/ops/gen_fused_nade.py.

Each step t, for all K tracks and B samples: conditioned biases from the
top layer's previous h; the ancestral sweep over the D dims, drawing the
uniform of (dim i, track k, sample b) at counter ``(i*8 + k)*B + b`` under
salt ``seed[1] + t``, exactly as the TPU kernel's (D*8, B) draw; the
running activation and the layer-0 input projection z grow one dim at a
time by exact adds; the optional given-track merge (given tracks' z is
recomputed from the given frame with f32 rows); the stacked LSTM / vanilla
advance, whose layer-0 input adds the PREVIOUS frame of all tracks through
``wctx`` (feedback mode).

The kernel's sweep runs SPECULATIVELY, as the TPU kernel's does, at the
depth ``spec`` (1, 2 or 4, dividing D): a dim's update is binary, so the
logits of dims i .. i+spec-1 are computed under every branch of the
draws before them, and the draws then only select; a team of 2^(spec-1)
warps runs each (sample, track) group where the CTA holds them, else one
warp carries every branch. The branch activations add one W row at a
time in dim order, so the realized branch is the sequential sweep's
sequence of adds and every depth returns the sequential sweep's roll, h
and c bit for bit (the TPU kernel's quads may move a last ulp). None
asks for the auto depth, which the kernel's launcher resolves from its
launch plan: 4 where 4 divides D and a CTA holds one group, whose team
of 8 warps then has it to itself (the H100 measurements in
csrc/gen_fused_nade.cu), else 1. The plain version computes the one
function, the sequential sweep, at every depth.

As in the TPU kernel, the NADE weights w and v, the visible-bias
conditioning wuv, the layer-0 own-frame input projection and wctx are
stored in bf16 and upcast exactly at use. ``aux_dtype`` is the storage
of the rest, wuh, wh and the layer >= 1 input projections: float32, or
bfloat16, the JAX package's capacity mode, upcast at use with no rounding
of activations. None resolves through ``nade_aux_dtype``'s rule, the
reference's choice for this config and batch (ops/gen_common.py: its
VMEM budget, applied for its numerics only), f32 where it falls back to
its scan path.
The plain version equals the Pallas kernel in interpret mode bit for bit
in the roll at the test sizes, at each depth (CPU tests); the CUDA
kernel equals the plain version up to the rare draw a last-ulp difference
in a logit flips, after which that sample's trajectory diverges
(chip_smoke compares by matching samples).

The gate is a Hopper resource check of the kernel's design — a cluster of
K CTAs per group of samples, each CTA with its track's V, W, Wuh and Wuv
in shared memory where they fit (else read from global memory) and each
sample's state rows beside them; one warp per sample and track runs the
sweep with the track's hidden lanes in registers — computed from the same
arguments the dispatch builds. The TPU kernel's "B = 1 or a multiple of 8"
rule (Mosaic tiling) is gone from the gate (the storage rule keeps it, as
the reference's dispatch does); K <= 8 stays, because the random stream
has 8 rows per dim.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from multinn_torch.nn import rnn as rnn_nn
from multinn_torch.ops import _build, gen_common, kernel_prng
from multinn_torch.ops.gen_common import (SMEM_LIMIT_BYTES, _common_gate,
                                          _ctx_rows, _decoder_param_shapes,
                                          _eff_dims, _from_state_rows,
                                          _given_fits, _state_rows)
from multinn_torch.ops.sampling import key_to_seeds

STREAM_ROWS = 8             # tracks per dim in the random stream: K <= 8
# csrc/gen_fused_nade.cu: a sweep warp's lane holds kMaxLaneRounds hidden
# lanes (H <= 256) and one bit per 32 dims (D <= 1024)
MAX_HIDDEN = 32 * 8
MAX_DIMS = 1024
SPECS = (1, 2, 4)           # the kernel's speculative depths


class NadeArgs(NamedTuple):
    """Kernel inputs from track-STACKED rnn_nade.Params + state, in compact
    per-track layouts (the TPU kernel's padded dim-major block rows and its
    fused [W | pad | M] matrix only served Mosaic):

        w, v  (K, D, H)   NADE weights, bf16
        wuv   (K, U, D)   visible-bias conditioning, bf16
        wuh   (K, U, H)   hidden-bias conditioning, the aux dtype
        bv    (K*D,)      bh   (K*H,)
        wx_v  (K, D, G)   layer-0 input projection of the track's frame, bf16
        wh    (L, K, U, G) recurrent weights, G = 4U (LSTM) | U (vanilla),
                          the aux dtype
        wctx  (K*D, K*G)  feedback projection, rows [source track j][pitch i],
                          columns [target track k][gate], bf16; None without
                          ctx
        b     (L, K*G)    gate biases
        h0/c0 (B, L*K*U)  state rows, layer-major then per-track
        v0    (B, K*D)    previous frame rows
        wx_r  (L-1, K, U, G) input projections of layers >= 1, the aux
                          dtype; None if L = 1
    """
    w: torch.Tensor
    v: torch.Tensor
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


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).contiguous()


def _nade_args(dec_params, h0, c0, v0, aux_dtype=torch.float32) -> NadeArgs:
    """h0/c0: (L, K, B, U); v0: (K, B, D); ``aux_dtype`` the storage dtype
    of wuh, wh and wx_r."""
    cells = dec_params.cell
    n_layers = len(cells)
    d = dec_params.w.shape[1]
    b = h0.shape[2]
    wctx = _ctx_rows(cells[0].wx, d)
    aux = lambda x: x.to(aux_dtype).contiguous()
    return NadeArgs(
        w=_bf16(dec_params.w), v=_bf16(dec_params.v),
        wuv=_bf16(dec_params.wuv),
        wuh=aux(dec_params.wuh),
        bv=dec_params.bv.reshape(-1).contiguous(),
        bh=dec_params.bh.reshape(-1).contiguous(),
        wx_v=_bf16(cells[0].wx[:, :d, :]),
        wh=aux(torch.stack([c.wh for c in cells])),
        wctx=None if wctx is None else _bf16(wctx),
        b=torch.stack([c.b.reshape(-1) for c in cells]).contiguous(),
        h0=_state_rows(h0), c0=_state_rows(c0),
        v0=v0.movedim(1, 0).reshape(b, -1).contiguous(),
        wx_r=(aux(torch.stack([c.wx for c in cells[1:]]))
              if n_layers > 1 else None))


def _reference_dtype(dims: gen_common.LayoutDims, batch: int, n_given: int,
                     spec: int):
    """The JAX package's aux storage for these sizes: float32, bfloat16, or
    None where it runs its scan path (gen_common's contract, and its
    dispatch's K <= 8 and "batch 1 or a multiple of 8" rules)."""
    if dims.k > STREAM_ROWS or batch < 1 or (batch != 1 and batch % 8):
        return None
    return gen_common.storage_dtype(
        lambda nbytes: gen_common.nade_layout_bytes(dims, batch, nbytes,
                                                    n_given, spec))


def nade_aux_dtype(cfg, batch: int, n_given: int = 0) -> torch.dtype:
    """The aux storage dtype the JAX package's fused NADE kernel uses for
    this config and batch (its ``nade_aux_dtype``, at its default
    speculative depth): float32 while its f32 layout fits its VMEM
    budget, else bfloat16 while the bf16 one does; float32 where it runs
    its scan path (no fit, K > 8, a batch neither 1 nor a multiple of 8,
    another decoder). ``n_given``: an accompaniment's given tracks."""
    if not _common_gate(cfg, "rnn-nade"):
        return torch.float32
    dims = gen_common.dims_of_cfg(cfg)
    dtype = _reference_dtype(dims, batch, n_given, _resolve_spec(dims.d))
    return torch.float32 if dtype is None else dtype


def _sample_bytes(args: NadeArgs) -> int:
    """One sample's shared memory, as plan_gen_fused_nade in
    csrc/gen_fused_nade.cu counts it: a group's scratch row holds bv'(t),
    the step's uniforms and bh'(t), then the gates."""
    k, d, hid = args.w.shape
    n_layers, _, u, g = args.wh.shape
    return gen_common.sample_bytes(k, d, u, n_layers, max(g, 2 * d + hid))


def _fits(args: NadeArgs) -> bool:
    k, d, hid = args.w.shape
    return (k <= STREAM_ROWS and hid <= MAX_HIDDEN and d <= MAX_DIMS
            and _sample_bytes(args) <= SMEM_LIMIT_BYTES)


def supported_nade(cfg, batch: int, n_steps: int = 2048,
                   n_given: int = 0) -> bool:
    """Gate for the auto-dispatch: the config is one the kernel takes, one
    sample's state rows fit a CTA's shared memory and a track's hidden
    lanes fit a warp's registers (batch sets only the samples per cluster
    and the grid; n_steps only the loop trip count). ``n_given``: the
    given tracks of an accompaniment, whose stream and f32 input rows the
    kernel reads from device memory (gen_common._given_fits)."""
    if (not _common_gate(cfg, "rnn-nade") or batch < 1 or n_steps < 1
            or not _given_fits(cfg, n_given)):
        return False
    from multinn_torch.models import rnn_nade
    (k, d), u, nl = _eff_dims(cfg), cfg.n_rnn, cfg.rnn_layers
    params = _decoder_param_shapes(cfg, rnn_nade)
    st = torch.empty((nl, k, batch, u), device="meta")
    v0 = torch.empty((k, batch, d), device="meta")
    return _fits(_nade_args(params, st, st, v0))


def _resolve_spec(d: int) -> int:
    """The speculative depth of a D-dim sweep, as the JAX package resolves
    it: the deepest of 4, 2 and 1 that divides D."""
    return 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1


def auto_depth(dec_params, batch: int, aux_dtype=None) -> int:
    """The depth the kernel's sweep runs at B=``batch`` when generate_nade
    is given no ``spec``, from its launcher's plan (the gen_fused_plan op,
    which launches nothing; needs the card): 4 where 4 divides D and a CTA
    holds one (sample, track) group, else 1. ``aux_dtype`` as
    generate_nade takes it (None: the rule's at ``batch``)."""
    k, d, hid = dec_params.w.shape
    u, g = dec_params.wuh.shape[1], dec_params.cell[0].wh.shape[-1]
    aux_dtype = _resolve_aux(aux_dtype, dec_params, batch, 0)
    with torch.cuda.device(dec_params.w.device):
        return _build.ops().gen_fused_plan(
            1, k, d, hid, u, len(dec_params.cell), int(g == 4 * u), batch,
            int(aux_dtype == torch.bfloat16))[-1]


def _resolve_aux(aux_dtype, dec_params, batch: int,
                 n_given: int) -> torch.dtype:
    """generate_nade's aux storage: as given, or None: the reference's rule
    (``nade_aux_dtype``) at the whole batch and the given tracks, f32 where
    it runs its scan path. The rule charges the side table of the depth
    the reference's dispatch runs, ``_resolve_spec(D)``, whatever depth is
    asked for, so that every depth stores the same and returns the same
    roll."""
    dims = gen_common.dims_of_params(dec_params)
    return gen_common.resolve_storage(
        aux_dtype, lambda: _reference_dtype(dims, batch, n_given,
                                            _resolve_spec(dims.d)),
        "aux_dtype")


def generate_nade(key: torch.Tensor, dec_params, h0, c0, v0, n_steps: int,
                  impl=None, aux_dtype=None, given=None,
                  given_tracks: Tuple[int, ...] = (), rows=None,
                  spec: Optional[int] = None):
    """Run the whole generation. dec_params: track-STACKED rnn_nade.Params;
    h0/c0: (L, K, B, U) ((K, B, U) for one layer); v0: (K, B, D);
    ``given`` (B, n_steps, K, D) with ``given_tracks``: those tracks' frames
    replace the sampled ones (accompaniment); ``rows``: the row map (b0,
    B_global), under which sample b draws the counters (i*8 + k)*B_global +
    b0 + b of sample b0 + b (kernel_prng.row_map). Returns (roll (B,
    n_steps, K, D) float32, h_final (L, K, B, U), c_final (L, K, B, U)).

    ``spec``: the sweep's speculative depth, 1, 2 or 4 dividing D; every
    depth returns the same roll, h and c. None: the kernel's auto depth,
    which its launcher resolves (gen_fused_plan reports it); the plain
    version resolves it through ``_resolve_spec(D)``, the JAX package's
    rule.
    ``aux_dtype``: the storage dtype of wuh, wh and wx_r, float32 or
    bfloat16; None: ``nade_aux_dtype``'s rule at the whole batch
    (B_global under a row map) and the given tracks, the same at every
    depth.
    ``impl``: None = the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; "cuda" / "plain" force one."""
    n_layers = len(dec_params.cell)
    if h0.dim() == 3 and n_layers == 1:
        h0, c0 = h0[None], c0[None]
    given_tracks = tuple(sorted(set(int(t) for t in given_tracks)))
    if (given is None) != (not given_tracks):
        raise ValueError("given and given_tracks must be passed together")
    k, d, _ = dec_params.w.shape
    if k > STREAM_ROWS:
        raise ValueError(f"generate_nade: K={k} tracks; the random stream "
                         f"holds {STREAM_ROWS} per dim")
    if spec is not None and (spec not in SPECS or d % spec):
        raise ValueError(f"spec={spec} must be one of {SPECS} and divide "
                         f"D={d}")
    b = h0.shape[2]
    rmap = kernel_prng.row_map(b, rows)
    aux_dtype = _resolve_aux(aux_dtype, dec_params, rmap[1],
                             len(given_tracks))
    args = _nade_args(dec_params, h0, c0, v0, aux_dtype)
    u, g = args.wuv.shape[1], args.wx_v.shape[2]
    lstm = g == 4 * u
    seeds = key_to_seeds(key).to(args.bv.device)
    wxg = None
    if given is not None:
        given = given.reshape(b, n_steps, k * d).to(torch.float32).contiguous()
        wxg = dec_params.cell[0].wx[:, :d, :].contiguous()
    if _build.impl_for(impl, args.bv) == "cuda":
        roll, h_out, c_out = _generate_cuda(seeds, args, n_steps, lstm, given,
                                            given_tracks, wxg, rmap, spec)
    else:
        roll, h_out, c_out = _generate_plain(
            seeds, args, n_steps, lstm, given, given_tracks, wxg, rmap,
            _resolve_spec(d) if spec is None else spec)

    return (roll.reshape(b, n_steps, k, d),
            _from_state_rows(h_out, n_layers, k, u),
            _from_state_rows(c_out, n_layers, k, u))


def _generate_cuda(seeds, args: NadeArgs, n_steps, lstm, given, given_tracks,
                   wxg, rmap, spec):
    if not _fits(args):
        raise ValueError(
            f"generate_nade: one sample needs {_sample_bytes(args)} "
            f"bytes of shared memory (limit {SMEM_LIMIT_BYTES}), or H > "
            f"{MAX_HIDDEN} or D > {MAX_DIMS}; gen_fused.supported_nade "
            f"refuses this config — use the scan path")
    b = args.h0.shape[0]
    kd = args.v0.shape[1]
    dev = args.bv.device
    roll = torch.empty((b, n_steps, kd), device=dev)
    h_out, c_out = torch.empty_like(args.h0), torch.empty_like(args.c0)
    none = torch.empty(0, device=dev)
    mask = sum(1 << t for t in given_tracks)
    opt = lambda x: none if x is None else x
    with torch.cuda.device(dev):
        _build.launches["gen_fused_nade"] += 1
        _build.ops().gen_fused_nade(
            roll, h_out, c_out, args.w, args.v, args.wuv, args.wuh, args.bv,
            args.bh, args.wx_v, opt(wxg), opt(args.wx_r), args.wh,
            opt(args.wctx), args.b, args.h0, args.c0, args.v0, opt(given),
            seeds, int(lstm), spec or 0, mask, *rmap,
            _build.stream_of(args.bv))
    return roll, h_out, c_out


def _generate_plain(seeds, args: NadeArgs, n_steps, lstm, given,
                    given_tracks, wxg, rmap=None, spec=1):
    """Plain PyTorch version of the kernel, same signature and stream.
    Track-major (K, B, X) tensors; torch.matmul batches over the tracks.
    z grows one dim at a time, in increasing i, as the kernel's gather
    over the sampled frame's active dims adds it: z is not v @ Wx
    afterwards, whose reordered sum would change h and c in the last bits
    and later flip a draw. ``spec``, the depth asked for, does not change
    the function: every depth is the sequential sweep's, which this runs."""
    if spec not in SPECS or args.w.shape[1] % spec:
        raise ValueError(f"spec={spec} must be one of {SPECS} and divide D")
    k, d, hid = args.w.shape
    n_layers, _, u, g = args.wh.shape
    b = args.h0.shape[0]
    dev = args.bv.device
    s0, s1 = (int(s) & kernel_prng.MASK for s in seeds.tolist())
    w, v, wuv, wx_v, wuh = (x.float() for x in (args.w, args.v, args.wuv,
                                                 args.wx_v, args.wuh))
    wh = args.wh.float()
    wx_r = None if args.wx_r is None else args.wx_r.float()
    wctx = None if args.wctx is None else args.wctx.float()
    # counter of (dim i, track k, sample b): (i*8 + k)*B + b, as (K, B, D),
    # of sample b0 + b of B_global under the row map
    b0, total = rmap if rmap is not None else (0, b)
    ctr = ((torch.arange(d, device=dev) * STREAM_ROWS
            + torch.arange(k, device=dev)[:, None, None]) * total
           + b0 + torch.arange(b, device=dev)[:, None])

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
        bv_row = bv + h[-1] @ wuv                          # (K, B, D)
        act = bh + h[-1] @ wuh                             # (K, B, H)
        unif = kernel_prng.uniform_from_bits(kernel_prng.bits_at_plain(
            s0, (s1 + t) & kernel_prng.MASK, ctr))
        z = torch.zeros(k, b, g, device=dev)
        xs = []
        for i in range(d):
            s = (torch.sigmoid(act) @ v[:, i, :, None])[..., 0]    # (K, B)
            x = (unif[..., i] < torch.sigmoid(s + bv_row[..., i])
                 ).to(torch.float32)
            xs.append(x)
            act = act + x[..., None] * w[:, i, None, :]
            z = z + x[..., None] * wx_v[:, i, None, :]
        v_new = torch.stack(xs, dim=-1)                    # (K, B, D)
        if given is not None:
            v_new = torch.where(gmask, track_major(given[:, t], d), v_new)
            z = torch.where(gmask, v_new @ wxg, z)
        frames.append(v_new.transpose(0, 1).reshape(b, k * d))
        for l in range(n_layers):
            if l == 0:
                zin = z
                if wctx is not None:
                    prev = v_prev.transpose(0, 1).reshape(b, k * d)
                    ctx = torch.zeros(b, k * g, device=dev)
                    for j in range(k):
                        ctx = ctx + prev[:, j * d:(j + 1) * d] @ wctx[
                            j * d:(j + 1) * d]
                    zin = zin + track_major(ctx, g)
            else:
                zin = h[l - 1] @ wx_r[l - 1]
            zz = (zin + h[l] @ wh[l]) + args.b[l].reshape(k, 1, g)
            if lstm:
                st = rnn_nn._lstm_gates(c[l], zz)
                h[l], c[l] = st.h, st.c
            else:
                h[l] = torch.tanh(zz)
        v_prev = v_new

    def rows(xs):                          # L x (K, B, U) -> (B, L*K*U)
        return torch.stack(xs).permute(2, 0, 1, 3).reshape(b, -1)

    return torch.stack(frames, dim=1), rows(h), rows(c)
