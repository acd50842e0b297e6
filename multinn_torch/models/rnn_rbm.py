"""RNN-RBM decoder — port of multinn_tpu/models/rnn_rbm.py.

An RBM over each frame v(t) whose biases are conditioned on the hidden
state of a deterministic RNN that consumed frames < t:

    bh(t) = bh + u(t-1) @ Wuh          bv(t) = bv + u(t-1) @ Wuv
    u(t)  = Cell(u(t-1), [v(t); ctx(t)])

Params and State may be track-stacked (leading K axis), except in
``sample_frame``, whose Gibbs chain takes one decoder's W. ``loss`` and
``log_likelihood_proxy`` take either one decoder with one key and x
(B, T, F), or track-stacked params with keys (K, 2) and x (K, B, T, F);
they run the recurrence batched over tracks and the Gibbs chain (and the
monitoring draws) per track, each on its own key, where the JAX package
vmaps over tracks.

Under a mesh (``shard``: parallel.mesh.Shard of a global-view step) the
chain and the monitoring draws take the stream of their rows in the whole
batch (the row map), a data split returns its frame counts for the
trainer to sum (training/metrics.FRAME_COUNTS), and
under the ``model`` axis, where w, bh and wuh hold this rank's H columns,
the free energy's softplus sum over H is completed across the ranks —
their softplus columns gathered and summed in the single-device order, so
the free energies equal one device's bit for bit (the CD loss is a small
difference of two near-equal free energies, which a sum of per-rank
partial sums would move by 2e-5 of itself) — and the chain (and the
monitoring draws) run on W's and bh(t)'s gathered columns, unsharded on
each rank: exact, and on the unsharded stream. ``seq``: x is this rank's time chunk (parallel/seqpipe.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from multinn_torch.models import base
from multinn_torch.models.base import DecoderConfig
from multinn_torch.nn import rbm as rbm_nn
from multinn_torch.nn import rnn as rnn_nn
from multinn_torch.ops import gibbs as gibbs_ops
from multinn_torch.ops import sampling
from multinn_torch.ops.precision import mm
from multinn_torch.parallel import comm
from multinn_torch.training.metrics import (FRAME_COUNTS,
                                            binary_cross_entropy,
                                            frame_counts, frame_ratios)


@dataclasses.dataclass
class Params:
    cell: tuple             # per layer: rnn_nn.LSTMParams | VanillaRNNParams
    w: torch.Tensor         # (F, H) RBM weights
    bv: torch.Tensor        # (F,)
    bh: torch.Tensor        # (H,)
    wuv: torch.Tensor       # (U, F) state -> visible-bias conditioning
    wuh: torch.Tensor       # (U, H) state -> hidden-bias conditioning
    cfg: DecoderConfig


@dataclasses.dataclass
class State:
    """Carried generation/priming state: RNN state + previous frame."""
    cell: tuple
    v_prev: torch.Tensor    # (..., F)


def init(cfg: DecoderConfig, generator=None, device=None) -> Params:
    f, h, u = cfg.n_visible, cfg.n_hidden, cfg.n_rnn
    normal = lambda shape: cfg.w_std * torch.randn(
        shape, generator=generator, device=device)
    return Params(
        cell=rnn_nn.stacked_init(cfg.cell, f + cfg.n_ctx, u, cfg.rnn_layers,
                                 generator=generator, w_std=cfg.w_std,
                                 device=device),
        w=normal((f, h)),
        bv=torch.zeros(f, device=device),
        bh=torch.zeros(h, device=device),
        wuv=normal((u, f)),
        wuh=normal((u, h)),
        cfg=cfg)


def init_state(params: Params, batch_shape: Tuple[int, ...]) -> State:
    return base.init_recurrent_state(State, params.cfg, batch_shape,
                                     device=params.w.device)


def _free_energy(v, w, bv, bh, model_group=None) -> torch.Tensor:
    """rbm.free_energy with bh / w holding this rank's H columns under
    ``model_group``: the softplus columns of every rank gathered, then
    summed over H as one device sums them."""
    if model_group is None:
        return rbm_nn.free_energy(v, w, bv, bh)
    hid = comm.gather_from_model(F.softplus(mm(v, w) + bh), -1, model_group)
    return -torch.sum(v * bv, dim=-1) - torch.sum(hid, dim=-1)


def _full_hidden(params: Params, bh_t: torch.Tensor, model_group):
    """Params and bh(t) with the H columns of every rank of
    ``model_group``, detached (the chain and the monitoring draws)."""
    if model_group is None:
        return params, bh_t
    gather = lambda t: comm.gather_cat(t.detach().contiguous(), -1,
                                       model_group)
    return (dataclasses.replace(params, w=gather(params.w),
                                bh=gather(params.bh)), gather(bh_t))


def loss(params: Params, key: torch.Tensor, x: torch.Tensor,
         ctx: Optional[torch.Tensor] = None, detailed: bool = True,
         frame_mask: Optional[torch.Tensor] = None, impl=None, shard=None,
         seq=None):
    """CD-k loss, teacher forced. x: ([K,] B, T, F); ctx: x's leading dims
    and (T, C); frame_mask: (B, T), shared by the tracks. Returns (loss,
    metrics), per track when stacked. Gradient reaches the RNN through the
    conditioned biases of both free-energy terms, never through the chain.
    Keys per decoder: ``k1, k2, k3 = split(key, 3)`` (chain,
    reconstruction, pseudo-likelihood). ``detailed=False`` is the hot path
    (loss only); ``impl`` forces the chain's kernel or its plain version;
    ``shard`` / ``seq``: a mesh's part (module docstring); rows split over
    ``data`` add their frame counts (``metrics.FRAME_COUNTS``)."""
    cfg = params.cfg
    stacked = params.w.dim() == 3
    mg = None if shard is None else shard.model
    rows = None if shard is None else shard.rows
    x_tm, bv_t, bh_t = base.teacher_forced(params, x, ctx, seq, mg)
    m_tm = base.time_major_mask(frame_mask, stacked)
    keys = (torch.stack([sampling.split(k, 3) for k in key]) if stacked
            else sampling.split(key, 3))                 # ([K,] 3, 2)
    p_full, bh_full = _full_hidden(params, bh_t, mg)

    def chain(kk, v0, p, bv, bh):
        return gibbs_ops.gibbs_chain(kk[0], v0, p.w.detach(), bv.detach(),
                                     bh.detach(), cfg.cd_k, impl=impl,
                                     rows=rows)

    with torch.no_grad():
        vk = base.per_track(chain, p_full, keys, x_tm, bv_t, bh_full, dim=1)
    fe = _free_energy(x_tm, params.w, bv_t, bh_t, mg)     # (T, [K,] B)
    cd = base.frame_mean(fe - _free_energy(vk, params.w, bv_t, bh_t, mg),
                         m_tm)
    if not detailed:
        return cd, {"loss": cd.detach()}

    m2 = base.time_major_mask(frame_mask, False)

    def monitor(kk, v0, p, bv, bh):
        recon = rbm_nn.reconstruction(kk[1], v0, p.w, bv, bh, k=cfg.cd_k,
                                      rows=rows)
        counts = frame_counts(recon, v0, mask=m2)
        out = frame_ratios(counts)
        if rows is not None:
            out[FRAME_COUNTS] = counts
        out["bce_recon"] = binary_cross_entropy(recon, v0, mask=m2)
        out["pll"] = base.frame_mean(rbm_nn.pseudo_log_likelihood(
            kk[2], v0, p.w, bv, bh, rows=rows), m2)
        return out

    with torch.no_grad():
        metrics = base.per_track(monitor, p_full, keys, x_tm, bv_t, bh_full)
        metrics["free_energy"] = base.frame_mean(fe, m_tm)
    metrics["loss"] = cd.detach()
    return cd, metrics


def log_likelihood_proxy(params: Params, key: torch.Tensor, x: torch.Tensor,
                         ctx: Optional[torch.Tensor] = None,
                         frame_mask: Optional[torch.Tensor] = None,
                         shard=None, seq=None) -> torch.Tensor:
    """Per-sequence pseudo-LL (the RBM's LL is intractable), summed over
    the real frames (this rank's under ``seq``): ([K,] B)."""
    stacked = params.w.dim() == 3
    mg = None if shard is None else shard.model
    rows = None if shard is None else shard.rows
    x_tm, bv_t, bh_t = base.teacher_forced(params, x, ctx, seq, mg)
    p_full, bh_full = _full_hidden(params, bh_t, mg)
    pll = base.per_track(
        lambda kk, v0, p, bv, bh: rbm_nn.pseudo_log_likelihood(
            kk, v0, p.w, bv, bh, rows=rows),
        p_full, key, x_tm, bv_t, bh_full, dim=1)          # (T, [K,] B)
    m_tm = base.time_major_mask(frame_mask, stacked)
    if m_tm is not None:
        pll = pll * m_tm
    return pll.sum(dim=0)


def prime(params: Params, state: State, x: torch.Tensor,
          ctx: Optional[torch.Tensor] = None) -> State:
    """Advance the RNN state over a seed sequence x: ([K,] B, T, F)."""
    return base.prime_state(State, params, state, x, ctx)


def tempered_params(params: Params, temperature: float) -> Params:
    """Exact sampling temperature: scaling {w, bv, bh, wuv, wuh} by 1/T
    makes every Gibbs conditional sigmoid(logit / T). T=1 returns
    ``params`` unchanged."""
    if temperature == 1.0:
        return params
    if temperature <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    b = 1.0 / temperature
    return dataclasses.replace(params, w=params.w * b, bv=params.bv * b,
                               bh=params.bh * b, wuv=params.wuv * b,
                               wuh=params.wuh * b)


def sample_frame(params: Params, key: torch.Tensor, state: State,
                 k: Optional[int] = None, rows=None) -> torch.Tensor:
    """Gibbs-sample v(t) at biases from u(t-1), chain started at v(t-1),
    without advancing the state. One decoder (not track-stacked).
    ``rows``: the row map (b0, B_global) of a data shard."""
    k = params.cfg.gen_k if k is None else k
    u_prev = rnn_nn.state_h(state.cell[-1])
    bv_t, bh_t = base.conditioned_biases(params, u_prev)
    return gibbs_ops.gibbs_chain(key, state.v_prev, params.w, bv_t, bh_t, k,
                                 rows=rows)


def forced_step(params: Params, state: State, v: torch.Tensor,
                ctx: Optional[torch.Tensor] = None) -> State:
    """Advance the cell one step with a given frame (teacher-forced)."""
    return base.forced_step(State, params, state, v, ctx)


def sample_step(params: Params, key: torch.Tensor, state: State,
                ctx: Optional[torch.Tensor] = None,
                k: Optional[int] = None) -> Tuple[State, torch.Tensor]:
    """One generation step: sample_frame, then forced_step."""
    v = sample_frame(params, key, state, k=k)
    return forced_step(params, state, v, ctx), v


def generate(params: Params, key: torch.Tensor, state: State, n_steps: int,
             ctx: Optional[torch.Tensor] = None,
             k: Optional[int] = None) -> Tuple[State, torch.Tensor]:
    """Autoregressive generation of one decoder: a loop of sample_step on
    key t of ``split(key, n_steps)``. ctx: optional (B, n_steps, C).
    Returns (state, v (B, n_steps, F))."""
    return base.generate_scan(sample_step, params, key, state, n_steps,
                              ctx, k)
