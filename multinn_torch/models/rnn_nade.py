"""RNN-NADE decoder — port of multinn_tpu/models/rnn_nade.py.

A NADE over each frame v(t) whose biases are conditioned on the hidden
state of a deterministic RNN that consumed frames < t:

    bv(t) = bv + u(t-1) @ Wuv          bh(t) = bh + u(t-1) @ Wuh
    u(t)  = Cell(u(t-1), [v(t); ctx(t)])

Params and State may be track-stacked (leading K axis), except in
``sample_frame``, whose sweep takes one decoder's W and V. Training is
exact maximum likelihood: ``loss`` and ``log_likelihood`` take one decoder
with x (B, T, F) or track-stacked params with x (K, B, T, F), and one
launch of the grid-free likelihood kernels (ops/nade_ll.py) covers every
track and frame.

Under a mesh's ``model`` axis (``shard.model``) w, v, bh and wuh hold this
rank's H columns: the kernels run with bv = 0, so their logits are this
rank's partial sums over its columns; Megatron's all-reduce completes
them and bv(t) is added after. ``seq``: x is this rank's time chunk
(parallel/seqpipe.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from multinn_torch.models import base
from multinn_torch.models.base import DecoderConfig
from multinn_torch.nn import nade as nade_nn
from multinn_torch.nn import rnn as rnn_nn
from multinn_torch.ops import nade_ops
from multinn_torch.parallel import comm
from multinn_torch.training.metrics import (FRAME_COUNTS, frame_counts,
                                            frame_ratios)


@dataclasses.dataclass
class Params:
    cell: tuple             # per layer: rnn_nn.LSTMParams | VanillaRNNParams
    w: torch.Tensor         # (F, H) NADE encode weights
    v: torch.Tensor         # (F, H) NADE decode weights
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
        v=normal((f, h)),
        bv=torch.zeros(f, device=device),
        bh=torch.zeros(h, device=device),
        wuv=normal((u, f)),
        wuh=normal((u, h)),
        cfg=cfg)


def init_state(params: Params, batch_shape: Tuple[int, ...]) -> State:
    return base.init_recurrent_state(State, params.cfg, batch_shape,
                                     device=params.w.device)


def _tracks_first(stacked: bool, *ts):
    """(T, K, ...) -> (K, T, ...) for the likelihood ops' track-stacked
    layout; one decoder's tensors pass as they are."""
    return tuple(t.movedim(1, 0) for t in ts) if stacked else ts


def _model_logits(logits_fn, bv, model_group):
    """``logits_fn(bv)`` as one rank of ``model_group`` computes it: the
    partial logits of its H columns at bv = 0, summed over the ranks, plus
    bv; without a group ``logits_fn(bv)`` itself."""
    if model_group is None:
        return logits_fn(bv)
    return comm.reduce_from_model(logits_fn(torch.zeros_like(bv)),
                                  model_group) + bv


def _log_probs(params: Params, x_tm, bv_t, bh_t, need_logits: bool,
               impl=None, model_group=None):
    """Exact per-frame log-likelihoods (T, [K,] B) and, when asked, the
    conditional logits (T, [K,] B, F) they come from."""
    stacked = params.w.dim() == 3
    xk, bvk, bhk = _tracks_first(stacked, x_tm, bv_t, bh_t)
    logits = _model_logits(
        lambda bv: nade_ops.nade_conditionals_logits(
            xk, params.w, params.v, bv, bhk, impl=impl), bvk, model_group)
    ll = nade_nn.bernoulli_ll(logits, xk).sum(dim=-1)
    ll, logits = _tracks_first(stacked, ll, logits)
    return ll, (logits if need_logits else None)


def _nll(params: Params, x: torch.Tensor, ctx: Optional[torch.Tensor],
         frame_mask: Optional[torch.Tensor] = None, need_logits=False,
         impl=None, shard=None, seq=None):
    """Mean per-frame negative log-likelihood (per track when stacked),
    with the time-major inputs and, with ``need_logits``, the logits."""
    mg = None if shard is None else shard.model
    x_tm, bv_t, bh_t = base.teacher_forced(params, x, ctx, seq, mg)
    ll, logits = _log_probs(params, x_tm, bv_t, bh_t, need_logits, impl, mg)
    m_tm = base.time_major_mask(frame_mask, params.w.dim() == 3)
    return -base.frame_mean(ll, m_tm), (x_tm, logits)


def loss(params: Params, key: torch.Tensor, x: torch.Tensor,
         ctx: Optional[torch.Tensor] = None, detailed: bool = True,
         frame_mask: Optional[torch.Tensor] = None, impl=None, shard=None,
         seq=None):
    """Exact NLL loss. ``key`` is unused (kept for the decoder contract).
    Returns (loss, metrics), per track when stacked. ``detailed=False``
    skips the frame metrics (hot path); ``frame_mask`` (B, T) excludes
    padded frames. ``impl`` forces the likelihood kernels or their plain
    versions; ``shard`` / ``seq``: a mesh's part (module docstring); rows
    split over ``data`` add their frame counts (``metrics.FRAME_COUNTS``).
    """
    del key
    nll, (x_tm, logits) = _nll(params, x, ctx, frame_mask,
                               need_logits=detailed, impl=impl, shard=shard,
                               seq=seq)
    if not detailed:
        return nll, {"loss": nll.detach()}
    m2 = base.time_major_mask(frame_mask, False)
    with torch.no_grad():
        probs = torch.sigmoid(logits)
        if params.w.dim() == 3:
            counts = torch.stack([frame_counts(probs[:, i], x_tm[:, i],
                                               mask=m2)
                                  for i in range(probs.shape[1])])
        else:
            counts = frame_counts(probs, x_tm, mask=m2)
        metrics = frame_ratios(counts)
    if shard is not None and shard.rows is not None:
        metrics[FRAME_COUNTS] = counts
    metrics["nll"] = nll.detach()
    metrics["loss"] = nll.detach()
    return nll, metrics


def conditional_logits(params: Params, x: torch.Tensor,
                       ctx: Optional[torch.Tensor] = None, shard=None,
                       seq=None) -> torch.Tensor:
    """Teacher-forced per-dim conditional logits, time-major (T, [K,] B, F),
    in the parallel cumsum form (the linearization point of Hessian-free
    training, which is forward-mode: the kernels' Function has no jvp)."""
    stacked = params.w.dim() == 3
    mg = None if shard is None else shard.model
    x_tm, bv_t, bh_t = base.teacher_forced(params, x, ctx, seq, mg)
    xk, bvk, bhk = _tracks_first(stacked, x_tm, bv_t, bh_t)
    (logits,) = _tracks_first(stacked, _model_logits(
        lambda bv: nade_nn.conditionals_logits(xk, params.w, params.v, bv,
                                               bhk, form="cumsum"),
        bvk, mg))
    return logits


def log_likelihood(params: Params, key: torch.Tensor, x: torch.Tensor,
                   ctx: Optional[torch.Tensor] = None,
                   frame_mask: Optional[torch.Tensor] = None, shard=None,
                   seq=None) -> torch.Tensor:
    """Exact per-sequence log-likelihood ([K,] B), summed over the real
    frames (this rank's under ``seq``)."""
    del key
    mg = None if shard is None else shard.model
    x_tm, bv_t, bh_t = base.teacher_forced(params, x, ctx, seq, mg)
    ll, _ = _log_probs(params, x_tm, bv_t, bh_t, False, model_group=mg)
    m_tm = base.time_major_mask(frame_mask, params.w.dim() == 3)
    if m_tm is not None:
        ll = ll * m_tm
    return ll.sum(dim=0)


# the trainer treats both decoder families alike
log_likelihood_proxy = log_likelihood


def prime(params: Params, state: State, x: torch.Tensor,
          ctx: Optional[torch.Tensor] = None) -> State:
    """Advance the RNN state over a seed sequence x: ([K,] B, T, F)."""
    return base.prime_state(State, params, state, x, ctx)


def tempered_params(params: Params, temperature: float) -> Params:
    """Exact per-conditional temperature: each conditional's logit is
    bv_i(t) + V_i . h_i, and h_i depends only on w, bh and wuh, so scaling
    {v, bv, wuv} by 1/T gives sigmoid(logit / T). T=1 returns ``params``
    unchanged."""
    if temperature == 1.0:
        return params
    if temperature <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    b = 1.0 / temperature
    return dataclasses.replace(params, v=params.v * b, bv=params.bv * b,
                               wuv=params.wuv * b)


def sample_frame(params: Params, key: torch.Tensor, state: State,
                 k: Optional[int] = None, rows=None) -> torch.Tensor:
    """Ancestral NADE sample at biases from u(t-1), without advancing the
    state. One decoder (not track-stacked); ``k`` is ignored (NADE sampling
    is exact); ``rows``: the row map (b0, B_global) of a data shard."""
    del k
    u_prev = rnn_nn.state_h(state.cell[-1])
    bv_t, bh_t = base.conditioned_biases(params, u_prev)
    return nade_ops.nade_sample(key, params.w, params.v, bv_t, bh_t,
                                batch_shape=tuple(u_prev.shape[:-1]),
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
