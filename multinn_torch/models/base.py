"""Decoder contract and shared recurrent plumbing — port of
multinn_tpu/models/base.py.

Functions take a single decoder's params (leaves (X, Y), states (B, X)) or
a TRACK-STACKED decoder (a leading K axis on every leaf, states (K, B, X))
where the JAX package vmaps over tracks; see nn/rnn.py for the broadcasting
convention. Time-major tensors put T first: (T, [K,] B, X).

Under a mesh the training recurrence takes ``seq`` (parallel/seqpipe.py:
this rank's time chunk, the carry pipelined over the ``seq`` axis) and
``model_group`` (the ``model`` axis: bh and wuh hold this rank's H
columns, so the hidden-bias product is column-local and the RNN state
enters it through Megatron's copy, whose backward sums the ranks' partial
cotangents).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from multinn_torch.nn import rnn as rnn_nn
from multinn_torch.ops import sampling
from multinn_torch.ops.precision import mm
from multinn_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Shared decoder hyperparameters (field names and defaults as the JAX
    package's DecoderConfig)."""

    n_visible: int
    n_hidden: int = 150
    n_rnn: int = 100
    n_ctx: int = 0
    cell: str = "lstm"
    rnn_layers: int = 1
    cd_k: int = 1
    gen_k: int = 10
    w_std: float = 0.01
    remat: bool = False


def get_decoder(name: str):
    """Decoder registry: name -> module implementing the contract."""
    key = name.lower().replace("_", "-")
    if key in ("rnn-rbm", "rnnrbm"):
        from multinn_torch.models import rnn_rbm
        return rnn_rbm
    if key in ("rnn-nade", "rnnnade"):
        from multinn_torch.models import rnn_nade
        return rnn_nade
    raise ValueError(f"Unknown decoder '{name}'; available: rnn-rbm, rnn-nade")


def rnn_input(x: torch.Tensor, ctx: Optional[torch.Tensor]) -> torch.Tensor:
    """Concatenate visible features with optional conditioning context."""
    if ctx is None:
        return x
    return torch.cat([x, ctx], dim=-1)


def init_recurrent_state(state_cls, cfg: DecoderConfig, batch_shape,
                         device=None):
    return state_cls(
        cell=rnn_nn.stacked_zero_state(cfg.cell, batch_shape, cfg.n_rnn,
                                       cfg.rnn_layers, device=device),
        v_prev=torch.zeros((*batch_shape, cfg.n_visible), device=device))


def scan_states(params, state, x_tm: torch.Tensor, seq=None):
    """Run the cell stack over time-major inputs; return (final_cell_state,
    u_prev) where u_prev[t] is the TOP layer's hidden state before x[t].
    ``seq`` (parallel.seqpipe.SeqSpec) switches to the time-sharded
    pipeline, which always starts from the zero state and returns (None,
    u_prev); callers with a primed state must not pass it."""
    cfg = params.cfg
    if seq is not None:
        from multinn_torch.parallel import seqpipe
        return seqpipe.scan_states_pipelined(params, x_tm, seq)
    final, us = rnn_nn.stacked_scan(cfg.cell, params.cell, state.cell, x_tm,
                                    remat=cfg.remat)
    u0 = rnn_nn.state_h(state.cell[-1])
    return final, torch.cat([u0[None], us[:-1]], dim=0)


def conditioned_biases(params, u_prev: torch.Tensor, model_group=None):
    """bv(t) = bv + u(t-1) @ Wuv;  bh(t) = bh + u(t-1) @ Wuh (products
    under the matmul policy). Under ``model_group`` bh and Wuh hold this
    rank's H columns, and u enters their product through Megatron's
    copy."""
    u_h = comm.copy_to_model(u_prev, model_group)
    return (params.bv.unsqueeze(-2) + mm(u_prev, params.wuv),
            params.bh.unsqueeze(-2) + mm(u_h, params.wuh))


def teacher_forced(params, x: torch.Tensor, ctx: Optional[torch.Tensor],
                   seq=None, model_group=None):
    """The training recurrence from a zero state: x ([K,] B, T, F), ctx
    with x's leading dims -> (x_tm, bv_t, bh_t), time-major (T, [K,] B, .),
    with the biases conditioned on u(t-1). ``seq``: x is this rank's time
    chunk (parallel/seqpipe.py); ``model_group``: bh_t holds this rank's H
    columns."""
    cfg = params.cfg
    x_tm = x.movedim(-2, 0)
    ctx_tm = None if ctx is None else ctx.movedim(-2, 0)
    x_in = rnn_input(x_tm, ctx_tm)
    if seq is not None:
        from multinn_torch.parallel import seqpipe
        _, u_prev = seqpipe.scan_states_pipelined(params, x_in, seq)
    else:
        zero = rnn_nn.stacked_zero_state(cfg.cell, x.shape[:-2], cfg.n_rnn,
                                         cfg.rnn_layers, device=x.device)
        _, us = rnn_nn.stacked_scan(cfg.cell, params.cell, zero, x_in,
                                    remat=cfg.remat)
        u_prev = torch.cat([torch.zeros_like(us[:1]), us[:-1]], dim=0)
    bv_t, bh_t = conditioned_biases(params, u_prev, model_group)
    return x_tm, bv_t, bh_t


def time_major_mask(frame_mask: Optional[torch.Tensor], stacked: bool):
    """A (B, T) frame mask -> float (T, B), or (T, 1, B) against
    track-stacked (T, K, B) values; None stays None."""
    if frame_mask is None:
        return None
    m = frame_mask.t().float()
    return m[:, None] if stacked else m


def frame_mean(v: torch.Tensor, m_tm: Optional[torch.Tensor] = None):
    """Mean of v (T, [K,] B) over time and batch — per track when
    stacked — or, with a mask, sum(v * m) / max(sum(m), 1)."""
    if m_tm is None:
        return v.mean(dim=(0, -1))
    return ((v * m_tm).sum(dim=(0, -1))
            / torch.clamp(m_tm.sum(dim=(0, -1)), min=1.0))


def per_track(fn, params, key, x_tm, bv_t, bh_t, dim: int = 0):
    """``fn(key, x, params, bv, bh)`` on one decoder's time-major tensors,
    or, for track-stacked params (keys (K, 2), tensors (T, K, ...)), on
    each track's slice with its own key; the results are stacked on
    ``dim`` (dicts per entry). This is where the port loops over tracks:
    the kernels and the monitoring draws take one decoder at a time."""
    if params.w.dim() == 2:
        return fn(key, x_tm, params, bv_t, bh_t)
    outs = [fn(key[i], x_tm[:, i], index_params(params, i), bv_t[:, i],
               bh_t[:, i]) for i in range(params.w.shape[0])]
    if isinstance(outs[0], dict):
        return {k: torch.stack([o[k] for o in outs], dim=dim)
                for k in outs[0]}
    return torch.stack(outs, dim=dim)


def index_params(params, i: int):
    """Track i's decoder weights (the cell stays stacked: the per-track
    functions use only the frame model's tensors)."""
    return dataclasses.replace(params, **{
        f.name: getattr(params, f.name)[i] for f in dataclasses.fields(params)
        if f.name not in ("cell", "cfg")})


def prime_state(state_cls, params, state, x: torch.Tensor,
                ctx: Optional[torch.Tensor] = None):
    """Advance the RNN state over a seed sequence x: ([K,] B, T, F); ctx
    has x's leading dims."""
    x_tm = x.movedim(-2, 0)
    ctx_tm = None if ctx is None else ctx.movedim(-2, 0)
    final, _ = rnn_nn.stacked_scan(params.cfg.cell, params.cell, state.cell,
                                   rnn_input(x_tm, ctx_tm))
    return state_cls(cell=final, v_prev=x[..., -1, :])


def forced_step(state_cls, params, state, v: torch.Tensor,
                ctx: Optional[torch.Tensor] = None):
    """Advance the RNN state ONE step with a given frame v ([K,] B, F)."""
    new_cell = rnn_nn.stacked_step(params.cfg.cell, params.cell, state.cell,
                                   rnn_input(v, ctx))
    return state_cls(cell=new_cell, v_prev=v)


def generate_scan(sample_step_fn, params, key, state, n_steps: int,
                  ctx: Optional[torch.Tensor] = None, k: Optional[int] = None):
    """Autoregressive generation: a loop over
    ``sample_step_fn(params, key, state, ctx, k)`` with key t of
    ``split(key, n_steps)``. ctx: optional (B, n_steps, C)."""
    keys = sampling.split(key, n_steps)
    vs = []
    for t in range(n_steps):
        c = None if ctx is None else ctx[:, t]
        state, v = sample_step_fn(params, keys[t], state, c, k)
        vs.append(v)
    return state, torch.stack(vs).movedim(0, -2)
