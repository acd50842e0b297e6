"""RNN-RBM decoder — port of multinn_tpu/models/rnn_rbm.py (generation
half; the CD loss and likelihood wait for the training slice).

An RBM over each frame v(t) whose biases are conditioned on the hidden
state of a deterministic RNN that consumed frames < t:

    bh(t) = bh + u(t-1) @ Wuh          bv(t) = bv + u(t-1) @ Wuv
    u(t)  = Cell(u(t-1), [v(t); ctx(t)])

Params and State may be track-stacked (leading K axis), except in
``sample_frame``, whose Gibbs chain takes one decoder's W.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from multinn_torch.models import base
from multinn_torch.models.base import DecoderConfig
from multinn_torch.nn import rnn as rnn_nn
from multinn_torch.ops import gibbs as gibbs_ops


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
                 k: Optional[int] = None) -> torch.Tensor:
    """Gibbs-sample v(t) at biases from u(t-1), chain started at v(t-1),
    without advancing the state. One decoder (not track-stacked)."""
    k = params.cfg.gen_k if k is None else k
    u_prev = rnn_nn.state_h(state.cell[-1])
    bv_t, bh_t = base.conditioned_biases(params, u_prev)
    return gibbs_ops.gibbs_chain(key, state.v_prev, params.w, bv_t, bh_t, k)


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
