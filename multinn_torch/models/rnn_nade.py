"""RNN-NADE decoder — port of multinn_tpu/models/rnn_nade.py (generation
half; the exact-likelihood loss waits for the training slice).

A NADE over each frame v(t) whose biases are conditioned on the hidden
state of a deterministic RNN that consumed frames < t:

    bv(t) = bv + u(t-1) @ Wuv          bh(t) = bh + u(t-1) @ Wuh
    u(t)  = Cell(u(t-1), [v(t); ctx(t)])

Params and State may be track-stacked (leading K axis), except in
``sample_frame``, whose sweep takes one decoder's W and V.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from multinn_torch.models import base
from multinn_torch.models.base import DecoderConfig
from multinn_torch.nn import rnn as rnn_nn
from multinn_torch.ops import nade_ops


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
                 k: Optional[int] = None) -> torch.Tensor:
    """Ancestral NADE sample at biases from u(t-1), without advancing the
    state. One decoder (not track-stacked); ``k`` is ignored (NADE sampling
    is exact)."""
    del k
    u_prev = rnn_nn.state_h(state.cell[-1])
    bv_t, bh_t = base.conditioned_biases(params, u_prev)
    return nade_ops.nade_sample(key, params.w, params.v, bv_t, bh_t,
                                batch_shape=tuple(u_prev.shape[:-1]))


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
