"""Recurrent cells and time-major runners — port of multinn_tpu/nn/rnn.py.

LSTM (gate order i, f, g, o; forget-gate bias 1 at init) and the paper's
vanilla tanh cell, plus stacked layers. The cell and hoisted input
products go through ``ops.precision.mm``, so they follow the bf16 matmul
policy where the trainer enters it.

Every function also takes TRACK-STACKED params — a leading K axis on every
leaf, inputs (K, B, in) — where the JAX package vmaps over tracks: products
batch over the leading axes, and biases enter as ``b.unsqueeze(-2)`` so
that (G,) and (K, G) both broadcast. Time-major sequences are (T, [K,] B,
in).

An LSTM layer's recurrence over its T steps is one autograd Function
(ops/lstm_scan.py: one forward and one backward kernel on the card, their
plain versions on the CPU) wherever it takes the inputs: float32 under the
f32 matmul policy, carrying no forward-mode tangents. Its backward
recomputes the gates from the saved carries and hoisted input products,
which is all the checkpointed loop keeps, so ``remat`` changes nothing
there.

The step loop runs the rest: the bf16 policy, ``torch.func.jvp`` (the
Hessian-free step's J v) and the vanilla cell. There ``remat`` (the
model's ``remat`` flag) checkpoints each step of a layer's scan
(``torch.utils.checkpoint``, non-reentrant): the backward recomputes a
step's gates from its carry and its hoisted input product instead of
keeping them, as the reference's ``jax.checkpoint`` of the scan body. The
recurrence draws no random numbers, so no RNG state is stashed (stashing
the CUDA RNG state is illegal while a graph is captured); the recompute
runs under the matmul policy of the forward.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from multinn_torch.ops import lstm_scan as lstm_ops
from multinn_torch.ops import precision
from multinn_torch.ops.precision import mm


def _normal(shape, std, generator, device):
    return std * torch.randn(shape, generator=generator, device=device)


@dataclasses.dataclass
class LSTMParams:
    """wx: (in, 4H); wh: (H, 4H); b: (4H,). Gate order: i, f, g, o."""
    wx: torch.Tensor
    wh: torch.Tensor
    b: torch.Tensor


@dataclasses.dataclass
class LSTMState:
    h: torch.Tensor
    c: torch.Tensor


def lstm_init(n_in: int, n_hidden: int, generator=None, w_std: float = 0.01,
              forget_bias: float = 1.0, device=None) -> LSTMParams:
    b = torch.zeros(4 * n_hidden, device=device)
    b[n_hidden:2 * n_hidden] = forget_bias
    return LSTMParams(
        wx=_normal((n_in, 4 * n_hidden), w_std, generator, device),
        wh=_normal((n_hidden, 4 * n_hidden), w_std, generator, device),
        b=b)


def lstm_zero_state(batch_shape, n_hidden: int, device=None) -> LSTMState:
    z = torch.zeros((*batch_shape, n_hidden), device=device)
    return LSTMState(h=z, c=z.clone())


def _lstm_gates(c, z) -> LSTMState:
    h, c_new = lstm_ops.cell(c, z)
    return LSTMState(h=h, c=c_new)


def lstm_step(params: LSTMParams, state: LSTMState, x) -> LSTMState:
    z = mm(x, params.wx) + mm(state.h, params.wh) + params.b.unsqueeze(-2)
    return _lstm_gates(state.c, z)


def _remat(fn, *args):
    """``fn(*args)`` with its intermediates recomputed in the backward."""
    name = "f32" if precision.matmul_dtype() is None else "bf16"
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          precision.matmul_precision(name)))


def _lstm_step_hc(c, h, xz_t, wh):
    st = _lstm_gates(c, xz_t + mm(h, wh))
    return st.h, st.c


def lstm_scan(params: LSTMParams, state: LSTMState, xs, remat: bool = False):
    """LSTM over time-major xs (T, ..., in) -> (final_state, hs (T, ..., H)),
    with the input projection of all T steps hoisted out of the recurrence
    (the Function or the step loop: module docstring)."""
    xz = mm(xs, params.wx) + params.b.unsqueeze(-2)
    if lstm_ops.takes(xz, params.wh, state.h, state.c):
        hbuf, cbuf = lstm_ops.lstm_recurrence(xz, params.wh, state.h,
                                              state.c)
        return LSTMState(h=hbuf[-1], c=cbuf[-1]), hbuf[1:]
    hs = []
    for xz_t in xz:
        if remat:
            h, c = _remat(_lstm_step_hc, state.c, state.h, xz_t, params.wh)
            state = LSTMState(h=h, c=c)
        else:
            state = _lstm_gates(state.c, xz_t + mm(state.h, params.wh))
        hs.append(state.h)
    return state, torch.stack(hs)


@dataclasses.dataclass
class VanillaRNNParams:
    wx: torch.Tensor   # (in, H)
    wh: torch.Tensor   # (H, H)
    b: torch.Tensor    # (H,)


@dataclasses.dataclass
class VanillaRNNState:
    h: torch.Tensor


def vanilla_init(n_in: int, n_hidden: int, generator=None,
                 w_std: float = 0.01, device=None) -> VanillaRNNParams:
    return VanillaRNNParams(
        wx=_normal((n_in, n_hidden), w_std, generator, device),
        wh=_normal((n_hidden, n_hidden), w_std, generator, device),
        b=torch.zeros(n_hidden, device=device))


def vanilla_zero_state(batch_shape, n_hidden: int, device=None):
    return VanillaRNNState(h=torch.zeros((*batch_shape, n_hidden),
                                         device=device))


def vanilla_step(params: VanillaRNNParams, state: VanillaRNNState, x):
    return VanillaRNNState(h=torch.tanh(
        mm(x, params.wx) + mm(state.h, params.wh) + params.b.unsqueeze(-2)))


def _vanilla_step_h(h, xz_t, wh):
    return torch.tanh(xz_t + mm(h, wh))


def vanilla_scan(params: VanillaRNNParams, state: VanillaRNNState, xs,
                 remat: bool = False):
    xz = mm(xs, params.wx) + params.b.unsqueeze(-2)
    hs = []
    for xz_t in xz:
        h = (_remat(_vanilla_step_h, state.h, xz_t, params.wh) if remat
             else _vanilla_step_h(state.h, xz_t, params.wh))
        state = VanillaRNNState(h=h)
        hs.append(state.h)
    return state, torch.stack(hs)


# stacked (multi-layer) cells: params/state are tuples of per-layer values;
# layer l + 1 consumes layer l's hidden trajectory

def stacked_init(cell_type: str, n_in: int, n_hidden: int, n_layers: int,
                 generator=None, w_std: float = 0.01, device=None):
    sizes = [n_in] + [n_hidden] * (n_layers - 1)
    init = CELLS[cell_type][0]
    return tuple(init(sizes[i], n_hidden, generator=generator, w_std=w_std,
                      device=device) for i in range(n_layers))


def stacked_zero_state(cell_type: str, batch_shape, n_hidden: int,
                       n_layers: int, device=None):
    zero = CELLS[cell_type][1]
    return tuple(zero(batch_shape, n_hidden, device=device)
                 for _ in range(n_layers))


def stacked_step(cell_type: str, params, states, x):
    step = CELLS[cell_type][2]
    new_states = []
    inp = x
    for p, st in zip(params, states):
        st = step(p, st, inp)
        new_states.append(st)
        inp = st.h
    return tuple(new_states)


def stacked_scan(cell_type: str, params, states, xs,
                 remat: bool = False) -> Tuple[tuple, object]:
    """All layers over time-major xs; ``remat`` checkpoints each step of
    every layer's scan (module docstring)."""
    scan = CELLS[cell_type][3]
    finals = []
    inp = xs
    for p, st in zip(params, states):
        final, inp = scan(p, st, inp, remat=remat)
        finals.append(final)
    return tuple(finals), inp


CELLS = {
    "lstm": (lstm_init, lstm_zero_state, lstm_step, lstm_scan),
    "vanilla": (vanilla_init, vanilla_zero_state, vanilla_step, vanilla_scan),
}


def state_h(state) -> torch.Tensor:
    return state.h
