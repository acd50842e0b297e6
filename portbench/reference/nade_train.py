"""The plain reference of RNN-NADE training of the feedback MultINN:
the teacher-forced exact negative log-likelihood, its gradients by
autograd, and ``model.py``'s Adam behind a clip of the gradients' global
norm; float32 with TF32 off (call ``model.no_tf32()`` first).

Weights and rolls as ``model.py`` states them (the NADE's ``v`` (K, D,
H) beside ``w``). Per track, frame t and pitch i:

    a_1 = bh(t),  a_{i+1} = a_i + v_i W_i
    p(v_i = 1 | v_<i) = sigmoid(bv_i(t) + V_i . sigmoid(a_i))
    NLL = - mean over frames and songs of sum_i log p(v_i | v_<i)

and the loss is the mean of the tracks' NLLs. The sum over pitches runs
in their order, one pitch at a time, as the definition reads; nothing is
drawn.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.model import (Adam, conditioned_biases,
                                       lstm_inputs, lstm_states)


def nade_nll(wts: dict, x: torch.Tensor) -> torch.Tensor:
    """The loss of a batch x (B, T, K, D): the mean over tracks of each
    track's mean per-frame NLL."""
    d = x.shape[-1]
    u_prev = lstm_states(wts, lstm_inputs(x))                  # (T, K, B, U)
    bv_t, bh_t = conditioned_biases(wts, u_prev)
    v = x.permute(1, 2, 0, 3)                                  # (T, K, B, D)
    a = bh_t
    ll = torch.zeros_like(v[..., 0])
    for i in range(d):
        logit = bv_t[..., i] + (torch.sigmoid(a)
                                * wts["v"][:, None, i]).sum(-1)
        vi = v[..., i]
        ll = ll + vi * F.logsigmoid(logit) + (1 - vi) * F.logsigmoid(-logit)
        a = a + vi[..., None] * wts["w"][:, None, i]
    return -ll.mean(dim=(0, 2)).mean()


def nade_train(wts: dict, batches, lr: float, clip: float):
    """Adam steps of the exact NLL from ``wts`` over ``batches`` (each (B,
    T, K, D)). Returns (the weights after, the Adam state, each step's
    loss, each step's gradient norm before the clip)."""
    params = {n: p.detach().clone() for n, p in wts.items()}
    opt = Adam(params, lr, clip)
    losses, norms = [], []
    for x in batches:
        live = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        loss = nade_nll(live, x)
        grads = torch.autograd.grad(loss, list(live.values()))
        norms.append(opt.step(params, dict(zip(live, grads))))
        losses.append(float(loss.detach()))
    return params, opt, losses, norms
