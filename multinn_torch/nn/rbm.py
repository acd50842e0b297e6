"""RBM primitives — port of the deterministic half of multinn_tpu/nn/rbm.py.

    F(v)   = -v.bv - sum_j softplus(bh_j + (v W)_j)      (free energy)
    p(h|v) = sigmoid(v W + bh),   p(v|h) = sigmoid(h W^T + bv)

Biases broadcast against the leading dims of v/h (per-sample,
time-conditioned biases). The samplers live in ops/gibbs.py on the
kernel stream; CD-k, PLL and reconstruction wait for the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def free_energy(v, w, bv, bh) -> torch.Tensor:
    vis_term = torch.sum(v * bv, dim=-1)
    hid_term = torch.sum(F.softplus(v @ w + bh), dim=-1)
    return -vis_term - hid_term


def prob_h_given_v(v, w, bh) -> torch.Tensor:
    return torch.sigmoid(v @ w + bh)


def prob_v_given_h(h, w, bv) -> torch.Tensor:
    return torch.sigmoid(h @ w.transpose(-1, -2) + bv)
