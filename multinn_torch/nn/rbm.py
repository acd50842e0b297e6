"""RBM primitives — port of multinn_tpu/nn/rbm.py.

    F(v)   = -v.bv - sum_j softplus(bh_j + (v W)_j)      (free energy)
    p(h|v) = sigmoid(v W + bh),   p(v|h) = sigmoid(h W^T + bv)

Biases broadcast against the leading dims of v/h (per-sample,
time-conditioned biases). The samplers here draw ``jax.random``'s stream
(ops/sampling.py), bit-equal to the JAX package's XLA path: this module is
the math of record. The CD chain of training runs on the kernel stream
instead (ops/gibbs.py). The free energy and the conditionals' products
follow the bf16 matmul policy (ops/precision.py).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from multinn_torch.ops import sampling
from multinn_torch.ops.precision import mm


@dataclasses.dataclass
class RBMParams:
    w: torch.Tensor         # (D, H)
    bv: torch.Tensor        # (D,)
    bh: torch.Tensor        # (H,)


def init(n_visible: int, n_hidden: int, w_std: float = 0.01,
         generator=None, device=None) -> RBMParams:
    """Normal(0, w_std) weights from ``generator``, zero biases."""
    w = w_std * torch.randn((n_visible, n_hidden), generator=generator,
                            device=device)
    return RBMParams(w=w, bv=torch.zeros(n_visible, device=device),
                     bh=torch.zeros(n_hidden, device=device))


def free_energy(v, w, bv, bh) -> torch.Tensor:
    vis_term = torch.sum(v * bv, dim=-1)
    hid_term = torch.sum(F.softplus(mm(v, w) + bh), dim=-1)
    return -vis_term - hid_term


def prob_h_given_v(v, w, bh) -> torch.Tensor:
    return torch.sigmoid(mm(v, w) + bh)


def prob_v_given_h(h, w, bv) -> torch.Tensor:
    return torch.sigmoid(mm(h, w.transpose(-1, -2)) + bv)


def gibbs_step(key, v, w, bv, bh, sample_v: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block Gibbs sweep v -> h -> v'. Returns (v', h); with
    ``sample_v=False`` v' is the mean-field visible probability."""
    kh, kv = sampling.split(key)
    h = sampling.bernoulli(kh, prob_h_given_v(v, w, bh))
    pv = prob_v_given_h(h, w, bv)
    return (sampling.bernoulli(kv, pv) if sample_v else pv), h


def gibbs_chain(key, v0, w, bv, bh, k: int) -> torch.Tensor:
    """k sweeps of block Gibbs from v0, sweep i on key i of split(key, k)."""
    v = v0
    for kk in sampling.split(key, k):
        v, _ = gibbs_step(kk, v, w, bv, bh)
    return v


def cd_loss(key, v0, w, bv, bh, k: int = 1) -> torch.Tensor:
    """Contrastive-divergence surrogate, mean over all leading dims:
    L = mean[F(v0) - F(vk)] with vk a constant, so grad L is the CD-k
    estimate; the biases get gradient through both terms."""
    with torch.no_grad():
        vk = gibbs_chain(key, v0, w, bv, bh, k)
    return torch.mean(free_energy(v0, w, bv, bh) - free_energy(vk, w, bv, bh))


def reconstruction(key, v0, w, bv, bh, k: int = 1) -> torch.Tensor:
    """k-step Gibbs reconstruction with a mean-field final visible pass."""
    k_chain, k_final = sampling.split(key)
    v = gibbs_chain(k_chain, v0, w, bv, bh, k - 1) if k > 1 else v0
    v_mf, _ = gibbs_step(k_final, v, w, bv, bh, sample_v=False)
    return v_mf


def pseudo_log_likelihood(key, v, w, bv, bh) -> torch.Tensor:
    """Stochastic pseudo-log-likelihood: flip one random visible unit per
    sample, PLL ~ D * log sigmoid(F(v~) - F(v)). Returns v's leading dims."""
    d = v.shape[-1]
    idx = sampling.randint(key, v.shape[:-1], 0, d).to(v.device)
    flip = F.one_hot(idx, d).to(v.dtype)
    v_flip = v * (1 - flip) + (1 - v) * flip
    fe, fe_flip = free_energy(v, w, bv, bh), free_energy(v_flip, w, bv, bh)
    return d * F.logsigmoid(fe_flip - fe)
