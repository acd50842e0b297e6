"""NADE primitives — port of the likelihood half of multinn_tpu/nn/nade.py.

For v in {0,1}^D, hidden width H, encode weights W (D, H), decode weights
V (D, H), hidden bias bh (H,), visible bias bv (D,):

    a_i  = bh + sum_{j<i} v_j W_j        (running activation, a_0 = bh)
    p(v_i = 1 | v_<i) = sigmoid(bv_i + V_i . sigmoid(a_i))
    log p(v) = sum_i log p(v_i | v_<i)   — the exact likelihood.

These are the parallel reference forms (the exclusive cumulative sum builds
the (..., D, H) activation grid; ``log_prob_chunked`` scans chunks of dims).
The training path takes the grid-free kernels instead (ops/nade_ll.py); the
tests hold the kernels against these forms, and ``conditional_logits``
(the Hessian-free linearization point) keeps them.

Weights may be track-stacked, (K, D, H) with x (K, ..., D) and biases that
broadcast against x, where the JAX package vmaps over tracks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bernoulli_ll(logits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Elementwise Bernoulli log-likelihood x log s(l) + (1-x) log s(-l):
    the one definition every likelihood path shares."""
    return x * F.logsigmoid(logits) + (1 - x) * F.logsigmoid(-logits)


def _weights(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(D, H) as is; track-stacked (K, D, H) viewed against x (K, ..., D)
    as (K, 1, ..., 1, D, H)."""
    if w.dim() == 2:
        return w
    return w.reshape(w.shape[0], *[1] * (x.dim() - 2), *w.shape[1:])


def _a_excl(contrib: torch.Tensor, form: str) -> torch.Tensor:
    """Exclusive cumulative sum of per-dim contributions over the dim axis
    (-2): ``cumsum`` or one strictly-lower-triangular (D, D) product
    (``tri``). Both exact up to the order of the f32 sums."""
    if form == "tri":
        d = contrib.shape[-2]
        lstrict = torch.tril(torch.ones(d, d, dtype=contrib.dtype,
                                        device=contrib.device), diagonal=-1)
        return torch.einsum("ij,...jh->...ih", lstrict, contrib)
    if form != "cumsum":
        raise ValueError(f"form must be 'cumsum' or 'tri', got {form!r}")
    csum = torch.cumsum(contrib, dim=-2)
    return torch.cat([torch.zeros_like(csum[..., :1, :]), csum[..., :-1, :]],
                     dim=-2)


def conditionals_logits(x: torch.Tensor, w, v, bv, bh,
                        form: str = "cumsum") -> torch.Tensor:
    """All D conditional logits for observed x, in parallel: (..., D) with
    logits_i = bv_i + V_i . sigmoid(a_i)."""
    w, v = _weights(w, x), _weights(v, x)
    contrib = x[..., :, None] * w                     # (..., D, H)
    a = _a_excl(contrib, form) + bh[..., None, :]
    h = torch.sigmoid(a)
    return bv + torch.sum(h * v, dim=-1)


def log_prob(x: torch.Tensor, w, v, bv, bh, form: str = "cumsum"
             ) -> torch.Tensor:
    """Exact log p(x) = sum_i log p(x_i | x_<i). Returns x's leading dims."""
    logits = conditionals_logits(x, w, v, bv, bh, form=form)
    return torch.sum(bernoulli_ll(logits, x), dim=-1)


def log_prob_chunked(x: torch.Tensor, w, v, bv, bh, chunk: int = 16
                     ) -> torch.Tensor:
    """Memory-bounded exact log-likelihood: a loop over D in chunks of
    ``chunk`` dims carrying the running activation (the cumsum form within
    a chunk). D must be divisible by ``chunk``."""
    d = w.shape[-2]
    if d % chunk:
        raise ValueError(f"D={d} not divisible by chunk={chunk}")
    w, v = _weights(w, x), _weights(v, x)
    bv = bv.expand(x.shape)
    a = bh.expand(*x.shape[:-1], w.shape[-1])
    total = 0.0
    for c in range(0, d, chunk):
        x_c = x[..., c:c + chunk]
        contrib = x_c[..., :, None] * w[..., c:c + chunk, :]
        csum = torch.cumsum(contrib, dim=-2)
        a_excl = torch.cat([torch.zeros_like(csum[..., :1, :]),
                            csum[..., :-1, :]], dim=-2)
        h = torch.sigmoid(a[..., None, :] + a_excl)
        logits = bv[..., c:c + chunk] + torch.sum(
            h * v[..., c:c + chunk, :], dim=-1)
        total = total + torch.sum(bernoulli_ll(logits, x_c), dim=-1)
        a = a + csum[..., -1, :]
    return total
