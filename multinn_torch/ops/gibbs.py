"""Dispatch for the k-sweep block-Gibbs chain and the CD-k loss — port of
multinn_tpu/ops/gibbs.py.

The JAX dispatch picks the Pallas kernel or an XLA chain on ``jax.random``.
Here both implementations draw the kernel's own Threefry stream
(ops/gibbs_cuda.py), so they agree bit for bit up to last-ulp flips:

  * ``cuda``  — the hand-written kernel (csrc/gibbs_chain.cu);
  * ``plain`` — its PyTorch version;
  * None      — ``cuda`` for CUDA tensors, ``plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from multinn_torch.nn import rbm as _rbm
from multinn_torch.ops import _build, gibbs_cuda


def gibbs_chain(key: torch.Tensor, v0: torch.Tensor, w, bv, bh, k: int,
                impl=None, rows=None) -> torch.Tensor:
    """k-sweep block Gibbs from v0 (..., D); biases broadcastable to v0 and
    to (..., H). ``key``: a Threefry key (ops/sampling.py). ``rows``: the
    row map (b0, B_global) of a data shard (ops/gibbs_cuda.py)."""
    if _build.impl_for(impl, v0) == "cuda":
        return gibbs_cuda.gibbs_chain(key, v0, w, bv, bh, k, rows)
    return gibbs_cuda.gibbs_chain_plain(key, v0, w, bv, bh, k, rows)


def cd_loss(key: torch.Tensor, v0: torch.Tensor, w, bv, bh,
            k: int = 1) -> torch.Tensor:
    """CD-k surrogate mean(F(v0) - F(vk)) with the chain on the kernel
    stream (math of record: nn.rbm.cd_loss). The chain runs under no_grad
    on detached inputs, so vk is a constant; w and the (time-conditioned)
    biases get gradient through both free-energy terms."""
    with torch.no_grad():
        vk = gibbs_chain(key, v0.detach(), w.detach(), bv.detach(),
                         bh.detach(), k)
    return torch.mean(_rbm.free_energy(v0, w, bv, bh)
                      - _rbm.free_energy(vk, w, bv, bh))
