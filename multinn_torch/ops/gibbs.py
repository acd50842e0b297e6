"""Dispatch for the k-sweep block-Gibbs chain — port of
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

from multinn_torch.ops import _build, gibbs_cuda


def gibbs_chain(key: torch.Tensor, v0: torch.Tensor, w, bv, bh, k: int,
                impl=None) -> torch.Tensor:
    """k-sweep block Gibbs from v0 (..., D); biases broadcastable to v0 and
    to (..., H). ``key``: a Threefry key (ops/sampling.py)."""
    if _build.impl_for(impl, v0) == "cuda":
        return gibbs_cuda.gibbs_chain(key, v0, w, bv, bh, k)
    return gibbs_cuda.gibbs_chain_plain(key, v0, w, bv, bh, k)
