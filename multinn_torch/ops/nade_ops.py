"""Dispatch for the NADE sampling sweep — port of the sampling half of
multinn_tpu/ops/nade_ops.py (the likelihood dispatch waits for the training
slice).

The JAX dispatch picks the Pallas kernel on a TPU and a ``jax.random`` scan
elsewhere. Here both implementations draw the kernel's own Threefry stream
(ops/nade_cuda.py):

  * ``cuda``  — the hand-written kernel (csrc/nade_sample.cu);
  * ``plain`` — its PyTorch version;
  * None      — ``cuda`` for CUDA tensors, ``plain`` for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from multinn_torch.ops import _build, nade_cuda


def nade_sample(key: torch.Tensor, w, v, bv, bh,
                batch_shape: Tuple[int, ...] = (), impl=None) -> torch.Tensor:
    """One ancestral NADE sample per row of ``batch_shape``; bv / bh may
    carry the batch dims (RNN-NADE's time-conditioned biases). ``key``: a
    Threefry key (ops/sampling.py). Returns (*batch_shape, D)."""
    if _build.impl_for(impl, w) == "cuda":
        return nade_cuda.nade_sample(key, w, v, bv, bh, batch_shape)
    return nade_cuda.nade_sample_plain(key, w, v, bv, bh, batch_shape)
