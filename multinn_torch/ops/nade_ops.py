"""Dispatch for the NADE hot ops — port of multinn_tpu/ops/nade_ops.py.

Likelihood (``nade_conditionals_logits``, ``nade_log_prob``): the grid-free
kernels' autograd Function (ops/nade_ll.py), on the kernels for CUDA
tensors and on their plain versions for CPU tensors; ``chunk=`` / ``form=``
force the parallel reference forms (nn/nade.py). The JAX package's
``MULTINN_NADE_LL_IMPL`` switch (a TPU A/B knob) is not ported.

Sampling (``nade_sample``): the JAX dispatch picks the Pallas kernel on a
TPU and a ``jax.random`` scan elsewhere. Here both implementations draw the
kernel's own Threefry stream (ops/nade_cuda.py):

  * ``cuda``  — the hand-written kernel (csrc/nade_sample.cu);
  * ``plain`` — its PyTorch version;
  * None      — ``cuda`` for CUDA tensors, ``plain`` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multinn_torch.nn import nade as _nade
from multinn_torch.ops import _build, nade_cuda, nade_ll


def nade_conditionals_logits(x: torch.Tensor, w, v, bv, bh,
                             form: Optional[str] = None,
                             impl=None) -> torch.Tensor:
    """All D teacher-forced conditional logits (..., D); x (..., D) with
    w, v (D, H), or x (K, ..., D) with track-stacked (K, D, H)."""
    if form is not None:
        return _nade.conditionals_logits(x, w, v, bv, bh, form=form)
    return nade_ll.nade_logits(x, w, v, bv, bh, impl=impl)


def nade_log_prob(x: torch.Tensor, w, v, bv, bh,
                  chunk: Optional[int] = None, form: Optional[str] = None,
                  impl=None) -> torch.Tensor:
    """Exact log p(x), x's leading dims. ``chunk`` / ``form`` force the
    reference forms."""
    if chunk is not None:
        return _nade.log_prob_chunked(x, w, v, bv, bh, chunk=chunk)
    logits = nade_conditionals_logits(x, w, v, bv, bh, form=form, impl=impl)
    return _nade.bernoulli_ll(logits, x).sum(dim=-1)


def nade_sample(key: torch.Tensor, w, v, bv, bh,
                batch_shape: Tuple[int, ...] = (), impl=None,
                rows=None) -> torch.Tensor:
    """One ancestral NADE sample per row of ``batch_shape``; bv / bh may
    carry the batch dims (RNN-NADE's time-conditioned biases). ``key``: a
    Threefry key (ops/sampling.py). ``rows``: the row map (b0, N_global) of
    a data shard (ops/nade_cuda.py). Returns (*batch_shape, D)."""
    if _build.impl_for(impl, w) == "cuda":
        return nade_cuda.nade_sample(key, w, v, bv, bh, batch_shape, rows)
    return nade_cuda.nade_sample_plain(key, w, v, bv, bh, batch_shape, rows)
