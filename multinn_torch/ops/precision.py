"""Mixed-precision matmul policy for the training hot path — port of
multinn_tpu/ops/precision.py.

Only the FEEDS of the policy's matmuls are cast: master weights, optimizer
state, losses, gates, recurrent carries and reductions stay f32, and
accumulation stays f32. Under ``bf16`` both feeds of ``mm`` are rounded to
bfloat16, forward and backward (an autograd Function whose saved tensors
are the bf16 feeds, as the JAX package's custom_vjp), and the f32 result is
not rounded. The policy is a context (``matmul_precision``) that the
Trainer enters around every step body from ``MultINNConfig.matmul_dtype``;
contexts nest and the inner one wins (the Hessian-free step pins ``f32``
inside a ``bf16`` run).

Call sites, the JAX package's: the LSTM / vanilla cell and hoisted input
products (nn/rnn.py), the RBM free energy and conditionals (nn/rbm.py),
the bias conditioning (models/base.py) and the DBN encoder layers
(models/encoders.py). The NADE likelihood path and every kernel keep f32
operands.

Route: on CUDA tensors the bf16 feeds go to ``torch.mm`` / ``torch.bmm``
with ``out_dtype=torch.float32`` (tensor-core bf16 products, f32
accumulation and output). CPU tensors upcast the bf16 feeds to f32 and
multiply in f32, which gives the same numbers up to the order of the f32
sums, since the product of two bf16 values is exact in f32. A plain
``torch.matmul`` of two bf16 tensors would not do: it returns bf16, which
rounds the output.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

_POLICY: contextvars.ContextVar = contextvars.ContextVar(
    "multinn_torch_matmul_dtype", default=None)

_NAMES = {None: None, "f32": None, "float32": None,
          "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def matmul_dtype() -> Optional[torch.dtype]:
    """The active matmul-feed dtype (torch.bfloat16), or None for f32."""
    return _POLICY.get()


@contextlib.contextmanager
def matmul_precision(name):
    """Run everything inside with the matmul feeds cast to ``name``
    ('f32' / None: no cast; 'bf16': bfloat16 feeds, f32 accumulation)."""
    if name not in _NAMES:
        raise ValueError(
            f"unknown matmul precision {name!r}; pick one of "
            f"{sorted(k for k in _NAMES if isinstance(k, str))}")
    token = _POLICY.set(_NAMES[name])
    try:
        yield
    finally:
        _POLICY.reset(token)


def _mm_f32(a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """a16 @ b16 with f32 accumulation and an f32 output. b16 is (X, Y)
    with a16 (..., X), or track-stacked (K, X, Y) with a16 (..., K, B, X)
    (the port's batched form of the JAX package's vmap over tracks)."""
    x, y = b16.shape[-2:]
    if b16.dim() == 2:
        a2 = a16.reshape(-1, x)
        if a16.is_cuda:
            out = torch.mm(a2, b16, out_dtype=torch.float32)
        else:
            out = a2.float() @ b16.float()
        return out.reshape(*a16.shape[:-1], y)
    k = b16.shape[0]
    lead = a16.shape[:-3]
    a3 = a16.movedim(-3, 0).reshape(k, -1, x)            # (K, N, X)
    if a16.is_cuda:
        out = torch.bmm(a3, b16, out_dtype=torch.float32)
    else:
        out = a3.float() @ b16.float()
    return out.reshape(k, *lead, a16.shape[-2], y).movedim(0, -3)


def _sum_outer(a16: torch.Tensor, g16: torch.Tensor, b_dim: int):
    """d/db of a @ b: the batch sum of a16^T g16, (X, Y) or per track
    (K, X, Y), f32 accumulation."""
    x, y = a16.shape[-1], g16.shape[-1]
    if b_dim == 2:
        a2, g2 = a16.reshape(-1, x), g16.reshape(-1, y)
    else:
        k = a16.shape[-3]
        a2 = a16.movedim(-3, 0).reshape(k, -1, x)
        g2 = g16.movedim(-3, 0).reshape(k, -1, y)
    return _mm_f32(a2.transpose(-1, -2).contiguous(), g2.contiguous())


class _MMBf16(torch.autograd.Function):
    """a @ b with bf16 feeds and f32 accumulation, forward and backward;
    the saved tensors are the bf16 feeds."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        return _mm_f32(a16, b16)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm_f32(g16, b16.transpose(-1, -2).contiguous())
        if ctx.needs_input_grad[1]:
            db = _sum_outer(a16, g16, b16.dim())
        return da, db


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Policy-aware matmul of the training hot path: f32 in, f32 out.
    Without the bf16 policy (or for a non-f32 ``a``) it is ``a @ b``;
    under it both feeds, forward and backward, are bf16 with f32
    accumulation. ``b`` is a weight (X, Y), or track-stacked (K, X, Y)
    against ``a`` (..., K, B, X)."""
    if _POLICY.get() is None or a.dtype != torch.float32:
        return a @ b
    return _MMBf16.apply(a, b)
