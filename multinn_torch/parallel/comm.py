"""Collectives over one mesh axis on ``torch.distributed`` — the port's
stand-in for the collectives the JAX package leaves to XLA (``psum``,
``all_gather``, ``ppermute``, and the ones GSPMD inserts).

Every function takes the axis's process group (parallel/mesh.py); a group
of None, or of one rank, is the identity, so single-device code runs the
same lines. The semantics are built from two collectives every backend
takes, ``all_reduce`` and ``all_gather`` (the list form): ``ppermute``
(rank s -> s + 1, zeros into rank 0) is an all-gather from which each rank
keeps its left neighbour's slot, so a shift is exact to the bit.

Under a gloo group a CUDA tensor goes through a pinned host buffer: the
path of ranks that share one card, chosen when the world is made
(``mesh.init_distributed``); under an NCCL group a CPU tensor goes through
the rank's card. Either way the caller's tensor never leaves its device.
Under NCCL a CUDA tensor's collectives run on the current stream's card
with no host synchronisation and no host buffer, and allocate only
through the caching allocator, so a CUDA graph captures them (inside a
capture their buffers come from the graph's pool): the Trainer captures a
mesh's step groups so (training/trainer.py).

The autograd Functions give each collective the derivative the mesh's
semantics need, and a forward-mode rule (``jvp``), so ``torch.func.jvp``
(the Hessian-free step's Gauss-Newton products) passes through them:

  * ``all_reduce``       — sum; backward sums the cotangents (every rank's
    output is a separate term of the objective);
  * ``reduce_from_model`` / ``copy_to_model`` — Megatron's pair for a
    tensor-parallel axis whose ranks all compute the SAME objective: sum
    forward with the identity backward, and the identity forward with a
    summed backward; ``gather_from_model``, its gather: the ranks' columns
    forward, this rank's columns of the cotangent backward;
  * ``all_gather``       — backward sums the cotangents over the ranks and
    keeps this rank's slice;
  * ``ppermute``         — backward shifts the cotangents back (s + 1 -> s).

A collective's backward is itself a collective: every rank of the group
must run it, in the same order. The callers keep the autograd graph the
same on every rank for that (parallel/seqpipe.py).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def size(group) -> int:
    """Ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def index(group) -> int:
    """This rank's position in ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def _home(group, t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` where the group's backend reads it: host
    memory for gloo (pinned when ``t`` is on the card), the card for
    NCCL."""
    backend = dist.get_backend(group)
    if backend == "gloo" and t.is_cuda:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t)
    if backend == "nccl" and not t.is_cuda:
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t.detach().clone(memory_format=torch.contiguous_format)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks (a new tensor on ``t``'s
    device; no autograd)."""
    if size(group) == 1:
        return t
    buf = _home(group, t.detach())
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def gather_list(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t``, in rank order (no autograd; equal shapes).
    Under NCCL one ``all_gather_into_tensor`` into a flat buffer, whose
    rows are the parts (capturable: no host staging, one allocation);
    under gloo the list form."""
    n = size(group)
    if n == 1:
        return [t]
    buf = _home(group, t.detach())
    if dist.get_backend(group) == "nccl":
        flat = buf.new_empty((n, *buf.shape))
        dist.all_gather_into_tensor(flat, buf, group=group)
        return [p.to(t.device) for p in flat.unbind(0)]
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    return [p.to(t.device) for p in parts]


def gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` (no autograd)."""
    if size(group) == 1:
        return t
    return torch.cat(gather_list(t, group), dim=dim)


def shift(t: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """Rank s receives rank s - step's ``t``; ranks with no such source
    receive zeros (no autograd)."""
    n = size(group)
    if n == 1:
        return torch.zeros_like(t)
    src = index(group) - step
    parts = gather_list(t, group)
    return parts[src].clone() if 0 <= src < n else torch.zeros_like(t)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank of ``group`` (the world when
    None); returns a new tensor on ``t``'s device."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return t
    buf = _home(group, t.detach())
    dist.broadcast(buf, src, group=group)
    return buf.to(t.device)


def barrier(group=None) -> None:
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.barrier(group=group)


# -- autograd ----------------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None

    @staticmethod
    def jvp(ctx, t, _):
        return all_reduce_sum(t, ctx.group)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, t, _):
        return all_reduce_sum(t, ctx.group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None

    @staticmethod
    def jvp(ctx, t, _):
        return t.clone()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x, dim, group):
        return gather_cat(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.dim, ctx.group = inputs
        ctx.local = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum(g, ctx.group)
        return (g.narrow(ctx.dim, index(ctx.group) * ctx.local, ctx.local),
                None, None)

    @staticmethod
    def jvp(ctx, t, *_):
        return gather_cat(t, ctx.dim, ctx.group)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(x, dim, group):
        return gather_cat(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.dim, ctx.group = inputs
        ctx.local = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, index(ctx.group) * ctx.local, ctx.local),
                None, None)

    @staticmethod
    def jvp(ctx, t, *_):
        return gather_cat(t, ctx.dim, ctx.group)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return shift(x, group, 1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.group, -1), None

    @staticmethod
    def jvp(ctx, t, _):
        return shift(t, ctx.group, 1)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the backward sums the cotangents too."""
    return x if size(group) == 1 else _AllReduce.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum of the ranks' partial ``x`` forward, the
    identity backward (every rank of the axis holds the same cotangent)."""
    return x if size(group) == 1 else _ReduceFromModel.apply(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the identity forward; backward sums the ranks' partial
    cotangents of a replicated ``x`` that feeds column-sharded work."""
    return x if size(group) == 1 else _CopyToModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Megatron's gather: every rank's columns of ``x`` along ``dim``
    forward; backward, this rank's columns of the (same on every rank)
    cotangent."""
    return x if size(group) == 1 else _GatherFromModel.apply(x, dim, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, in rank order."""
    return x if size(group) == 1 else _AllGather.apply(x, dim, group)


def ppermute(x: torch.Tensor, group) -> torch.Tensor:
    """Rank s receives rank s - 1's ``x``; rank 0 receives zeros (the
    reference's ``ppermute`` with perm [(i, i + 1)])."""
    if size(group) == 1:
        return torch.zeros_like(x)
    return _PPermute.apply(x, group)


def sum_(tensors: List[torch.Tensor], groups) -> List[torch.Tensor]:
    """Sum ``tensors`` in place over every group of ``groups`` (one
    all-reduce of their concatenation per group); returns them."""
    for group in groups:
        if size(group) == 1 or not tensors:
            continue
        flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]),
                              group)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def mean_(tensors: List[torch.Tensor], groups) -> List[torch.Tensor]:
    """Average ``tensors`` in place over every group of ``groups`` (the
    reference's pmean over several axes); returns them."""
    n = 1
    for group in groups:
        n *= size(group)
    if n > 1:
        torch._foreach_div_(sum_(tensors, groups), float(n))
    return tensors
