"""Process mesh and parameter placement on ``torch.distributed`` — port of
multinn_tpu/parallel/mesh.py.

Mesh axes, in the reference's order (``data``, ``track``[, ``model``][,
``seq``]):

  * ``data``  — the batch (DP); gradients are averaged over it;
  * ``track`` — the per-track decoders (their stacked K axis) over ranks;
    the feedback architecture gathers the per-frame latents over it;
  * ``model`` — the RBM / NADE hidden dim H (Megatron column split of w, v,
    bh and wuh); bv, wuv and the RNN cell stay replicated;
  * ``seq``   — the training window's time axis (parallel/seqpipe.py).

The port has no partitioner: one process per rank runs explicit per-rank
code, and every axis is one ``torch.distributed`` process group. The
groups are made with ``new_group``, one per line of ranks along an axis,
not by ``init_device_mesh``: a device mesh binds each rank to a device of
its own, and the port also lays a world out over ranks that share one card
(gloo with host staging), where its collectives (parallel/comm.py) need
only the groups.

Placement is slicing: ``shard_params`` cuts a full ``MultINNParams`` down
to this rank's part by the reference's ``multinn_param_shardings`` rules,
``gather_params`` is its inverse, and ``Shard`` tells the model functions
which part of a global-view (gspmd) computation this rank holds.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multinn_torch.parallel import comm
from multinn_torch.utils.config import MeshConfig  # noqa: F401  (re-export)

DATA_AXIS = "data"
TRACK_AXIS = "track"
MODEL_AXIS = "model"        # tensor parallelism: RBM/NADE hidden dim
SEQ_AXIS = "seq"            # time-sharded teacher forcing (seqpipe)

# decoder fields whose LAST axis is the hidden dim H (the model axis)
_HIDDEN_DIM_FIELDS = ("w", "v", "bh", "wuh")
# a collective that never completes raises after this long
STORE_TIMEOUT_S = 120


def choose_backend(world_size: int) -> str:
    """``nccl`` when every rank has a CUDA device of its own, else ``gloo``
    (the CPU, or ranks that share a card and stage through the host)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> str:
    """Join the world: ``torch.distributed.init_process_group`` with
    ``coordinator`` as its init method (``tcp://host:port`` or
    ``file:///path``), ``num_processes`` ranks and this one's
    ``process_id``; with no coordinator, the ``env://`` variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). The backend is chosen
    once, here (``choose_backend`` unless given), and logged. Under NCCL
    rank r uses card r. The store's timeout is 120 s, so a collective that
    never completes raises. Returns the backend."""
    if coordinator is None:
        init_method = "env://"
        world = int(num_processes or os.environ.get("WORLD_SIZE", 1))
        rank = int(process_id if process_id is not None
                   else os.environ.get("RANK", 0))
    else:
        init_method, world, rank = coordinator, int(num_processes), \
            int(process_id)
    backend = backend or choose_backend(world)
    kwargs = {}
    if backend == "nccl":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=STORE_TIMEOUT_S), **kwargs)
    logging.getLogger("multinn_torch").info(
        "rank %d of %d joined through %s on %s", rank, world, init_method,
        backend)
    return backend


def rank_device(backend: Optional[str] = None) -> torch.device:
    """The device this rank computes on: its own card under NCCL; under
    gloo card r % count for rank r when there are cards (ranks beyond the
    count share them; on one card every rank shares it), else the CPU."""
    backend = backend or (dist.get_backend() if dist.is_initialized()
                          else None)
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if not torch.cuda.is_available():
        return torch.device("cpu")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclasses.dataclass
class Mesh:
    """This rank's view of the mesh: the axes present, their sizes
    (``shape``, as ``jax.sharding.Mesh.shape``), this rank's coordinate on
    each and one process group per axis (None for an axis of one rank)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]
    backend: str

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def rows(self, b_global: int) -> Tuple[int, int]:
        """The row map (b0, B_global) of this rank's slice of a batch of
        ``b_global`` rows split over ``data``."""
        return self.index(DATA_AXIS) * (b_global // self.size(DATA_AXIS)), \
            b_global


def make_mesh(cfg: MeshConfig) -> Optional[Mesh]:
    """Lay out the (data, track[, model][, seq]) mesh over the world's
    ranks, row-major in that order (rank = ((d*T + t)*M + m)*S + s). Axes
    of size 1 beyond ``track`` are dropped; a product other than the world
    size raises. Every rank must call this, in the same order as the
    others: each axis's groups are made by every rank."""
    if not cfg.use_mesh:
        return None
    if not dist.is_initialized():
        raise RuntimeError(
            "mesh.use_mesh needs torch.distributed initialised first "
            "(multinn_torch.parallel.mesh.init_distributed)")
    n, rank = dist.get_world_size(), dist.get_rank()
    sizes = [cfg.resolved_data(n), cfg.track]
    names = [DATA_AXIS, TRACK_AXIS]
    if cfg.model > 1:
        sizes.append(cfg.model)
        names.append(MODEL_AXIS)
    if cfg.seq > 1:
        sizes.append(cfg.seq)
        names.append(SEQ_AXIS)
    if int(np.prod(sizes)) != n:
        raise ValueError(
            f"mesh {'x'.join(map(str, sizes))} ({' x '.join(names)}) "
            f"!= device count {n}")
    layout = np.arange(n).reshape(*sizes)
    coords = dict(zip(names, (int(c) for c in
                              np.unravel_index(rank, sizes))))
    groups: Dict[str, object] = {}
    for a, name in enumerate(names):
        if sizes[a] == 1:
            groups[name] = None
            continue
        others = [range(s) for i, s in enumerate(sizes) if i != a]
        for rest in itertools.product(*others):
            idx = list(rest)
            idx.insert(a, slice(None))
            ranks = [int(r) for r in layout[tuple(idx)]]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = group
    return Mesh(tuple(names), dict(zip(names, sizes)), coords, groups,
                dist.get_backend())


# ---------------------------------------------------------------------------
# what a rank holds of a global-view computation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's part of a global-view (gspmd) computation, as the model
    functions read it: ``rows`` the row map (b0, B_global) of its batch
    rows (None: the batch is whole or per-shard) and ``data`` the group
    they are split over, ``track`` the group over which the K tracks are
    split (``n_track`` ranks, this one ``track_index``), ``model`` the
    group over which H is split."""
    rows: Optional[Tuple[int, int]] = None
    data: object = None
    track: object = None
    n_track: int = 1
    track_index: int = 0
    model: object = None

    def tracks(self, k: int) -> slice:
        """This rank's tracks of all ``k``."""
        per = k // self.n_track
        return slice(self.track_index * per, (self.track_index + 1) * per)


def shard_of(mesh: Optional[Mesh], b_global: Optional[int],
             track_sharded: bool, model_sharded: bool = True
             ) -> Optional[Shard]:
    """The Shard of a gspmd computation on ``mesh`` over a batch of
    ``b_global`` rows (None: not split over ``data``)."""
    if mesh is None:
        return None
    split = b_global is not None and mesh.size(DATA_AXIS) > 1
    return Shard(rows=mesh.rows(b_global) if split else None,
                 data=mesh.group(DATA_AXIS) if split else None,
                 track=mesh.group(TRACK_AXIS) if track_sharded else None,
                 n_track=mesh.size(TRACK_AXIS) if track_sharded else 1,
                 track_index=mesh.index(TRACK_AXIS) if track_sharded else 0,
                 model=mesh.group(MODEL_AXIS) if model_sharded else None)


# ---------------------------------------------------------------------------
# placement of MultINN params (the reference's multinn_param_shardings)
# ---------------------------------------------------------------------------

def _decoder_specs(decoder, stacked: bool, tp: bool) -> List[tuple]:
    from multinn_torch.models import multinn
    out = []
    for f in dataclasses.fields(decoder):
        if f.name == "cfg":
            continue
        for t in multinn.tree_leaves(getattr(decoder, f.name)):
            spec = [None] * t.dim()
            if stacked:
                spec[0] = TRACK_AXIS
            if tp and f.name in _HIDDEN_DIM_FIELDS:
                spec[-1] = MODEL_AXIS
            out.append(tuple(spec))
    return out


def leaf_specs(params, mesh: Mesh, track_sharded: bool,
               model_sharded: Optional[bool] = None
               ) -> Tuple[List[tuple], List[tuple]]:
    """The placement of every tensor of ``params`` (encoder's, decoder's,
    each in ``multinn.tree_leaves`` order): per dim the mesh axis it is
    split over, or None. The decoder's stacked K axis goes over ``track``
    (per-track, feedback and hybrid modes), the encoder's only in per-track
    mode; w, v, bh and wuh split their last (H) axis over ``model`` (when
    ``model_sharded``; None: when the mesh has that axis)."""
    if model_sharded is None:
        model_sharded = mesh.size(MODEL_AXIS) > 1
    from multinn_torch.models import multinn
    mode = params.cfg.mode
    dec_t = track_sharded and mode in ("per-track", "feedback", "hybrid")
    enc_t = track_sharded and mode == "per-track"
    enc = [((TRACK_AXIS,) if enc_t else (None,)) + (None,) * (t.dim() - 1)
           for t in multinn.tree_leaves(params.encoder)]
    return enc, _decoder_specs(params.decoder, dec_t, model_sharded)


def field_specs(params, mesh: Mesh, track_sharded: bool) -> Dict[str, tuple]:
    """The placement of each decoder field's (first) tensor, by name."""
    specs = iter(leaf_specs(params, mesh, track_sharded)[1])
    from multinn_torch.models import multinn
    out = {}
    for f in dataclasses.fields(params.decoder):
        if f.name == "cfg":
            continue
        leaves = multinn.tree_leaves(getattr(params.decoder, f.name))
        mine = [next(specs) for _ in leaves]
        out[f.name] = mine[0]
    return out


def shard_tensor(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.size(axis)
        per = t.shape[dim] // n
        t = t.narrow(dim, mesh.index(axis) * per, per)
    return t.detach().clone(memory_format=torch.contiguous_format)


def gather_tensor(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's block ``t`` under ``spec``."""
    with torch.no_grad():
        for dim in reversed(range(len(spec))):
            if spec[dim] is not None:
                t = comm.gather_cat(t.contiguous(), dim,
                                    mesh.group(spec[dim]))
    return t.detach().clone()


def _place(params, mesh: Mesh, track_sharded: bool,
           model_sharded: Optional[bool], place):
    """``params`` with ``place(tensor, spec, mesh)`` applied to each
    tensor under its ``leaf_specs`` placement."""
    from multinn_torch.models import multinn
    enc_s, dec_s = leaf_specs(params, mesh, track_sharded, model_sharded)
    placed = lambda tree, specs: multinn.with_leaves(tree, [
        place(t, sp, mesh) for t, sp in zip(multinn.tree_leaves(tree),
                                            specs)])
    return dataclasses.replace(params,
                               encoder=placed(params.encoder, enc_s),
                               decoder=placed(params.decoder, dec_s))


def shard_params(params, mesh: Optional[Mesh], track_sharded: bool = False,
                 model_sharded: Optional[bool] = None):
    """The full ``params`` cut down to this rank's part (new tensors)."""
    if mesh is None:
        return params
    return _place(params, mesh, track_sharded, model_sharded, shard_tensor)


def gather_params(params, mesh: Optional[Mesh], track_sharded: bool = False,
                  model_sharded: Optional[bool] = None):
    """The full params from every rank's part (``shard_params``'
    inverse); every rank of the mesh must call it."""
    if mesh is None:
        return params
    return _place(params, mesh, track_sharded, model_sharded, gather_tensor)


def batch_slice(b_global: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a batch of ``b_global`` split over ``data``."""
    if mesh is None:
        return slice(None)
    n = mesh.size(DATA_AXIS)
    per = b_global // n
    return slice(mesh.index(DATA_AXIS) * per,
                 (mesh.index(DATA_AXIS) + 1) * per)


def shard_batch(batch, mesh: Optional[Mesh], track_sharded: bool = False,
                seq: bool = False, lead: int = 0):
    """This rank's block of a (B, T, K, D) pianoroll batch or a (B, T)
    mask (``lead`` leading axes first, such as a group's N): B over
    ``data``, K over ``track`` when track-sharded, T over ``seq`` when
    ``seq`` (the reference's batch_sharding and the explicit styles' batch
    spec)."""
    if mesh is None:
        return batch
    idx = [slice(None)] * lead + [batch_slice(batch.shape[lead], mesh)]
    ndim = batch.ndim - lead
    if seq:
        t = batch.shape[lead + 1]
        per = t // mesh.size(SEQ_AXIS)
        s = mesh.index(SEQ_AXIS)
        idx.append(slice(s * per, (s + 1) * per))
    elif ndim > 1:
        idx.append(slice(None))
    if track_sharded and ndim == 4:
        k = batch.shape[lead + 2]
        per = k // mesh.size(TRACK_AXIS)
        t = mesh.index(TRACK_AXIS)
        idx.append(slice(t * per, (t + 1) * per))
    return batch[tuple(idx)]


class Reduce:
    """The reductions of a training step on a mesh, as the reference's
    pmean / psum and the partitioner's collectives give them: ``mean_axes``
    average the gradients and the metrics (``data``, and ``seq`` under
    seqpipe); the dot product of two parameter-shaped lists sums each
    tensor's part over the axes it is split over (``leaf specs``), and a
    loss that is a rank's share of the mean over the tracks sums over
    ``track``. Without a mesh every method is the single-device one."""

    def __init__(self, mesh: Optional[Mesh] = None,
                 mean_axes: Sequence[str] = (),
                 specs: Optional[List[tuple]] = None,
                 track_sharded: bool = False):
        self.mesh = mesh
        self.mean_groups = [mesh.group(a) for a in mean_axes] if mesh else []
        self.specs = specs
        self.track = (mesh.group(TRACK_AXIS)
                      if mesh is not None and track_sharded else None)

    def mean(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Average in place over the mean axes (the gradients' pmean)."""
        return comm.mean_(list(tensors), self.mean_groups)

    def loss(self, share: torch.Tensor) -> torch.Tensor:
        """The global loss from this rank's share (no autograd)."""
        if self.mesh is None:
            return share.detach()
        total = comm.all_reduce_sum(share.detach(), self.track)
        return comm.mean_([total.clone()], self.mean_groups)[0]

    def sq_sum(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The sum over all tensors of the parameter list of their parts
        ``parts`` (one scalar per tensor), each summed over the axes it is
        split over."""
        if self.mesh is None:
            return torch.stack(parts).sum()
        by_axes: Dict[tuple, list] = {}
        for p, spec in zip(parts, self.specs or [()] * len(parts)):
            key = tuple(sorted({a for a in spec if a is not None}))
            by_axes.setdefault(key, []).append(p)
        total = None
        for axes, ps in sorted(by_axes.items()):
            s = torch.stack(ps).sum()
            for a in axes:
                s = comm.all_reduce_sum(s, self.mesh.group(a))
            total = s if total is None else total + s
        return total

    def dot(self, a: List[torch.Tensor], b: List[torch.Tensor]
            ) -> torch.Tensor:
        return self.sq_sum([p.sum() for p in torch._foreach_mul(a, b)])
