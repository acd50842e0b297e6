"""Training engine — port of multinn_tpu/training/trainer.py.

An epoch loop over windowed pianoroll batches; Adam, AdamW or SGD with
momentum behind the global-norm clip, written as optax writes them, or
Hessian-free macro-steps (``optimizer="hf"``, RNN-NADE only:
training/hf.py, its ``HFState`` the optimizer state); CD-k updates for RBM
decoders and exact-likelihood updates for NADE decoders, both through
``multinn.loss``; per-epoch validation, early
stopping, checkpoints (the last ``keep_last`` plus the best) with exact
mid-epoch resume, and a JSONL + TensorBoard metrics log under ``run_dir``.
DBN encoders are pre-trained greedily by CD before the first epoch
(``pretrain_encoders``) and frozen afterwards: the optimizer holds only
the decoder's tensors, so the encoder's get no update of any kind (no
Adam moment, no weight decay), in a captured group as well.

A step runs the teacher-forced recurrence, then the family's kernels (the
Gibbs chain per track, or one launch of the NADE likelihood kernels for all
tracks), then autograd and the optimizer, in place on the parameters. The
optimizer's state lives on the device, its step count included, and the
learning rate and Adam's bias corrections are tensor functions of that
count, so no step reads the host. ``steps_per_call`` N > 1 runs each group
of N steps as one CUDA graph on the card (``StepGroupGraph``): captured at
the first group, then replayed with the group's batch and key copied into
its static input buffers; the CPU runs the same N steps in a Python loop.

Keys follow the JAX trainer: ``rng = PRNGKey(seed)``, ``rng, init_key =
split(rng)`` at construction, then ``rng, key = split(rng)`` per step (per
group of N steps, whose keys are ``split(key, N)``), so a step draws the
Gibbs chain's stream from the same key as the JAX step.

With ``train.image_summaries`` every evaluation also logs a pianoroll
image of one free-running sample (``valid/sample``: the scan path, B=1,
``data.window`` steps, on the trainer's key stream) and, once, of the first
validation window (``valid/reference``) to TensorBoard.

Every step body (the eager step, the group a CUDA graph captures,
evaluation and encoder pre-training) runs under the matmul policy of
``model.matmul_dtype`` (ops/precision.py); the Hessian-free step pins f32
inside it.

With ``mesh.use_mesh`` each rank of the ``torch.distributed`` world (made
first: parallel/mesh.init_distributed) runs a Trainer on the mesh of
``cfg.mesh`` (parallel/mesh.py). Every rank reads the same seeded batches
and takes its block (``_put_batch``). ``mesh.style``:

  * ``gspmd`` — the global-view step: the params are cut to this rank's
    part (tracks over ``track``, H over ``model``), the model functions
    run on its part with the collectives the partitioner would insert
    (models/multinn.py), the samplers draw each row's stream in the whole
    batch, and the gradients are averaged over ``data``; the step equals
    the single-device step;
  * ``shard_map`` / ``seqpipe`` — per-shard steps with the key folded by
    the shard's index on each mean axis (``data``, and ``seq`` with the
    window's time chunks pipelined, parallel/seqpipe.py), the gradients
    and metrics averaged over them.

The clip's global norm sums every tensor's part over the axes it is split
over. ``evaluate`` pads a short tail batch with zero-mask windows and sums
the frame-weighted metric sums over the mean axes, exact for every style.
Rank 0 alone writes the log, the metrics and the checkpoints; a checkpoint
holds the full parameters (gathered) in the single-device format and
restores on any mesh or on one device (sliced). On a mesh whose backend
is NCCL (every rank with a card of its own) each rank captures its groups
of ``steps_per_call`` steps as one CUDA graph, its collectives inside, as
without a mesh: every rank warms up and captures at the same group with
the same collectives, and the graph takes this rank's block of the
stacked batch. Under gloo (the CPU, or ranks that share a card) the groups
run eagerly: gloo's collectives cannot be captured. ``pretrain_encoders``
runs the global view on every rank alike.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from multinn_torch.models import multinn
from multinn_torch.ops import _build, precision, sampling
from multinn_torch.parallel import comm
from multinn_torch.parallel import mesh as mesh_mod
from multinn_torch.training import hf as hf_mod
from multinn_torch.training.checkpoint import Checkpointer
from multinn_torch.training.metrics import FRAME_COUNTS, frame_ratios
from multinn_torch.utils import profiling
from multinn_torch.utils.device import entry_device
from multinn_torch.utils.logging import (MetricsLogger, format_metrics,
                                         setup_logger)

class FaultInjected(RuntimeError):
    """Raised by ``train.fault_inject_step`` (the resume path's test)."""


def _f32(count) -> torch.Tensor:
    return torch.as_tensor(count).to(torch.float32)


def _track_mean_ratios(counts: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The frame ratios of every track's counts (K, 5), averaged over the
    tracks as ``multinn.loss`` averages the metrics."""
    return {name: v.mean(dim=0) for name, v in frame_ratios(counts).items()}


def _linear_schedule(init: float, end: float, steps: int):
    """optax.linear_schedule(init, end, steps) on a float32 count."""
    if steps <= 0:
        return lambda c: torch.full_like(c, init)

    def schedule(c: torch.Tensor) -> torch.Tensor:
        frac = 1 - torch.clamp(c, 0, steps) / steps
        return (init - end) * frac + end
    return schedule


def make_schedule(cfg, steps_per_epoch: int = 0
                  ) -> Callable[[Any], torch.Tensor]:
    """The learning rate as a function of the optimizer step (0-based; an
    int or an integer tensor on any device), with optax's values in
    float32: constant, linear warmup into constant, or warmup into cosine
    decay to ``lr_min`` over ``decay_steps`` (0 = epochs x steps_per_epoch,
    which includes the warmup). Tensor ops only, so a captured graph
    computes the rate of each replay's own step."""
    lr = cfg.lr
    if cfg.lr_schedule == "constant":
        inner = (_linear_schedule(0.0, lr, cfg.warmup_steps)
                 if cfg.warmup_steps else _linear_schedule(lr, lr, 0))
        return lambda count: inner(_f32(count))
    if cfg.lr_schedule == "cosine":
        warm = cfg.warmup_steps
        decay = cfg.decay_steps or max(cfg.epochs * max(steps_per_epoch, 1),
                                       1)
        span = max(decay, warm + 1) - warm
        alpha = 0.0 if lr == 0.0 else cfg.lr_min / lr
        warmup = _linear_schedule(0.0 if warm else lr, lr, warm)

        def schedule(count) -> torch.Tensor:
            c = _f32(count)
            t = torch.clamp(c - warm, max=span)
            cosine = 0.5 * (1 + torch.cos(math.pi * t / span))
            out = lr * ((1 - alpha) * cosine + alpha)
            return torch.where(c < warm, warmup(c), out) if warm else out
        return schedule
    raise ValueError(f"unknown lr_schedule '{cfg.lr_schedule}'")


class Optimizer:
    """optax's ``chain(clip_by_global_norm(grad_clip), adam(lr))`` —
    ``adamw`` with weight decay, or ``add_decayed_weights`` + ``sgd(lr,
    momentum=0.9)`` — on a list of parameter tensors, updated in place. The
    state's ``count`` is an int32 device tensor advanced in place."""

    B1, B2, EPS, MOMENTUM = 0.9, 0.999, 1e-8, 0.9

    def __init__(self, cfg, steps_per_epoch: int = 0):
        if cfg.optimizer not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer '{cfg.optimizer}'")
        self.kind = cfg.optimizer
        self.clip = cfg.grad_clip
        self.weight_decay = cfg.weight_decay
        self.lr = make_schedule(cfg, steps_per_epoch)

    def init(self, params) -> Dict[str, Any]:
        zeros = lambda: [torch.zeros_like(p) for p in params]
        count = torch.zeros((), dtype=torch.int32, device=params[0].device)
        if self.kind == "adam":
            return {"count": count, "mu": zeros(), "nu": zeros()}
        return {"count": count, "trace": zeros()}

    @torch.no_grad()
    def update(self, params, grads, state, sq_sum=None) -> torch.Tensor:
        """One step on ``params`` from ``grads``; returns the gradients'
        global norm before the clip (a device scalar: no host sync).
        ``sq_sum`` sums the tensors' squared norms where the tensors are
        parts of a mesh's parameters (parallel.mesh.Reduce.sq_sum)."""
        grads = list(grads)
        if sq_sum is None:
            norm = torch.stack(torch._foreach_norm(grads)).square().sum(
            ).sqrt()
        else:
            norm = sq_sum([n.square() for n in
                           torch._foreach_norm(grads)]).sqrt()
        if self.clip and self.clip > 0:
            # optax: unchanged below the limit, else scaled to it; no epsilon
            scale = torch.where(norm < self.clip, torch.ones_like(norm),
                                self.clip / norm)
            grads = torch._foreach_mul(grads, scale)
        count = state["count"]
        lr = self.lr(count)
        count.add_(1)
        if self.kind == "adam":
            mu, nu = state["mu"], state["nu"]
            torch._foreach_mul_(mu, self.B1)
            torch._foreach_add_(mu, grads, alpha=1 - self.B1)
            torch._foreach_mul_(nu, self.B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - self.B2)
            steps = count.to(torch.float32)
            denom = torch._foreach_div(nu, 1 - torch.pow(self.B2, steps))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.EPS)
            upd = torch._foreach_div(mu, 1 - torch.pow(self.B1, steps))
            torch._foreach_div_(upd, denom)
            if self.weight_decay:                 # adamw: decoupled decay
                torch._foreach_add_(upd, params, alpha=self.weight_decay)
        else:
            if self.weight_decay:                 # classic L2 before momentum
                grads = torch._foreach_add(grads, params,
                                           alpha=self.weight_decay)
            trace = state["trace"]
            torch._foreach_mul_(trace, self.MOMENTUM)
            torch._foreach_add_(trace, grads)
            upd = list(trace)
        torch._foreach_sub_(params, torch._foreach_mul(upd, lr))
        return norm


def make_optimizer(cfg, steps_per_epoch: int = 0) -> Optimizer:
    return Optimizer(cfg, steps_per_epoch)


class _QuietMetrics:
    """The metrics sink of a rank other than 0: it writes nothing."""

    def log(self, *args, **kwargs) -> None:
        pass

    def log_image(self, *args, **kwargs) -> bool:
        return False

    def close(self) -> None:
        pass


def _quiet_logger(rank: int):
    import logging
    log = logging.getLogger(f"multinn_torch.rank{rank}")
    if not log.handlers:
        log.addHandler(logging.NullHandler())
        log.propagate = False
    return log


def _host(v: torch.Tensor):
    a = v.detach().cpu().numpy()
    return float(a) if a.ndim == 0 else a


class CudaGraph:
    """Capture and replay of one CUDA graph, PyTorch's whole-network recipe:
    warm-up on a side stream, then capture on the same stream into the
    graph's private memory pool. ``pool_bytes`` is the device memory the
    capture reserved. ``capture_error_mode`` is ``torch.cuda.graph``'s:
    ``thread_local`` on a mesh, where NCCL's watchdog thread queries
    events while this thread captures (``global`` forbids that)."""

    def __init__(self, device: torch.device,
                 capture_error_mode: str = "global"):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.stream = torch.cuda.Stream(device)
        self.capture_error_mode = capture_error_mode
        self.pool_bytes = 0

    def warmup(self, fn) -> None:
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            fn()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def capture(self, fn):
        # torch.cuda.graph empties the allocator's cache on entry: empty it
        # first, so the reserved bytes grow by the graph's pool alone
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self.device)
        with torch.cuda.graph(self.graph, stream=self.stream,
                              capture_error_mode=self.capture_error_mode):
            out = fn()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - before
        return out

    def replay(self) -> None:
        self.graph.replay()


class StepGroupGraph:
    """A group of N train steps as one replayable graph — the port of
    ``Trainer._build_multi_step``: ``split(key, N)`` on the device, steps
    1 to N-1 on the hot loss, the last one detailed with ``loss_mean``.

    The stacked uint8 batch (N, B, T, K, D) — on a mesh this rank's block
    of it (``Trainer._block``) — and the key enter through
    static buffers filled by ``copy_`` before each replay; the metrics come
    out in the graph's own tensors, overwritten by the next replay. The
    graph holds the addresses of the trainer's parameters and optimizer
    state, so they must be updated in place, never rebound (``restore``
    copies into them). Neither the warm-up (two steps) nor the capture
    advances the trainer: its state is copied back after both, and after
    a capture that fails, which raises (there is no eager fallback).

    Launch counts: a replay runs the captured kernels without running their
    wrappers' Python, so the counts the wrappers add during the capture
    (where nothing runs) are taken back out of ``_build.launches`` and
    added again at every replay (``launches``)."""

    def __init__(self, trainer: "Trainer", n: int, batch_shape, graph):
        dev = trainer.device
        self.graph = graph
        self.x = torch.zeros((n, *batch_shape), dtype=torch.uint8,
                             device=dev)
        self.key = torch.zeros(2, dtype=torch.uint32, device=dev)
        saved = [t.detach().clone() for t in trainer._state_tensors()]
        counts = collections.Counter(_build.launches)
        try:
            graph.warmup(lambda: trainer._group_body(
                self.x[:min(n, 2)].to(torch.float32), self.key))
            counts = collections.Counter(_build.launches)
            t0 = time.perf_counter()
            self.out = graph.capture(lambda: trainer._group_body(
                self.x.to(torch.float32), self.key))
            self.capture_s = time.perf_counter() - t0
            self.launches = collections.Counter(_build.launches) - counts
        finally:                  # a failed capture raises, state restored
            _build.launches.clear()
            _build.launches.update(counts)
            trainer._load_state_tensors(saved)

    def __call__(self, stacked: np.ndarray, key: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        if tuple(stacked.shape) != tuple(self.x.shape):
            raise ValueError(f"a captured group takes {tuple(self.x.shape)} "
                             f"batches, got {tuple(stacked.shape)}")
        src = torch.from_numpy(np.ascontiguousarray(stacked))
        with profiling.span("train.pin"):
            if self.x.is_cuda:            # pinned: the copy does not block
                src = src.pin_memory()
        stream = (torch.cuda.current_stream(self.x.device)
                  if self.x.is_cuda else None)
        with profiling.card_interval("train.card", stream=stream), \
                profiling.span("train.replay"):
            self.x.copy_(src, non_blocking=True)
            self.key.copy_(key)
            self.graph.replay()
        _build.launches.update(self.launches)
        return self.out


class Trainer:
    """Trains ``params`` (the port's MultINNParams; their tensors' device is
    the training device) on ``dataset``: the port's ``Dataset`` built from
    ``cfg.data`` when None, or any object with its interface
    (``batches(split, epoch=, shuffle=, drop_remainder=, with_masks=,
    augment=)`` yielding uint8 (B, T, K, D) arrays, plus (B, T) masks with
    ``with_masks``; ``n_batches(split)``). Without ``params`` the model is
    initialised on ``device`` (the CUDA card when None, which raises without
    one) from a torch.Generator seeded with the init key's words (the port
    has no jax.random.normal). The run's files go under
    ``cfg.train.run_dir``: ``train.log``, ``metrics.jsonl``, ``tb/`` and
    ``ckpt/``."""

    def __init__(self, cfg, dataset=None, params=None, device=None):
        self.cfg = cfg
        self.mesh = mesh_mod.make_mesh(cfg.mesh)
        self._gspmd = self.mesh is not None and cfg.mesh.style == "gspmd"
        self._seqpipe = self.mesh is not None and cfg.mesh.style == "seqpipe"
        self.track_sharded = self._gspmd and cfg.mesh.track > 1
        # the axes per-shard gradients and metrics are averaged over
        self._mean_axes = (() if self.mesh is None else
                           (mesh_mod.DATA_AXIS,) + ((mesh_mod.SEQ_AXIS,)
                                                    if self._seqpipe else ()))
        self.rank = dist.get_rank() if self.mesh is not None else 0
        self.device = (entry_device(device) if params is None
                       else params.decoder.w.device)
        self.log = (setup_logger(run_dir=cfg.train.run_dir)
                    if self.rank == 0 else _quiet_logger(self.rank))
        if dataset is None:
            from multinn_torch.data.datasets import Dataset
            dataset = Dataset(cfg.data)
        self.dataset = dataset
        self.rng = sampling.PRNGKey(cfg.train.seed, device=self.device)
        self.rng, init_key = sampling.split(self.rng)
        if params is None:
            words = sampling.key_to_seeds(init_key).tolist()
            params = multinn.init(cfg.model, torch.Generator().manual_seed(
                (words[0] & 0xFFFFFFFF) << 32 | words[1] & 0xFFFFFFFF),
                device=self.device)
        self.params = multinn.tree_map(lambda t: t.detach().clone(), params)
        # placement: gspmd cuts the params to this rank's part; the
        # explicit styles replicate them
        self._enc_specs = self._dec_specs = None
        if self._gspmd:
            self._enc_specs, self._dec_specs = mesh_mod.leaf_specs(
                self.params, self.mesh, self.track_sharded)
            self.params = mesh_mod.shard_params(self.params, self.mesh,
                                                self.track_sharded)
        self._red = mesh_mod.Reduce(self.mesh, self._mean_axes,
                                    self._dec_specs, self.track_sharded)
        # the optimizer's tensors: the decoder's; a DBN encoder is frozen
        self._leaves = [t.requires_grad_(True)
                        for t in multinn.tree_leaves(self.params.decoder)]
        # every parameter tensor, encoder first (checkpoints, graph state)
        self._all_leaves = multinn.tree_leaves(self.params)
        self._hf = cfg.train.optimizer == "hf"
        if self._hf:
            if cfg.model.decoder_type != "rnn-nade":
                raise ValueError("optimizer='hf' requires an rnn-nade "
                                 "decoder (CD has no objective to "
                                 "second-order optimize)")
            self.optimizer = None
            self.opt_state = hf_mod.init_state(self.params,
                                               cfg.train.hf_lambda0)
        else:
            self.optimizer = make_optimizer(
                cfg.train, steps_per_epoch=self.dataset.n_batches("train"))
            self.opt_state = self.optimizer.init(self._leaves)
        self.step = 0
        self.epoch = 0
        # the global step at the start of the current epoch: step -
        # epoch_step0 batches of this epoch are consumed (the resume cursor)
        self.epoch_step0 = 0
        self.best_valid = float("inf")
        self._bad_epochs = 0
        self._epoch_final_step = -1
        self.history: list = []          # (step, metrics) of logged steps
        # pretrain_encoders' decode calibration (marginals and their ratio)
        self.calibration: Optional[Dict[str, float]] = None
        self.metrics_log = (MetricsLogger(cfg.train.run_dir)
                            if self.rank == 0 else _QuietMetrics())
        self.ckpt = Checkpointer(os.path.join(cfg.train.run_dir, "ckpt"),
                                 keep_last=cfg.train.keep_last,
                                 keep_best=cfg.train.keep_best)
        self.capture_groups = self._choose_capture()
        self.group_graph: Optional[StepGroupGraph] = None
        self.groups_run = 0                # run_group calls (span ids)
        self._logged_reference = False     # valid/reference is logged once

    def _choose_capture(self) -> bool:
        """Whether groups of ``steps_per_call`` steps run as a CUDA graph:
        on the card, without a mesh or on an NCCL mesh; a gloo mesh on
        the card runs them eagerly (gloo's collectives cannot be
        captured) and says so in the log."""
        if self.device.type != "cuda":
            return False
        if self.mesh is None or self.mesh.backend == "nccl":
            return True
        if self.cfg.train.steps_per_call > 1:
            self.log.info("mesh training on %s: groups of %d steps run "
                          "eagerly (no CUDA graph)", self.mesh.backend,
                          self.cfg.train.steps_per_call)
        return False

    # -- state -------------------------------------------------------------

    def _opt_dict(self) -> Dict[str, Any]:
        """The optimizer state by name (tensors or lists of tensors): the
        first-order optimizer's dict, or the HFState's fields."""
        if self._hf:
            return {f.name: getattr(self.opt_state, f.name)
                    for f in dataclasses.fields(self.opt_state)}
        return self.opt_state

    def _policy(self):
        """The matmul policy of ``model.matmul_dtype`` (ops/precision.py)."""
        return precision.matmul_precision(self.cfg.model.matmul_dtype)

    def _state_tensors(self) -> List[torch.Tensor]:
        """Every parameter and optimizer tensor, in a fixed order (a step
        updates all but the encoder's in place)."""
        out = list(self._all_leaves)
        for v in self._opt_dict().values():
            out += v if isinstance(v, list) else [v]
        return out

    def _state_specs(self) -> Optional[List[tuple]]:
        """The mesh placement of each ``_state_tensors`` entry (the
        optimizer's lists follow the decoder's tensors); None where the
        state is whole on every rank."""
        if self._dec_specs is None:
            return None
        out = list(self._enc_specs) + list(self._dec_specs)
        for v in self._opt_dict().values():
            out += list(self._dec_specs) if isinstance(v, list) else [()]
        return out

    def _full_state(self) -> List[torch.Tensor]:
        """``_state_tensors`` whole: every rank's parts gathered (every
        rank must call this)."""
        specs = self._state_specs()
        tensors = self._state_tensors()
        if specs is None:
            return tensors
        return [mesh_mod.gather_tensor(t, sp, self.mesh)
                for t, sp in zip(tensors, specs)]

    def full_params(self) -> multinn.MultINNParams:
        """The whole parameters (a mesh's parts gathered; every rank must
        call this), e.g. for a Generator."""
        if not self._gspmd:
            return self.params
        return mesh_mod.gather_params(self.params, self.mesh,
                                      self.track_sharded)

    @torch.no_grad()
    def _load_state_tensors(self, values) -> None:
        """Copy ``values`` into the state tensors (never rebinding them: a
        captured graph holds their addresses)."""
        dst = self._state_tensors()
        if len(values) != len(dst):
            raise ValueError(f"state has {len(values)} tensors, the trainer "
                             f"{len(dst)}")
        for t, v in zip(dst, values):
            if tuple(t.shape) != tuple(v.shape):
                raise ValueError(f"state tensor shape {tuple(v.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(v)

    # -- steps ---------------------------------------------------------------

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type == "cuda":    # pinned: the copy does not block
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t.to(torch.float32)

    def _block(self, batch: np.ndarray, lead: int = 0) -> np.ndarray:
        """This rank's block of a host batch (B, T, K, D), a (B, T) mask
        or a group's (N, B, T, K, D) (``lead`` 1): B over ``data``, K over
        ``track`` when track-sharded, T over ``seq`` under seqpipe (the
        whole batch without a mesh)."""
        return mesh_mod.shard_batch(batch, self.mesh, self.track_sharded,
                                    self._seqpipe, lead)

    def _put_batch(self, batch: np.ndarray, lead: int = 0) -> torch.Tensor:
        """``_block`` of a host batch, on the device."""
        return self._to_device(self._block(batch, lead))

    def _shard(self, x: torch.Tensor):
        """The model's part of a gspmd step on the local batch x."""
        if not self._gspmd:
            return None
        return mesh_mod.shard_of(self.mesh,
                                 x.shape[0] * self.mesh.size(
                                     mesh_mod.DATA_AXIS),
                                 self.track_sharded)

    def _seq_spec(self, x: torch.Tensor):
        """The seqpipe context for the local batch x (None otherwise)."""
        if not self._seqpipe:
            return None
        from multinn_torch.parallel import seqpipe
        n_seq = self.cfg.mesh.seq
        return seqpipe.SeqSpec(
            axis=mesh_mod.SEQ_AXIS, n_seq=n_seq,
            microbatches=seqpipe.auto_microbatches(
                x.shape[0], n_seq, self.cfg.mesh.seq_microbatches),
            group=self.mesh.group(mesh_mod.SEQ_AXIS),
            index=self.mesh.index(mesh_mod.SEQ_AXIS))

    def _fold_shard_key(self, key: torch.Tensor) -> torch.Tensor:
        """The explicit styles' per-shard key: folded by the shard's index
        on each mean axis (the reference's _fold_shard_key)."""
        if self.mesh is None or self._gspmd:
            return key
        for axis in self._mean_axes:
            key = sampling.fold_in(key, self.mesh.index(axis))
        return key

    def _mean_metrics(self, metrics: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """Metrics averaged over the mean axes (the reference's pmean); the
        frame counts of a data split summed in the same all-reduce and the
        ratios formed from the sums (the reference's global view)."""
        if self.mesh is None:
            return metrics
        metrics = dict(metrics)
        counts = metrics.pop(FRAME_COUNTS, None)
        sums = [] if counts is None else [counts.clone()]
        names = list(metrics)
        vals = self._red.mean([metrics[n].detach().clone() for n in names],
                              sums)
        metrics = dict(zip(names, vals))
        if sums:
            metrics.update(_track_mean_ratios(sums[0]))
        return metrics

    def train_step(self, x: torch.Tensor, key: torch.Tensor,
                   detailed: bool = False) -> Dict[str, torch.Tensor]:
        """One optimizer step on the float batch x (B, T, K, D): the loss,
        its gradients, the clipped update. Returns the metrics as detached
        device tensors (the detailed form adds the monitoring metrics), with
        ``grad_norm``, the gradients' norm before the clip. Under
        ``optimizer="hf"`` one Hessian-free macro-step (``detailed`` does
        not apply: it reports its own diagnostics, hf.hf_step), its
        results copied into the parameters and the HFState in place."""
        with self._policy():
            if self._hf:
                return self._hf_step(x, key)
            loss, metrics = multinn.loss(
                self.params, self._fold_shard_key(key), x, detailed=detailed,
                shard=self._shard(x), seq=self._seq_spec(x))
            grads = torch.autograd.grad(loss, self._leaves)
            metrics = {k: v.detach() for k, v in metrics.items()}
            if self.mesh is not None:
                grads = self._red.mean(list(grads))
                metrics = self._mean_metrics(metrics)
            metrics["grad_norm"] = self.optimizer.update(
                self._leaves, grads, self.opt_state,
                sq_sum=None if self.mesh is None else self._red.sq_sum)
            return metrics

    def _hf_step(self, x: torch.Tensor, key: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        new_params, new_state, metrics = hf_mod.hf_step(
            self.params, self.opt_state, x, self._fold_shard_key(key),
            cg_iters=self.cfg.train.hf_cg_iters, red=self._red,
            shard=self._shard(x), seq=self._seq_spec(x))
        with torch.no_grad():
            torch._foreach_copy_(self._leaves,
                                 multinn.tree_leaves(new_params.decoder))
            st = self.opt_state
            st.lam.copy_(new_state.lam)
            torch._foreach_copy_(st.delta, new_state.delta)
            st.accepted.copy_(new_state.accepted)
        return metrics

    def _group_body(self, xs: torch.Tensor, key: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """len(xs) steps under ``split(key, len(xs))``: the hot form, then
        the detailed last step with ``loss_mean`` (JAX ``multi_fn``)."""
        n = xs.shape[0]
        keys = sampling.split(key, n)
        losses = []
        for i in range(n):
            metrics = self.train_step(xs[i], keys[i], detailed=i == n - 1)
            losses.append(metrics["loss"])
        metrics["loss_mean"] = torch.stack(losses).mean()
        return metrics

    def _new_graph(self):
        return CudaGraph(self.device, "global" if self.mesh is None
                         else "thread_local")

    def run_group(self, stacked: np.ndarray, key: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """One group of steps on the stacked uint8 batches (N, B, T, K, D):
        by replay of the captured graph when ``capture_groups`` (the card,
        without a mesh or on NCCL; the first group captures it, every rank
        at the same group), else eagerly. A capture that fails raises.
        Spans (utils/profiling): ``train.run_group``, identified by the
        group count ``groups_run``, around ``train.pin`` (the batch staged
        for the card) and ``train.replay`` (the group's steps enqueued: the
        replay, or the eager steps), and on the card ``train.card``."""
        g = self.groups_run
        self.groups_run += 1
        with profiling.span("train.run_group", g):
            if not self.capture_groups:
                with profiling.span("train.pin"):
                    xs = self._put_batch(stacked, lead=1)
                with profiling.span("train.replay"):
                    return self._group_body(xs, key)
            block = self._block(stacked, lead=1)
            if self.group_graph is None:
                self.group_graph = StepGroupGraph(self, len(block),
                                                  block.shape[1:],
                                                  self._new_graph())
            return self.group_graph(block, key)

    def _post_step(self, metrics, timing, n_steps: int) -> Dict[str, Any]:
        """Advance the step count; raise an injected fault; on log
        boundaries (the only host synchronisation of the loop) fetch the
        metrics and log them; save on ``ckpt_every_steps`` boundaries but
        the epoch's last step, where ``train()`` saves with metrics."""
        cfg = self.cfg.train
        prev = self.step
        self.step += n_steps
        out: Dict[str, Any] = {}
        if (cfg.fault_inject_step > 0
                and prev < cfg.fault_inject_step <= self.step):
            raise FaultInjected(f"fault injected at step {self.step}")
        every = cfg.log_every_steps
        if prev // every != self.step // every:
            out = {k: _host(v) for k, v in metrics.items()}
            now = time.perf_counter()
            out["steps_per_sec"] = (self.step - timing[0]) / max(
                now - timing[1], 1e-9)
            timing[0], timing[1] = self.step, now
            self.history.append((self.step, out))
            self.metrics_log.log(self.step, out, "train")
            self.log.info("step %d %s", self.step, format_metrics(
                out, ("loss", "f1", "grad_norm", "steps_per_sec")))
        every = cfg.ckpt_every_steps
        if (every and prev // every != self.step // every
                and self.step != self._epoch_final_step):
            self.save_checkpoint()
        return out

    def train_epoch(self) -> Dict[str, Any]:
        """One pass over the train split (augmented, in the dataset's order
        for this epoch), resumed after the batches this epoch already took
        (``step - epoch_step0``). Returns the metrics of the last logged
        step. Logging steps run the detailed step. ``train()`` advances the
        epoch."""
        cfg = self.cfg.train
        self._epoch_final_step = (self.epoch_step0
                                  + self.dataset.n_batches("train"))
        spc = max(cfg.steps_per_call, 1)
        # an injected fault must fire at its exact step: no groups then
        fuse = spc > 1 and cfg.fault_inject_step <= 0
        skip = self.step - self.epoch_step0
        if skip:
            self.log.info("resuming epoch %d at batch %d", self.epoch, skip)
        timing = [self.step, time.perf_counter()]
        last: Dict[str, Any] = {}

        def run_single(batch):
            self.rng, key = sampling.split(self.rng)
            detailed = (self.step + 1) % cfg.log_every_steps == 0
            return self._post_step(
                self.train_step(self._put_batch(batch), key, detailed),
                timing, 1)

        pending: list = []
        for i, batch in enumerate(self.dataset.batches(
                "train", epoch=self.epoch, augment=True)):
            if i < skip:
                continue
            if not fuse:
                last = run_single(batch) or last
                continue
            pending.append(batch)
            if len(pending) == spc:
                self.rng, key = sampling.split(self.rng)
                metrics = self.run_group(np.stack(pending), key)
                pending = []
                last = self._post_step(metrics, timing, spc) or last
        for batch in pending:                 # leftover < spc: single steps
            last = run_single(batch) or last
        return last

    @torch.no_grad()
    def _eval_step(self, x, key, mask, whole: bool = False
                   ) -> Dict[str, torch.Tensor]:
        """Frame-weighted metric sums of one batch, and ``n_frames`` (on a
        mesh, this rank's block, the sums then summed over the mean axes;
        ``whole``: a gspmd batch whole on every rank, ``_eval_tail``)."""
        k_loss, k_ll = sampling.split(self._fold_shard_key(key))
        shard = (mesh_mod.shard_of(self.mesh, None, self.track_sharded)
                 if whole else self._shard(x))
        seq = self._seq_spec(x)
        with self._policy():
            _, metrics = multinn.loss(self.params, k_loss, x,
                                      frame_mask=mask, shard=shard, seq=seq)
            ll = multinn.log_likelihood(self.params, k_ll, x,
                                        frame_mask=mask, shard=shard,
                                        seq=seq)
        counts = metrics.pop(FRAME_COUNTS, None)
        n_frames = mask.sum()
        metrics["ll_per_frame"] = ll.sum() / (
            torch.clamp(n_frames, min=1.0) * self.cfg.model.n_tracks)
        weighted = {name: v * n_frames for name, v in metrics.items()}
        weighted["n_frames"] = n_frames
        if self.mesh is not None and not whole:
            names = list(weighted)
            sums = [] if counts is None else [counts.clone()]
            vals = comm.sum_([weighted[n].clone() for n in names] + sums,
                             self._red.mean_groups)
            weighted = dict(zip(names, vals))
            if sums:        # a data split: the ratios of the batch's counts
                weighted.update({
                    name: v * weighted["n_frames"]
                    for name, v in _track_mean_ratios(sums[0]).items()})
        return weighted

    def _eval_tail(self, batch: np.ndarray, mask: np.ndarray, key
                   ) -> Dict[str, torch.Tensor]:
        """``_eval_step`` of a gspmd short tail batch (B not a multiple of
        the data width), whole on every rank at its own shape as the
        reference's global view evaluates it, so its draws are one
        device's; K over ``track`` when track-sharded."""
        if self.track_sharded:
            batch = batch[:, :, mesh_mod.track_slice(batch.shape[2],
                                                     self.mesh)]
        return self._eval_step(self._to_device(batch), key,
                               self._to_device(mask), whole=True)

    def evaluate(self, split: str = "valid") -> Dict[str, float]:
        """Frame-weighted metrics over the split: per-batch sums divided by
        the total count of real frames, the short tail batch included at
        its own size (gspmd: ``_eval_tail``; the explicit styles pad it to
        the data width with zero-mask windows, which add no frame and no
        sum). Per-track vectors come out as ``<name>_<k>``."""
        sums: Dict[str, np.ndarray] = {}
        n_total = 0.0
        key = sampling.PRNGKey(self.cfg.train.seed + 1000 + self.epoch,
                               device=self.device)
        n_data = (1 if self.mesh is None
                  else self.mesh.size(mesh_mod.DATA_AXIS))
        for batch, mask in self.dataset.batches(split, shuffle=False,
                                                drop_remainder=False,
                                                with_masks=True):
            key, k = sampling.split(key)
            if len(batch) % n_data and self._gspmd:
                m = self._eval_tail(batch, mask, k)
            else:
                if len(batch) % n_data:
                    pad = n_data - len(batch) % n_data
                    batch = np.concatenate([batch, np.zeros(
                        (pad, *batch.shape[1:]), batch.dtype)])
                    mask = np.concatenate([mask, np.zeros(
                        (pad, *mask.shape[1:]), mask.dtype)])
                m = self._eval_step(self._put_batch(batch), k,
                                    self._put_batch(mask))
            m = {name: v.cpu().numpy() for name, v in m.items()}
            n_total += float(m.pop("n_frames"))
            for name, a in m.items():
                sums[name] = sums.get(name, 0.0) + a
        denom = max(n_total, 1.0)
        out: Dict[str, float] = {}
        for name, v in sums.items():
            if np.ndim(v) == 0:
                out[name] = float(v) / denom
            else:
                for i, vi in enumerate(np.asarray(v)):
                    out[f"{name}_{i}"] = float(vi) / denom
        return out

    def _log_image_summaries(self) -> None:
        """TensorBoard pianoroll images at evaluation: a free-running
        sample from the current params (``valid/sample``; the scan path,
        so one Gibbs chain or NADE sampler launch per step and track) and,
        once, the first validation window (``valid/reference``). The
        sample is a picture, not an evaluation metric."""
        if not self._logged_reference:
            ref = np.asarray(self.dataset.windows["valid"][0])
            self.metrics_log.log_image(
                "valid/reference", self.dataset.decode(ref[None])[0],
                self.step)
            self._logged_reference = True
        self.rng, key = sampling.split(self.rng)
        params = self.full_params()      # on a mesh rank 0 draws alone
        if self.rank != 0:
            return
        with torch.no_grad():
            state = multinn.init_state(params, 1)
            _, roll = multinn.generate(params, key, state,
                                       int(self.cfg.data.window),
                                       fused=False)
        roll = roll.to(torch.uint8).cpu().numpy()
        self.metrics_log.log_image(
            "valid/sample", self.dataset.decode(roll)[0], self.step)

    # -- checkpoints -------------------------------------------------------

    def _state_dict(self) -> Dict[str, Any]:
        """The single-device state dict (a mesh's parts gathered)."""
        flat = [t.detach().cpu() for t in self._full_state()]
        n = len(self._all_leaves)
        rest = iter(flat[n:])
        opt = {k: ([next(rest) for _ in v] if isinstance(v, list)
                   else next(rest))
               for k, v in self._opt_dict().items()}
        return {"params": flat[:n], "opt_state": opt,
                "rng": self.rng.detach().cpu().view(torch.int32),
                "step": self.step, "epoch": self.epoch,
                "epoch_step0": self.epoch_step0,
                "best_valid": self.best_valid}

    def save_checkpoint(self, metrics: Optional[Dict[str, float]] = None
                        ) -> None:
        """Write the state as this step's checkpoint: on a mesh every rank
        gathers, rank 0 writes, and the others wait for it."""
        state = self._state_dict()
        if self.rank == 0 and not self.ckpt.save(self.step, state,
                                                  metrics=metrics):
            self.log.warning("checkpoint save at step %d was refused "
                             "(duplicate step?)", self.step)
        if self.mesh is not None:
            comm.barrier()

    def restore(self, step: Optional[int] = None) -> int:
        """Load checkpoint ``step`` (the latest when None) into the
        trainer's existing tensors; returns the step restored."""
        state, at = self.ckpt.restore(step)
        opt = state["opt_state"]
        mine = self._opt_dict()
        if set(opt) != set(mine):
            raise ValueError(f"checkpoint @ step {at} has optimizer state "
                             f"{sorted(opt)}, the trainer {sorted(mine)}")
        values = list(state["params"])
        for k in mine:
            values += opt[k] if isinstance(opt[k], list) else [opt[k]]
        specs = self._state_specs()
        if specs is not None:             # the whole state, cut to our part
            values = [mesh_mod.shard_tensor(v, sp, self.mesh)
                      for v, sp in zip(values, specs)]
        self._load_state_tensors(values)
        self.rng = state["rng"].view(torch.uint32).to(self.device)
        self.step = int(state["step"])
        self.epoch = int(state["epoch"])
        self.epoch_step0 = int(state.get("epoch_step0", -1))
        if self.epoch_step0 < 0:
            self.epoch_step0 = self.step
        self.best_valid = float(state["best_valid"])
        self.log.info("restored checkpoint @ step %d (epoch %d, %d batches "
                      "into the epoch)", self.step, self.epoch,
                      self.step - self.epoch_step0)
        return at

    def maybe_resume(self) -> bool:
        if self.ckpt.latest_step() is not None:
            self.restore()
            return True
        return False

    # -- loops -------------------------------------------------------------

    def pretrain_encoders(self) -> None:
        """Greedy layer-wise CD pre-training of a DBN encoder (a no-op for
        pass-through encoders), as the JAX trainer's: the visible biases
        set to the marginals of the first 2048 train windows, then per
        layer a fresh Adam at ``pretrain_lr`` over
        ``pretrain_encoder_epochs`` epochs of augmented train batches, one
        ``rng, key = split(rng)`` per batch (per-track encoders: track i on
        ``split(key, K)[i]``, the loss their mean; joint mode's one encoder
        on the concatenated K*D frames). Runs under the matmul policy. Logs
        the decode calibration and warns outside 0.5-2x. The trained values
        are copied into the encoder's tensors and the optimizer state is
        reset in place (a captured group holds their addresses): zeros, or
        a fresh HFState (``hf_lambda0``, no warm start, no accepts)."""
        cfg = self.cfg
        n_layers = len(cfg.model.encoder_hidden)
        if n_layers == 0:
            return
        if cfg.train.pretrain_encoder_epochs == 0:
            self.log.warning(
                "DBN encoder (%s) with pretrain_encoder_epochs=0: the "
                "encoder is FROZEN during joint training, so it keeps "
                "whatever weights it was constructed/restored with — "
                "random init unless pre-trained externally; set "
                "train.pretrain_encoder_epochs>0 unless that is deliberate",
                cfg.model.encoder_hidden)
            return
        with self._policy():
            self._pretrain_encoders(n_layers)

    def _pretrain_encoders(self, n_layers: int) -> None:
        from types import SimpleNamespace

        from multinn_torch.models import encoders as enc_mod
        cfg = self.cfg
        k_tracks = cfg.model.n_tracks
        joint = cfg.model.mode == "joint"
        shared = cfg.model.mode != "per-track"
        per_track = lambda fn, enc, *xs: [
            fn(multinn.index_tree(enc, i), *(x[i] for x in xs))
            for i in range(k_tracks)]
        adam = SimpleNamespace(optimizer="adam", grad_clip=0.0,
                               weight_decay=0.0, lr=cfg.train.pretrain_lr,
                               lr_schedule="constant", warmup_steps=0)

        def enc_input(batch):   # (B, T, K, D) -> (K, ...); joint: (B, T, K*D)
            x = self._to_device(batch)
            if joint:
                return x.reshape(*x.shape[:2], -1)
            return x.movedim(2, 0)

        # start the decode conditional calibrated to the data marginal
        x_cal = enc_input(self.dataset.windows["train"][:2048])
        enc = self.params.encoder
        if self._enc_specs is not None:   # the global view: whole encoder
            enc = multinn.with_leaves(enc, [
                mesh_mod.gather_tensor(t, sp, self.mesh) for t, sp in
                zip(multinn.tree_leaves(enc), self._enc_specs)])
        enc = multinn.tree_map(lambda t: t.detach().clone(), enc)
        if shared:
            enc = enc_mod.init_visible_biases(enc, x_cal)
        else:
            enc = multinn.stack_trees(per_track(enc_mod.init_visible_biases,
                                                enc, x_cal))
        for layer in range(n_layers):
            leaves = [t.requires_grad_(True) for t in
                      multinn.tree_leaves(enc[layer])]
            opt = Optimizer(adam)
            opt_state = opt.init(leaves)
            for ep in range(cfg.train.pretrain_encoder_epochs):
                losses = []
                for batch in self.dataset.batches("train", epoch=ep,
                                                  augment=True):
                    self.rng, key = sampling.split(self.rng)
                    x = enc_input(batch)
                    if shared:
                        loss = enc_mod.pretrain_loss(enc, key, x, layer)
                    else:
                        loss = torch.stack(per_track(
                            lambda e, kk, xx: enc_mod.pretrain_loss(
                                e, kk, xx, layer),
                            enc, sampling.split(key, k_tracks), x)).mean()
                    grads = torch.autograd.grad(loss, leaves)
                    opt.update(leaves, grads, opt_state)
                    losses.append(loss.detach())
                self.log.info("pretrain layer %d epoch %d cd-loss %.4f",
                              layer, ep,
                              float(torch.stack(losses).mean()) if losses
                              else float("nan"))
            for t in leaves:
                t.requires_grad_(False)
        with torch.no_grad():
            if shared:
                cal = enc_mod.decode_calibration(enc, x_cal)
            else:
                rows = per_track(enc_mod.decode_calibration, enc, x_cal)
                cal = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        cal = {k: float(v.mean()) for k, v in cal.items()}
        ratio = cal["decode_mean"] / max(cal["data_mean"], 1e-9)
        self.log.info(
            "pretrained decode calibration: data marginal %.4f, decode "
            "marginal %.4f (%.2fx), P(on|on-bit) %.3f, P(on|off-bit) %.4f",
            cal["data_mean"], cal["decode_mean"], ratio,
            cal["p_on_given_on"], cal["p_on_given_off"])
        if not 0.5 <= ratio <= 2.0:
            self.log.warning(
                "DBN decode conditional is MISCALIBRATED (decode marginal "
                "%.4f vs data %.4f): generated pianorolls will be ~%.1fx "
                "too %s; increase train.pretrain_encoder_epochs or "
                "train.pretrain_lr", cal["decode_mean"], cal["data_mean"],
                ratio if ratio > 1 else 1 / max(ratio, 1e-9),
                "dense" if ratio > 1 else "sparse")
        self.calibration = dict(cal, ratio=ratio)
        with torch.no_grad():
            specs = self._enc_specs or [()] * len(self._all_leaves)
            for dst, src, sp in zip(multinn.tree_leaves(self.params.encoder),
                                    multinn.tree_leaves(enc), specs):
                dst.copy_(mesh_mod.shard_tensor(src, sp, self.mesh)
                          if self.mesh is not None else src)
            for t in self._state_tensors()[len(self._all_leaves):]:
                t.zero_()
            if self._hf:
                self.opt_state.lam.fill_(cfg.train.hf_lambda0)

    def profile_steps(self, n_steps: int) -> str:
        """A torch.profiler trace of ``n_steps`` warm train steps on the
        first batch into ``<run_dir>/trace``. The state is copied before and
        back after, so training is not perturbed."""
        from torch.profiler import ProfilerActivity, profile
        trace_dir = os.path.join(self.cfg.train.run_dir, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        x = self._put_batch(next(iter(self.dataset.batches("train",
                                                           epoch=0))))
        saved = [t.detach().clone() for t in self._state_tensors()]
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else lambda: None)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            self.train_step(x, sampling.PRNGKey(0, device=self.device))
            sync()
            with profile(activities=activities) as prof:
                for i in range(n_steps):
                    self.train_step(x, sampling.PRNGKey(i + 1,
                                                        device=self.device))
                sync()
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        finally:
            self._load_state_tensors(saved)
        self.log.info("wrote a trace of %d steps to %s", n_steps, trace_dir)
        return trace_dir

    def train(self) -> Dict[str, float]:
        """Epochs up to ``train.epochs``: validation every
        ``eval_every_epochs`` with a checkpoint carrying ``valid_loss`` =
        -ll_per_frame (the CD surrogate is no likelihood), the best tracked,
        early stopping after ``early_stop_patience`` epochs without gain;
        other epochs end in a save without metrics. Returns the last
        validation metrics."""
        cfg = self.cfg.train
        self.log.info("training '%s': %d train batches, model=%s/%s mode=%s",
                      self.cfg.name, self.dataset.n_batches("train"),
                      self.cfg.model.decoder_type, self.cfg.model.cell,
                      self.cfg.model.mode)
        if self.epoch == 0 and self.step == 0:
            self.pretrain_encoders()
        final_eval: Dict[str, float] = {}
        while self.epoch < cfg.epochs:
            t0 = time.perf_counter()
            self.train_epoch()
            self.epoch += 1
            self.epoch_step0 = self.step
            if self.epoch % cfg.eval_every_epochs:
                self.save_checkpoint()
                continue
            ev = self.evaluate("valid")
            final_eval = ev
            self.metrics_log.log(self.step, ev, "valid")
            if cfg.image_summaries:
                self._log_image_summaries()
            self.log.info("epoch %d (%.1fs) valid %s", self.epoch,
                          time.perf_counter() - t0,
                          format_metrics(ev, ("loss", "f1", "ll_per_frame")))
            valid_loss = (-float(ev["ll_per_frame"]) if "ll_per_frame" in ev
                          else float(ev.get("loss", np.inf)))
            self.save_checkpoint(metrics={"valid_loss": valid_loss})
            if valid_loss < self.best_valid - 1e-6:
                self.best_valid = valid_loss
                self._bad_epochs = 0
            else:
                self._bad_epochs += 1
                if (cfg.early_stop_patience
                        and self._bad_epochs >= cfg.early_stop_patience):
                    self.log.info("early stop at epoch %d", self.epoch)
                    break
        self.ckpt.wait()
        return final_eval

    def close(self) -> None:
        self.metrics_log.close()
        self.ckpt.close()
