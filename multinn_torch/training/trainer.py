"""Training engine — port of the single-device path of
multinn_tpu/training/trainer.py.

An epoch loop over windowed pianoroll batches; Adam, AdamW or SGD with
momentum behind the global-norm clip, written as optax writes them;
CD-k updates for RBM decoders and exact-likelihood updates for NADE
decoders, both through ``multinn.loss``. The step runs eagerly: the
teacher-forced recurrence, then the family's kernels (the Gibbs chain per
track, or one launch of the NADE likelihood kernels for all tracks), then
autograd and the optimizer, in place on the parameters. ``steps_per_call``
N runs N steps in a Python loop with no host synchronisation between them
(capturing them as one CUDA graph is later work, ROADMAP queue 2).

Keys follow the JAX trainer: ``rng = PRNGKey(seed)``, ``rng, init_key =
split(rng)`` at construction, then ``rng, key = split(rng)`` per step (per
group of N steps, whose keys are ``split(key, N)``), so a step draws the
Gibbs chain's stream from the same key as the JAX step.

Not ported yet (ROADMAP queue 1), each refused with NotImplementedError:
checkpoints (so ``train()``, which saves every epoch, and the periodic
saves of ``train_epoch``, which the port leaves out), Hessian-free
training, meshes, DBN encoders and their pre-training, image summaries and
fault injection.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict

import numpy as np
import torch

from multinn_torch.models import multinn
from multinn_torch.ops import sampling
from multinn_torch.utils.device import entry_device

_LATER = "not ported to multinn_torch yet (ROADMAP queue 1)"


def _linear_schedule(init: float, end: float, steps: int):
    """optax.linear_schedule(init, end, steps)."""
    if steps <= 0:
        return lambda step: init

    def schedule(step: int) -> float:
        frac = 1 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def make_schedule(cfg, steps_per_epoch: int = 0):
    """The learning rate as a function of the optimizer step (0-based), with
    optax's values: constant, linear warmup into constant, or warmup into
    cosine decay to ``lr_min`` over ``decay_steps`` (0 = epochs x
    steps_per_epoch, which includes the warmup)."""
    lr = cfg.lr
    if cfg.lr_schedule == "constant":
        return _linear_schedule(0.0, lr, cfg.warmup_steps) \
            if cfg.warmup_steps else (lambda step: lr)
    if cfg.lr_schedule == "cosine":
        warm = cfg.warmup_steps
        decay = cfg.decay_steps or max(cfg.epochs * max(steps_per_epoch, 1),
                                       1)
        span = max(decay, warm + 1) - warm
        alpha = 0.0 if lr == 0.0 else cfg.lr_min / lr
        warmup = _linear_schedule(0.0 if warm else lr, lr, warm)

        def schedule(step: int) -> float:
            if step < warm:
                return warmup(step)
            count = min(step - warm, span)
            cosine = 0.5 * (1 + math.cos(math.pi * count / span))
            return lr * ((1 - alpha) * cosine + alpha)
        return schedule
    raise ValueError(f"unknown lr_schedule '{cfg.lr_schedule}'")


class Optimizer:
    """optax's ``chain(clip_by_global_norm(grad_clip), adam(lr))`` —
    ``adamw`` with weight decay, or ``add_decayed_weights`` + ``sgd(lr,
    momentum=0.9)`` — on a list of parameter tensors, updated in place."""

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
        if self.kind == "adam":
            return {"count": 0, "mu": zeros(), "nu": zeros()}
        return {"count": 0, "trace": zeros()}

    @torch.no_grad()
    def update(self, params, grads, state) -> torch.Tensor:
        """One step on ``params`` from ``grads``; returns the gradients'
        global norm before the clip (a device scalar: no host sync)."""
        grads = list(grads)
        norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
        if self.clip and self.clip > 0:
            # optax: unchanged below the limit, else scaled to it; no epsilon
            scale = torch.where(norm < self.clip, torch.ones_like(norm),
                                self.clip / norm)
            grads = torch._foreach_mul(grads, scale)
        lr = self.lr(state["count"])
        state["count"] += 1
        if self.kind == "adam":
            count, mu, nu = state["count"], state["mu"], state["nu"]
            torch._foreach_mul_(mu, self.B1)
            torch._foreach_add_(mu, grads, alpha=1 - self.B1)
            torch._foreach_mul_(nu, self.B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - self.B2)
            denom = torch._foreach_div(nu, 1 - self.B2 ** count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.EPS)
            upd = torch._foreach_div(mu, 1 - self.B1 ** count)
            torch._foreach_div_(upd, denom)
            if self.weight_decay:                 # adamw: decoupled decay
                torch._foreach_add_(upd, params, alpha=self.weight_decay)
        else:
            if self.weight_decay:                 # classic L2 before momentum
                grads = torch._foreach_add(grads, params,
                                           alpha=self.weight_decay)
            upd = state["trace"]
            torch._foreach_mul_(upd, self.MOMENTUM)
            torch._foreach_add_(upd, grads)
        torch._foreach_add_(params, upd, alpha=-lr)
        return norm


def make_optimizer(cfg, steps_per_epoch: int = 0) -> Optimizer:
    return Optimizer(cfg, steps_per_epoch)


def _refuse_unported(cfg) -> None:
    train = cfg.train
    for on, what in ((train.optimizer == "hf", "Hessian-free training"),
                     (cfg.mesh.use_mesh, "mesh training"),
                     (bool(cfg.model.encoder_hidden)
                      or train.pretrain_encoder_epochs > 0,
                      "DBN encoders and their pre-training"),
                     (train.image_summaries, "image summaries"),
                     (train.fault_inject_step > 0, "fault injection"),
                     (cfg.model.matmul_dtype in ("bf16", "bfloat16"),
                      "the bf16 matmul policy (matmul_dtype)")):
        if on:
            raise NotImplementedError(f"{what}: {_LATER}")


def _host(v: torch.Tensor):
    a = v.detach().cpu().numpy()
    return float(a) if a.ndim == 0 else a


class Trainer:
    """Trains ``params`` (the port's MultINNParams; their tensors' device is
    the training device) on ``dataset``, duck-typed on the JAX ``Dataset``:
    ``batches(split, epoch=, shuffle=, drop_remainder=, with_masks=,
    augment=)`` yields uint8 (B, T, K, D) arrays, plus (B, T) masks with
    ``with_masks``; ``n_batches(split)`` counts the training batches.
    Without ``params`` the model is initialised on ``device`` (the CUDA
    card when None, which raises without one) from a torch.Generator
    seeded with the init key's words (the port has no
    jax.random.normal)."""

    def __init__(self, cfg, dataset, params=None, device=None):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.dataset = dataset
        self.device = (entry_device(device) if params is None
                       else params.decoder.w.device)
        self.rng = sampling.PRNGKey(cfg.train.seed, device=self.device)
        self.rng, init_key = sampling.split(self.rng)
        if params is None:
            words = sampling.key_to_seeds(init_key).tolist()
            params = multinn.init(cfg.model, torch.Generator().manual_seed(
                (words[0] & 0xFFFFFFFF) << 32 | words[1] & 0xFFFFFFFF),
                device=self.device)
        self.params = multinn.tree_map(
            lambda t: t.detach().clone().requires_grad_(True), params)
        self._leaves = multinn.tree_leaves(self.params)
        self.optimizer = make_optimizer(
            cfg.train, steps_per_epoch=dataset.n_batches("train"))
        self.opt_state = self.optimizer.init(self._leaves)
        self.step = 0
        self.epoch = 0
        self.history: list = []          # (step, metrics) of logged steps

    # -- steps ---------------------------------------------------------------

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type == "cuda":    # pinned: the copy does not block
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t.to(torch.float32)

    def train_step(self, x: torch.Tensor, key: torch.Tensor,
                   detailed: bool = False) -> Dict[str, torch.Tensor]:
        """One optimizer step on the float batch x (B, T, K, D): the loss,
        its gradients, the clipped update. Returns the metrics as device
        tensors (the detailed form adds the monitoring metrics), with
        ``grad_norm``, the gradients' norm before the clip."""
        loss, metrics = multinn.loss(self.params, key, x, detailed=detailed)
        grads = torch.autograd.grad(loss, self._leaves)
        metrics["grad_norm"] = self.optimizer.update(self._leaves, grads,
                                                     self.opt_state)
        return metrics

    def _post_step(self, metrics, timing, n_steps: int) -> Dict[str, Any]:
        """Advance the step count; on log boundaries (the only host
        synchronisation of the loop) fetch the metrics and record them."""
        every = self.cfg.train.log_every_steps
        prev = self.step
        self.step += n_steps
        if prev // every == self.step // every:
            return {}
        out = {k: _host(v) for k, v in metrics.items()}
        now = time.perf_counter()
        out["steps_per_sec"] = (self.step - timing[0]) / max(now - timing[1],
                                                            1e-9)
        timing[0], timing[1] = self.step, now
        self.history.append((self.step, out))
        return out

    def train_epoch(self) -> Dict[str, Any]:
        """One pass over the train split (augmented, in the dataset's order
        for this epoch), then the epoch advances. Returns the metrics of the
        last logged step. Logging steps run the detailed step."""
        cfg = self.cfg.train
        spc = max(cfg.steps_per_call, 1)
        timing = [self.step, time.perf_counter()]
        last: Dict[str, Any] = {}

        def run_single(batch):
            self.rng, key = sampling.split(self.rng)
            detailed = (self.step + 1) % cfg.log_every_steps == 0
            return self._post_step(
                self.train_step(self._to_device(batch), key, detailed),
                timing, 1)

        def run_group(batches):
            self.rng, key = sampling.split(self.rng)
            xs = self._to_device(np.stack(batches))
            keys = sampling.split(key, len(batches))
            losses = []
            for i in range(len(batches)):
                metrics = self.train_step(xs[i], keys[i],
                                          detailed=i == len(batches) - 1)
                losses.append(metrics["loss"])
            metrics["loss_mean"] = torch.stack(losses).mean()
            return self._post_step(metrics, timing, len(batches))

        pending: list = []
        for batch in self.dataset.batches("train", epoch=self.epoch,
                                          augment=True):
            if spc == 1:
                last = run_single(batch) or last
                continue
            pending.append(batch)
            if len(pending) == spc:
                last = run_group(pending) or last
                pending = []
        for batch in pending:                 # leftover < spc: single steps
            last = run_single(batch) or last
        self.epoch += 1
        return last

    @torch.no_grad()
    def _eval_step(self, x, key, mask) -> Dict[str, torch.Tensor]:
        """Frame-weighted metric sums of one batch, and ``n_frames``."""
        k_loss, k_ll = sampling.split(key)
        _, metrics = multinn.loss(self.params, k_loss, x, frame_mask=mask)
        ll = multinn.log_likelihood(self.params, k_ll, x, frame_mask=mask)
        n_frames = mask.sum()
        metrics["ll_per_frame"] = ll.sum() / (
            torch.clamp(n_frames, min=1.0) * self.cfg.model.n_tracks)
        weighted = {name: v * n_frames for name, v in metrics.items()}
        weighted["n_frames"] = n_frames
        return weighted

    def evaluate(self, split: str = "valid") -> Dict[str, float]:
        """Frame-weighted metrics over the split: per-batch sums divided by
        the total count of real frames, the short tail batch included at
        its own size. Per-track vectors come out as ``<name>_<k>``."""
        sums: Dict[str, np.ndarray] = {}
        n_total = 0.0
        key = sampling.PRNGKey(self.cfg.train.seed + 1000 + self.epoch,
                               device=self.device)
        for batch, mask in self.dataset.batches(split, shuffle=False,
                                                drop_remainder=False,
                                                with_masks=True):
            key, k = sampling.split(key)
            m = self._eval_step(self._to_device(batch), k,
                                self._to_device(mask))
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

    # -- not ported yet --------------------------------------------------------

    def train(self):
        raise NotImplementedError(
            f"Trainer.train() saves a checkpoint every epoch; checkpoints are "
            f"{_LATER}. Loop train_epoch() and evaluate() instead.")

    def save_checkpoint(self, metrics=None):
        raise NotImplementedError(f"checkpoints are {_LATER}")

    def restore(self, step=None):
        raise NotImplementedError(f"checkpoints are {_LATER}")

    def maybe_resume(self):
        raise NotImplementedError(f"checkpoints are {_LATER}")

    def pretrain_encoders(self):
        raise NotImplementedError(f"DBN pre-training is {_LATER}")
