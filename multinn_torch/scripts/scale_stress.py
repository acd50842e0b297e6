"""Scale stress — the port's counterpart of ``scripts/scale_stress.py``:
train the flagship architecture (5 tracks of 84 pitches, feedback, RNN-RBM,
CD-1) far past the reference's widths (H=150, U=100) on the card and
record step time, throughput and MFU. The reference's widths never fill
the card's matmul units, so this is where the single-card compute story is
tested.

    python -m multinn_torch.scripts.scale_stress [--h 1024] [--u 512] \\
        [--batch 256] [--t 64] [--iters 10] [--dtype f32|bf16] \\
        [--device cuda]

One group of ``--iters`` steps (``steps_per_call``) runs through the
port's ``Trainer`` as one CUDA graph: the first call warms up and captures
it, then replays of the graph are timed by CUDA events. Prints one JSON
line. Its keys and why each is there:

  * ``step_ms`` — the best replay's time over ``iters``: one optimizer step
    with no host time between launches;
  * ``frames_per_sec_per_chip`` — B*T frames over that step;
  * ``model_gflops_per_step`` — ``utils/flops.train_step_flops``, the
    MODEL count the JAX package also reports;
  * ``mfu`` against ``peak`` — the H100 peak of the precision that ran
    (``utils/flops.peak_for``: bf16 feeds under ``--dtype bf16``, else
    f32, or TF32 where PyTorch's matmuls may use it);
  * ``gibbs_plan`` — the launch plan ``gibbs_cuda.launch_plan`` picks for
    the CD chain's N = B*T rows per track at (D=84, H): at H=1024, W
    (344 KB) exceeds a CTA's shared memory, so the chain reads W from
    device memory ("plain" on the CPU, where the chain runs its plain
    version);
  * ``capture_s`` — seconds of the first call: the warm-up steps, the
    capture and one replay (on the CPU: one eager group);
  * ``launches_per_step`` — kernel launches per replayed step, from the
    captured graph's record;
  * ``loss_finite`` — the last step's loss is finite;
  * ``device`` — the card's name (or ``cpu``), so no CPU time reads as the
    card's.

On the CPU (``--device cpu``, the tests) the group runs eagerly and is
timed by ``perf_counter``: its numbers say nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np


class _OneBatch:
    """``n`` copies of one batch behind the Dataset interface the Trainer
    reads at construction (the optimizer's steps per epoch)."""

    def __init__(self, n: int):
        self.n = n

    def n_batches(self, split: str = "train") -> int:
        return self.n


def measure(n_hidden: int, n_rnn: int, batch: int, t_window: int,
            n_iter: int = 10, mode: str = "feedback", dtype: str = "f32",
            device: str = "cuda") -> dict:
    import torch

    from multinn_torch.models import multinn
    from multinn_torch.models.multinn import MultINNConfig
    from multinn_torch.ops import _build, gibbs_cuda, sampling
    from multinn_torch.training.trainer import Trainer
    from multinn_torch.utils import flops as flops_mod
    from multinn_torch.utils.config import ExperimentConfig, TrainConfig
    from multinn_torch.utils.device import entry_device
    from multinn_torch.utils.profiling import cuda_ms, force

    dev = entry_device(device)
    run_dir = tempfile.mkdtemp(prefix="scale_stress_")
    try:
        cfg = ExperimentConfig(
            model=MultINNConfig(n_tracks=5, n_pitches=84, mode=mode,
                                decoder_type="rnn-rbm", n_hidden=n_hidden,
                                n_rnn=n_rnn, cd_k=1, gen_k=10,
                                matmul_dtype=dtype),
            train=TrainConfig(steps_per_call=n_iter, log_every_steps=10 ** 9,
                              ckpt_every_steps=0, run_dir=run_dir))
        trainer = Trainer(cfg, _OneBatch(n_iter), device=dev)
        x = (np.random.default_rng(1).random(
            (batch, t_window, cfg.model.n_tracks, cfg.model.n_pitches))
            < 0.06).astype(np.uint8)
        xs = np.stack([x] * n_iter)
        key = sampling.PRNGKey(2, device=dev)

        t0 = time.perf_counter()
        out = trainer.run_group(xs, key)
        force(out)
        capture_s = time.perf_counter() - t0
        if trainer.group_graph is not None:
            # the batch and key stay in the graph's static buffers: time
            # bare replays, as the JAX script re-runs one program
            replay = trainer.group_graph.graph.replay
            times = [cuda_ms(replay, 1, warm=False) / 1e3 for _ in range(3)]
            launches = {k: v / n_iter
                        for k, v in trainer.group_graph.launches.items()}
            plan = list(gibbs_cuda.launch_plan(
                batch * t_window, _build.sm_count(key), cfg.model.n_pitches,
                n_hidden))
        else:
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = trainer.run_group(xs, key)
                force(out)
                times.append(time.perf_counter() - t0)
            launches, plan = {}, "plain"
        loss = float(out["loss"])     # a replay rewrites the graph's outputs
        trainer.close()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    step_s = min(times) / n_iter
    frames = batch * t_window
    fl = flops_mod.train_step_flops(cfg.model, batch, t_window)
    peak = flops_mod.peak_for(dtype, torch.backends.cuda.matmul.allow_tf32)
    return {
        "config": {"H": n_hidden, "U": n_rnn, "B": batch, "T": t_window,
                   "K": 5, "D": 84, "mode": mode, "cd_k": 1,
                   "matmul_dtype": dtype},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "step_ms": round(step_s * 1e3, 3),
        "frames_per_sec_per_chip": round(frames / step_s, 0),
        "model_gflops_per_step": round(fl / 1e9, 1),
        "mfu": round(flops_mod.mfu(fl, step_s, peak), 4),
        "peak": peak.name,
        "gibbs_plan": plan,
        "capture_s": round(capture_s, 2),
        "launches_per_step": launches,
        "loss_finite": bool(np.isfinite(loss)),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--h", type=int, default=1024)
    p.add_argument("--u", type=int, default=512)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--t", type=int, default=64)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                   help="matmul-feed precision (ops/precision.py)")
    p.add_argument("--device", default="cuda",
                   help="the training device (default cuda; cpu for tests)")
    args = p.parse_args(argv)
    res = measure(args.h, args.u, args.batch, args.t, n_iter=args.iters,
                  dtype=args.dtype, device=args.device)
    print(json.dumps(res))
    return 0 if res["loss_finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
