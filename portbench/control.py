"""The output check's control and planted faults, run at a cell's own
size: each makes the measured program compute something else than the
configuration states, and the check has to come out not correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3
                                 --seconds <s> --what <control|fault>

``control``: the program one precision below the configuration's. A
serving cell hands the program every weight rounded one step below the
precision it is stored in: float32 ones to bfloat16, and the ones the
RNN-NADE kernel stores in bfloat16 (W, V, Wuv, Wx) to float8 e4m3 with a
power-of-two scale per tensor. A training cell runs the program's own
bf16 matmul policy (``model.matmul_dtype``). The reference is untouched.

Faults, planted in the program (in every rank a cell spawns):
``token_altered`` flips one cell of every generated song where the roll
is produced; ``state_unchanged`` makes every optimizer step leave the
parameters and Adam's state as they were; ``half_batch`` computes the
loss over the first half of every batch; ``no_exchange`` leaves out the
exchange between chips, each rank keeping its own gradients and
metrics.

Prints one JSON line per seed with the numbers compared and ``correct``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
from unittest import mock

from portbench import run as run_mod
from portbench import spec

FAULTS = ("token_altered", "state_unchanged", "half_batch", "no_exchange")


def _fp8(x):
    import torch
    amax = float(x.abs().max())
    if amax == 0.0:
        return x.clone()
    scale = 2.0 ** math.ceil(math.log2(amax / 448.0))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def lower_precision(wts: dict, decoder: str) -> dict:
    """The weights one storage precision below the configuration's."""
    import torch
    bf16_stored = ("w", "v", "wuv", "wx") if decoder == "rnn-nade" else ()
    return {n: (_fp8(x) if n in bf16_stored
                else x.to(torch.bfloat16).to(torch.float32))
            for n, x in wts.items()}


def prepare_control(ctx) -> None:
    if ctx.mix["kind"] == "train_groups":
        ctx.cfg = dict(ctx.cfg, model=dict(ctx.cfg["model"],
                                           matmul_dtype="bf16"))
    else:
        decoder = ctx.cfg["model"]["decoder_type"]
        ctx.program_weights = lambda wts: lower_precision(wts, decoder)


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` in place, for the block."""
    from multinn_torch.models import multinn
    from multinn_torch.training import trainer as trainer_mod
    if fault == "token_altered":
        generate = multinn.generate

        def altered(*args, **kwargs):
            state, roll = generate(*args, **kwargs)
            roll = roll.clone()
            t, d = roll.shape[1] // 2, roll.shape[3] // 2
            roll[:, t, 0, d] = 1.0 - roll[:, t, 0, d]
            return state, roll
        with mock.patch.object(multinn, "generate", altered):
            yield
    elif fault == "state_unchanged":
        def frozen(self, params, grads, state, sq_sum=None):
            import torch
            return torch.stack(torch._foreach_norm(list(grads))).square(
            ).sum().sqrt()
        with mock.patch.object(trainer_mod.Optimizer, "update", frozen):
            yield
    elif fault == "half_batch":
        loss = multinn.loss

        def half(params, key, x, *args, **kwargs):
            return loss(params, key, x[:x.shape[0] // 2], *args, **kwargs)
        with mock.patch.object(multinn, "loss", half):
            yield
    elif fault == "no_exchange":
        from multinn_torch.parallel import mesh as mesh_mod
        with mock.patch.object(mesh_mod.Reduce, "mean",
                               lambda self, tensors, sums=(): list(tensors)):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")


def run(workload: str, seed: int, seconds: float, what: str,
        device: str = "cuda", root=spec.ROOT) -> dict:
    import time
    if what == "control":
        line = run_mod.run_cell(workload, seed, seconds, False, device,
                                t0=time.perf_counter(), root=root,
                                prepare=prepare_control)
    else:
        with planted(what):
            line = run_mod.run_cell(
                workload, seed, seconds, False, device,
                t0=time.perf_counter(), root=root,
                prepare=lambda ctx: setattr(ctx, "fault", what))
    return {"workload": workload, "seed": seed, "what": what,
            "correct": line["correct"],
            "checks": {k: c["value"] for k, c in line["checks"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--what", default="control",
                   choices=("control",) + FAULTS)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(run(args.workload, seed, args.seconds, args.what)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
