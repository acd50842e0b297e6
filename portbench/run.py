"""Run one cell of the benchmark of ``multinn_torch`` once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Sets the cell up (kernels loaded or built, weights and inputs drawn on
the card from ``--seed``, every shape warmed up), measures for
``--seconds`` seconds, checks what the measured path produced against the
plain reference (``portbench/reference``), and prints one JSON object as
the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each number the output check compared beside its
limit; the same numbers are the last lines of standard error.

Runs only on the card: without CUDA, or with fewer cards than the cell
asks for, it prints no result and exits with 2. It exits with 3 and
prints no result when anything of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "multinn_tpu")


class Context:
    """What a traffic kind's ``run`` gets: the cell, the run's seeds and
    settings, the tracer, and two hooks of the output check's control:
    ``program_weights``, through which it hands the program other weights
    than the reference's (the identity in a benchmark run), and
    ``fault``, the fault planted in ranks the kind spawns (None)."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device: str, t0: float, root=spec.ROOT, workdir=None):
        from portbench import trace as trace_mod
        from portbench.weights import Seeds
        self.cell = cell
        self.cfg = cell["cfg"]
        self.mix = cell["mix"]
        self.root = root
        self.seed = seed
        self.seeds = Seeds(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t0 = t0
        if workdir is None:
            workdir = spec.scratch_dir()
        os.makedirs(workdir, exist_ok=True)
        self.workdir = workdir
        self.tracer = trace_mod.Tracer(self.trace, self.workdir)
        self.program_weights = lambda wts: wts
        self.fault = None            # a planted fault, for spawned ranks
        self.marks = []

    def mark(self, what: str) -> None:
        """Note how far into the run a stage of the set-up ended."""
        self.marks.append((f"set-up: {what} at "
                           f"{time.perf_counter() - self.t0:.3f} s"))

    def note(self, text: str) -> None:
        """A line for standard error, printed before the checks."""
        self.marks.append(text)

    def experiment_config(self):
        """The program's config of this cell's configuration file."""
        from multinn_torch.models.multinn import MultINNConfig
        from multinn_torch.utils.config import (DataConfig, ExperimentConfig,
                                                GenerateConfig, TrainConfig)
        c = self.cfg
        model = dict(c["model"])
        model["encoder_hidden"] = tuple(model.get("encoder_hidden", ()))
        lo, hi = c["pitches"]
        train = c["train"]
        return ExperimentConfig(
            name=c["name"],
            data=DataConfig(dataset="synthetic", source="synthetic",
                            n_tracks=model["n_tracks"], pitch_min=lo,
                            pitch_max=hi, window=train["window"],
                            batch_size=train["batch_size"]),
            model=MultINNConfig(**model),
            train=TrainConfig(optimizer=train["optimizer"], lr=train["lr"],
                              grad_clip=train["grad_clip"],
                              steps_per_call=train["steps_per_call"],
                              seed=self.seeds.program,
                              log_every_steps=2 ** 30, ckpt_every_steps=0,
                              run_dir=os.path.join(self.workdir, "run")),
            generate=GenerateConfig(n_steps=c["generate"]["n_steps"]))

    def close(self) -> None:
        self.tracer.close()


def device_info(device: str, chips: int) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        info["power_limit"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "not read"
    return info


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = None, root=spec.ROOT,
             prepare=None) -> dict:
    """One run of the cell ``name``; returns the result line's object.
    ``prepare(ctx)``, where given, adjusts the context first (the tests
    and the output check's control use it)."""
    import torch
    cell = spec.cell(name, root)
    ctx = Context(cell, seed, seconds, trace, device,
                  _T0 if t0 is None else t0, root)
    if prepare is not None:
        prepare(ctx)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = spec.traffic_kind(cell["mix"]["kind"], root).run(ctx)
    finally:
        ctx.close()
    e2e, per_layer = spec.metrics_of(name, root)
    unit = spec.units(root)
    if trace:
        rec = dict(out["records"], trace=ctx.tracer.result)
        values = {}
        for m in per_layer:
            v = spec.metric_reader(m, root).read(rec)
            if v is not None:
                values[m] = float(v)
    else:
        values = {m: float(out["e2e"][m]) for m in e2e}
    line = {
        "correct": bool(out["correct"]),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": {m: {"value": v, "unit": unit[m]}
                    for m, v in values.items()},
        "device": dict(device_info(device, cell["chips"]),
                       memory_peak_bytes=int(out["memory_peak_bytes"])),
    }
    if trace:
        line["device"]["busy_s"] = ctx.tracer.result["busy_s"]
        line["device"]["window_s"] = ctx.tracer.result["window_s"]
        line["breakdown"] = ctx.tracer.result["breakdown"]
    line["checks"] = {k: {"value": float(v), "limit": float(lim)}
                      for k, (v, lim) in out["checks"].items()}
    for text in ctx.marks:
        print(text, file=sys.stderr)
    return line


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
