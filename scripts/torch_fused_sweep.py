#!/usr/bin/env python3
"""Time multinn_torch's two whole-generation kernels over a batch sweep on
one NVIDIA GPU, for the package found under ``--root``:

    python3 scripts/torch_fused_sweep.py [--root DIR] [--batches 1,8,64,256]
                                         [--steps 1024] [--reps 3]
                                         [--variants]

``--root`` is a checkout of the repository (default: this one), so one
call on the card can time two versions of the kernels in turns (unpack the
other commit with ``git archive`` into a git-ignored directory and pass it
as the root). Each family runs the flagship config (K=5, D=84, H=150,
U=100, feedback, one LSTM layer; RBM gen_k=10) with params from
``multinn.init`` and a torch.Generator seeded with 0, from a fresh state,
under the same key.

``--variants`` also splits the step: at the first batch it times variants
of the flagship that drop or shrink one part — the RBM at gen_k = 1 and 0
(the Gibbs sweeps' share), per-track mode (no feedback context), and the
visible bias lowered by 4 (frame density about 0.02: the sparse gathers'
share); the NADE per-track and with the lowered bias.

Prints one JSON line: the card's name and power limit, and per family and
batch (and per variant) the kernel's mean ms per launch (CUDA events, one
warm launch, then ``--reps``), us per step, the per-track note density of
the roll, and the root. Exits non-zero without a CUDA device.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

# name: (family, mode, gen_k, shift of the visible bias)
FLAGSHIPS = {"rnn-rbm": ("rnn-rbm", "feedback", 10, 0.0),
             "rnn-nade": ("rnn-nade", "feedback", 10, 0.0)}
VARIANTS = {"rbm gen_k=1": ("rnn-rbm", "feedback", 1, 0.0),
            "rbm gen_k=0": ("rnn-rbm", "feedback", 0, 0.0),
            "rbm per-track": ("rnn-rbm", "per-track", 10, 0.0),
            "rbm per-track gen_k=0": ("rnn-rbm", "per-track", 0, 0.0),
            "rbm bv-4": ("rnn-rbm", "feedback", 10, -4.0),
            "nade per-track": ("rnn-nade", "per-track", 10, 0.0),
            "nade bv-4": ("rnn-nade", "feedback", 10, -4.0)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--batches", default="1,8,64,256")
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_fused_sweep: needs a CUDA device")
    from multinn_torch.models import multinn
    from multinn_torch.ops import sampling

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    key = sampling.PRNGKey(5, device=dev)
    batches = [int(b) for b in args.batches.split(",")]

    def params_of(family, mode, gen_k, bv_shift):
        cfg = multinn.MultINNConfig(
            n_tracks=5, n_pitches=84, mode=mode, decoder_type=family,
            n_hidden=150, n_rnn=100, cd_k=1, gen_k=gen_k)
        params = multinn.tree_map(lambda x: x.to(dev), multinn.init(
            cfg, torch.Generator().manual_seed(0)))
        if bv_shift:
            params = dataclasses.replace(params, decoder=dataclasses.replace(
                params.decoder, bv=params.decoder.bv + bv_shift))
        return params

    def timed(params, batch):
        """One warm launch, then the mean of ``--reps`` by CUDA events."""
        state = multinn.init_state(params, batch)

        def run():
            return multinn._generate_fused(params, key, state, args.steps,
                                           impl="cuda")[1]

        roll = run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            run()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / args.reps
        return {"batch": batch, "ms": ms,
                "us_per_step": ms * 1e3 / args.steps,
                "density": [round(float(x), 5) for x in
                            roll.mean(dim=(0, 1, 3))]}

    out = {"root": args.root, "card": smi, "steps": args.steps,
           "reps": args.reps, "families": {}}
    for name, spec in FLAGSHIPS.items():
        params = params_of(*spec)
        out["families"][name] = [timed(params, b) for b in batches]
    if args.variants:
        out["variants"] = {name: timed(params_of(*spec), batches[0])
                           for name, spec in VARIANTS.items()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
