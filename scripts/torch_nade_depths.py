#!/usr/bin/env python3
"""Time the speculative depths of multinn_torch's whole-generation NADE
kernel (csrc/gen_fused_nade.cu) on one NVIDIA GPU, and where the step's
time goes:

    python3 scripts/torch_nade_depths.py [--batches 1,8,22,23,64,256]
                                         [--steps 1024] [--reps 2]
                                         [--cycles]

For the NADE flagship (K=5, D=84, H=150, U=100, feedback) and its joint
form (one track of 420 pitches) with params from ``multinn.init`` (w_std
0.1, the visible bias shifted by a ramp from -3 to 1 over the pitches, a
torch.Generator seeded with 0) and a state primed on a seeded random
roll: the kernel at depths 1, 2 and 4, whose rolls, h and c must be
bit-identical (the script exits non-zero otherwise), ms per song at each
depth (CUDA events, one warm launch, then ``--reps``) and the auto
depth the kernel's launcher picks (``gen_fused_nade.auto_depth``). On an
H100 the flagship's launches hold one sample a cluster up to B=22 and
two from B=23: the default batches straddle the auto rule's flip.

``--cycles`` builds a copy of ``csrc/`` under
``multinn_torch/_build/timed`` with ``clock64()`` around the kernel's
phases (the biases, the sweep, the frame's emission, the whole step; the
rest of a step is the cell stack and the frame exchange) and prints, per
model, batch and depth, the mean cycles a step of CTA 0 over ``--steps``
steps. The package's own build is untouched. The timed kernel also
prints a CYCLES line for each launch outside the measurement.

Prints one JSON line last: the card's name and power limit and the rows.
Exits non-zero without a CUDA device.
"""

import argparse
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NADE = dict(n_tracks=5, n_pitches=84, mode="feedback",
            decoder_type="rnn-nade", n_hidden=150, n_rnn=100, w_std=0.1)

# (anchor in gen_fused_nade.cu, the same text with the timers added)
_TIMERS = [
    ("#include <cuda_runtime.h>",
     "#include <cuda_runtime.h>\n#include <cstdio>"),
    ("  for (int t = 0; t < T; ++t) {\n    const int buf = t & 1;",
     "  long long cy[4] = {0, 0, 0, 0};\n"
     "  for (int t = 0; t < T; ++t) {\n    const long long c0 = clock64();\n"
     "    const int buf = t & 1;"),
    ("    __syncthreads();\n\n    // 2. the sweep:",
     "    __syncthreads();\n    const long long c1 = clock64();\n\n"
     "    // 2. the sweep:"),
    ("    __syncthreads();\n\n    // 3. given merge",
     "    __syncthreads();\n    const long long c2 = clock64();\n\n"
     "    // 3. given merge"),
    ("    gen_cluster::cell_stack<kLstm, true>(ct, cw, buf);\n"
     "    gen_cluster::gather_frames(ct, buf);\n  }",
     "    const long long c3 = clock64();\n"
     "    gen_cluster::cell_stack<kLstm, true>(ct, cw, buf);\n"
     "    gen_cluster::gather_frames(ct, buf);\n"
     "    cy[0] += c1 - c0; cy[1] += c2 - c1; cy[2] += c3 - c2;\n"
     "    cy[3] += clock64() - c0;\n  }\n"
     "  if (threadIdx.x == 0 && blockIdx.x == 0)\n"
     "    printf(\"CYCLES %d %lld %lld %lld %lld\\n\", kSpec, cy[0] / T, "
     "cy[1] / T, cy[2] / T, cy[3] / T);"),
]


def _timed_build(build):
    """Build and load a copy of csrc/ with the timers, under the build
    directory (needs nvcc)."""
    base = build.BUILD_ROOT / "timed"
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(build.CSRC, base / "csrc")
    cu = base / "csrc" / "gen_fused_nade.cu"
    text = cu.read_text()
    for anchor, timed in _TIMERS:
        if text.count(anchor) != 1:
            sys.exit(f"torch_nade_depths: the kernel no longer has {anchor!r}")
        text = text.replace(anchor, timed)
    cu.write_text(text)
    build.CSRC = base / "csrc"
    build._nvcc_build(base / "lib")
    import torch
    torch.ops.load_library(str(base / "lib" / build._LIB))
    build._loaded = True


def _cycles(run):
    """Launch ``run`` with the process's stdout, where the timed kernel's
    printf lands, sent to a file; return the last launch's cycles."""
    import os
    import torch
    with tempfile.TemporaryFile(mode="w+") as f:
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(f.fileno(), 1)
        try:
            run()
            torch.cuda.synchronize()
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        found = re.findall(r"CYCLES (\d+) (\d+) (\d+) (\d+) (\d+)", f.read())
    _, bias, sweep, emit, step = (int(x) for x in found[-1])
    return dict(bias=bias, sweep=sweep, emit=emit, step=step)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1,8,22,23,64,256")
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cycles", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_nade_depths: needs a CUDA device")
    from multinn_torch.models import multinn
    from multinn_torch.ops import _build, gen_fused_nade, sampling
    from multinn_torch.utils.profiling import cuda_ms

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if args.cycles:
        _timed_build(_build)
    g = torch.Generator().manual_seed(0)
    batches = [int(b) for b in args.batches.split(",")]
    rows = []
    for name, model, bs in (("flagship", NADE, batches),
                            ("joint", dict(NADE, mode="joint"),
                             [b for b in batches if b <= 8])):
        params = multinn.init(multinn.MultINNConfig(**model), g, device=dev)
        ramp = torch.linspace(-3.0, 1.0, 84, device=dev)
        params = dataclasses.replace(params, decoder=dataclasses.replace(
            params.decoder, bv=params.decoder.bv + ramp.repeat(
                params.decoder.bv.shape[-1] // 84)))
        key = sampling.PRNGKey(8, device=dev)
        for b in bs:
            seed = (torch.rand(b, 16, 5, 84, generator=g) < 0.1).float()
            st = multinn.prime(params, multinn.init_state(params, b),
                               seed.to(dev))
            state = (torch.stack([c.h for c in st.decoder.cell]),
                     torch.stack([c.c for c in st.decoder.cell]),
                     st.decoder.v_prev)

            def run(spec, n=args.steps):
                return gen_fused_nade.generate_nade(
                    key, params.decoder, *state, n, spec=spec)

            ref = run(1)
            for spec in (2, 4):
                if not all(torch.equal(x, y) for x, y in zip(run(spec), ref)):
                    sys.exit(f"torch_nade_depths: {name} B={b} depth {spec} "
                             f"differs from depth 1")
            row = dict(model=name, batch=b, density=float(ref[0].mean()),
                       auto=gen_fused_nade.auto_depth(params.decoder, b))
            for spec in (1, 2, 4):
                if args.cycles:
                    row[f"cycles_{spec}"] = _cycles(lambda: run(spec))
                else:
                    row[f"ms_{spec}"] = cuda_ms(lambda: run(spec), args.reps)
            rows.append(row)
            del ref
    print(json.dumps(dict(device=smi, steps=args.steps, rows=rows)))


if __name__ == "__main__":
    main()
