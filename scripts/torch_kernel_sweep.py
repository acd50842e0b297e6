#!/usr/bin/env python3
"""Time multinn_torch's Gibbs chain, NADE likelihood kernels and NADE
sampler on one NVIDIA GPU, for the package found under ``--root``:

    python3 scripts/torch_kernel_sweep.py [--root DIR] [--reps 20] [--plans]

``--root`` is a checkout of the repository (default: this one), so one
call on the card can time two versions in turns: unpack the other commit
with ``git archive`` into a git-ignored directory and pass it as the root.

Shapes (D=84, H=150, inputs from a torch.Generator seeded with 0, as
``chip_smoke.py`` makes them):
  * ``gibbs_chain`` at 8 rows, k=10 (the scan path), 1024 rows, k=1 (CD-1
    training) and 4096 rows, k=25 (the flagship's sweeps/s workload);
  * ``nade_ll_bwd`` at K=5, N=4096 without and with dx and ``nade_ll_fwd``
    (the NADE training shape, x at density 0.06);
  * ``nade_sample`` for 8 rows (the scan path's batch of one track) at two
    densities: bv about -1 (``chip_smoke.py`` phase 7's inputs, about 0.27
    of the dims drawn 1) and about -3 (near music's 0.06), with the density
    drawn and the device microseconds per dim.

Each is timed two ways after a warm call: ``ms``, CUDA events around
``--reps`` back-to-back calls of the wrapper (what a caller's stream sees,
host overhead included when the host is slower than the kernel), and
``kernel_ms``, the same calls captured in one CUDA graph and its replay
timed by CUDA events (device time: the kernel, the backward's second pass
and the wrapper's small PyTorch kernels, no host time). The Gibbs rows add
sweeps/s (rows x k per second of ``kernel_ms``).

``--plans`` (trees whose ``gibbs_cuda`` has ``launch_plan``) also times
every Gibbs launch plan at N in {132, 264, 528, 792, 1056} and k in {1, 10}:
the crossover that ``launch_plan`` encodes.

Prints one JSON line holding the card's name and power limit. Exits
non-zero without a CUDA device.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

GIBBS_SHAPES = ((8, 10), (1024, 1), (4096, 25))
PLAN_ROWS = (132, 264, 528, 792, 1056)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_sweep: needs a CUDA device")
    from multinn_torch.ops import (_build, gibbs_cuda, nade_cuda, nade_ll,
                                   sampling)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    g = torch.Generator().manual_seed(0)
    _build.ops()

    def timed(fn):
        """(ms per call by CUDA events, device ms per call by a CUDA graph
        replay)."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / args.reps
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(args.reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return ms, start.elapsed_time(end) / args.reps

    def gibbs_inputs(n, d=84, h=150):
        v0 = (torch.rand(n, d, generator=g) < 0.2).float().to(dev)
        w = (0.1 * torch.randn(d, h, generator=g)).to(dev)
        bv = (-1.0 + 0.5 * torch.randn(n, d, generator=g)).to(dev)
        bh = (0.5 * torch.randn(n, h, generator=g)).to(dev)
        return v0, w, bv, bh

    key = sampling.PRNGKey(1, device=dev)
    out = {"root": args.root, "card": smi, "reps": args.reps, "gibbs": [],
           "nade_ll": {}}
    for n, k in GIBBS_SHAPES:
        a = gibbs_inputs(n)
        ms, kms = timed(lambda: gibbs_cuda.gibbs_chain(key, *a, k))
        out["gibbs"].append(dict(n=n, k=k, ms=ms, kernel_ms=kms,
                                 sweeps_per_s=n * k / kms * 1e3))

    kk, nn, dd, hh = 5, 4096, 84, 150
    x = (torch.rand(kk, nn, dd, generator=g) < 0.06).float().to(dev)
    w, v = (0.1 * torch.randn(kk, dd, hh, generator=g).to(dev)
            for _ in range(2))
    bv = (-1.0 + 0.5 * torch.randn(kk, nn, dd, generator=g)).to(dev)
    bh = (0.5 * torch.randn(kk, nn, hh, generator=g)).to(dev)
    cot = torch.randn(kk, nn, dd, generator=g).to(dev)
    _, a_end = nade_ll.nade_ll_fwd(x, w, v, bv, bh)
    for name, fn in (
            ("bwd", lambda: nade_ll.nade_ll_bwd(x, w, v, cot, a_end,
                                                want_dx=False)),
            ("bwd_dx", lambda: nade_ll.nade_ll_bwd(x, w, v, cot, a_end)),
            ("fwd", lambda: nade_ll.nade_ll_fwd(x, w, v, bv, bh))):
        ms, kms = timed(fn)
        out["nade_ll"][name] = dict(ms=ms, kernel_ms=kms)

    out["nade_sample"] = []
    skey = sampling.PRNGKey(3, device=dev)
    for bias in (-1.0, -3.0):
        w, v = (0.1 * torch.randn(dd, hh, generator=g).to(dev)
                for _ in range(2))
        bv = (bias + 0.5 * torch.randn(8, dd, generator=g)).to(dev)
        bh = (0.5 * torch.randn(8, hh, generator=g)).to(dev)
        density = float(nade_cuda.nade_sample(skey, w, v, bv, bh,
                                              (8,)).mean())
        ms, kms = timed(lambda: nade_cuda.nade_sample(skey, w, v, bv, bh,
                                                      (8,)))
        out["nade_sample"].append(dict(bias=bias, density=density, ms=ms,
                                       kernel_ms=kms,
                                       us_per_dim=kms * 1e3 / dd))

    if args.plans and hasattr(gibbs_cuda, "launch_plan"):
        four = len(gibbs_cuda.LATENCY_PLAN) == 4   # W placement in the plan
        plans = [gibbs_cuda.LATENCY_PLAN] + [
            (r, 256, 1) + ((1,) if four else ()) for r in (8, 16)]
        out["plans"] = []
        for n in PLAN_ROWS:
            a = gibbs_inputs(n)
            for k in (1, 10):
                dims = (84, 150) if four else ()
                row = dict(n=n, k=k, chosen=list(gibbs_cuda.launch_plan(
                    n, _build.sm_count(a[0]), *dims)))
                for plan in plans:
                    row[str(plan)] = timed(
                        lambda: gibbs_cuda._launch(key, *a, k, plan))[1]
                out["plans"].append(row)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
