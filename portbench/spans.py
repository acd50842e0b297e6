"""The program's own spans over one run of a cell: a cell run as
``run.run_cell`` runs it, untraced, with ``multinn_torch``'s span recorder
(``utils/profiling``) on or off, and the spans reduced to the numbers a
layer of the service or the trainer is judged by.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>
                               --recorder <0|1>

Prints one JSON object as the last line of standard output: the run's
``correct``, ``metrics`` (its end-to-end ones) and, with ``--recorder 1``,
``spans``: the reductions below, and for every span name of the batches
or groups kept the count and the 50th and 95th percentile of its length
in ms (``lengths``). The recorder
is enabled before the cell's set-up; the serve reductions keep the
batches taken inside the measured window, the train ones leave out the
set-up's first group (the capture). Runs on the card only, one process:
a cell on a mesh spawns ranks this process cannot enable, and is refused
with exit 2, as is a machine without CUDA.

Serve (per batch, by batch index):
  * ``card_wait_p50_ms``: median of ``serve.dispatch``'s end ->
    ``serve.card``'s start, the batch's wait on the card's stream;
  * ``drain_p95_ms``: 95th percentile of ``serve.card``'s end ->
    ``serve.drain.resolve``'s end;
  * ``late_batch_share``: % of the batches after the first whose
    ``serve.card`` started more than 20 us after the previous one's end;
  * ``card_gaps_ms``: the card's idle time between batches, each gap put
    down to the host span, of any thread, that overlaps it the longest
    (the shortest of equals), as ``thread/span``.
Train (per group, by ``Trainer.groups_run``):
  * ``group_card_ms_p50``: median ``train.card``;
  * ``run_group_host_ms``: median ``train.run_group``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
import time

import numpy as np

LATE_NS = 20_000
NO_SPAN = "no program span"


def _ms(ns) -> float:
    return float(ns) / 1e6


def by_ident(spans, first: str) -> dict:
    """{identifier: {name: span}} of the identifiers that hold a span
    named ``first``; spans of no identifier are left out."""
    out = collections.defaultdict(dict)
    for s in spans:
        if s.ident is not None:
            out[s.ident].setdefault(s.name, s)
    return {i: b for i, b in sorted(out.items()) if first in b}


def lengths(spans) -> dict:
    """{name: {"n", "p50_ms", "p95_ms"}} of every span name."""
    per = collections.defaultdict(list)
    for s in spans:
        per[s.name].append(_ms(s.end_ns - s.start_ns))
    return {n: {"n": len(v), "p50_ms": float(np.percentile(v, 50)),
                "p95_ms": float(np.percentile(v, 95))}
            for n, v in sorted(per.items())}


def card_gaps(spans, cards) -> dict:
    """ms of the card's idle time between the ``cards`` (intervals in
    order on one stream) by the host span that overlaps each gap the
    longest, as ``thread/name``."""
    host = [s for s in spans if s.thread != "card"]
    out = collections.defaultdict(float)
    for a, b in zip(cards, cards[1:]):
        g0, g1 = a.end_ns, b.start_ns
        if g1 <= g0:
            continue
        best, key = NO_SPAN, (0, 0)
        for s in host:
            ov = min(g1, s.end_ns) - max(g0, s.start_ns)
            if ov > 0 and (ov, s.start_ns - s.end_ns) > key:
                best, key = f"{s.thread}/{s.name}", (ov, s.start_ns
                                                       - s.end_ns)
        out[best] += _ms(g1 - g0)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def serve_numbers(spans, window=None) -> dict:
    """The serve reductions (module docstring) over the batches whose
    ``serve.take`` ended inside ``window`` (start, end in ns; all when
    None)."""
    batches = by_ident(spans, "serve.take")
    if window is not None:
        batches = {i: b for i, b in batches.items()
                   if window[0] <= b["serve.take"].end_ns <= window[1]}
    timed = [b for b in batches.values() if "serve.card" in b]
    out = {"batches": len(batches), "timed_batches": len(timed),
           "lengths": lengths(s for b in batches.values()
                              for s in b.values())}
    if not timed:
        return out
    waits = [_ms(b["serve.card"].start_ns - b["serve.dispatch"].end_ns)
             for b in timed if "serve.dispatch" in b]
    drains = [_ms(b["serve.drain.resolve"].end_ns - b["serve.card"].end_ns)
              for b in timed if "serve.drain.resolve" in b]
    cards = [b["serve.card"] for b in timed]
    late = [b.start_ns - a.end_ns > LATE_NS
            for a, b in zip(cards, cards[1:])]
    if waits:
        out["card_wait_p50_ms"] = float(np.median(waits))
    if drains:
        out["drain_p95_ms"] = float(np.percentile(drains, 95))
    if late:
        out["late_batch_share"] = 100.0 * sum(late) / len(late)
    out["card_gaps_ms"] = card_gaps(spans, cards)
    return out


def train_numbers(spans, skip: int = 1) -> dict:
    """The train reductions (module docstring) over the groups from the
    ``skip``-th on."""
    groups = {i: g for i, g in by_ident(spans, "train.run_group").items()
              if i >= skip}
    out = {"groups": len(groups),
           "lengths": lengths(s for g in groups.values()
                              for s in g.values())}
    cards = [_ms(g["train.card"].end_ns - g["train.card"].start_ns)
             for g in groups.values() if "train.card" in g]
    host = [_ms(g["train.run_group"].end_ns - g["train.run_group"].start_ns)
            for g in groups.values()]
    if cards:
        out["group_card_ms_p50"] = float(np.median(cards))
    if host:
        out["run_group_host_ms"] = float(np.median(host))
    return out


class _Bounds:
    """A cell's tracer that also keeps its window's bounds on
    ``time.time_ns()`` (``bounds``); everything else is the tracer's."""

    def __init__(self, tracer):
        self._tracer = tracer
        self.bounds = None

    def __getattr__(self, name):
        return getattr(self._tracer, name)

    @contextlib.contextmanager
    def window(self, sync):
        t0 = time.time_ns()
        try:
            with self._tracer.window(sync):
                yield
        finally:
            self.bounds = (t0, time.time_ns())


def report(name: str, seed: int, seconds: float, recorder: bool,
           device: str = "cuda", root=None) -> dict:
    """One untraced run of the cell ``name`` with the recorder on or off;
    the run's ``correct`` and ``metrics``, and with the recorder its
    ``spans`` (module docstring)."""
    from multinn_torch.utils import profiling

    from portbench import run, spec
    root = spec.ROOT if root is None else root
    cell = spec.cell(name, root)
    if cell.get("mesh"):
        raise ValueError(f"{name} runs on a mesh of spawned ranks, whose "
                         f"recorders this process cannot enable")
    kept = {}

    def prepare(ctx):
        ctx.tracer = kept["tracer"] = _Bounds(ctx.tracer)
        if recorder:
            profiling.enable(device)

    try:
        line = run.run_cell(name, seed, seconds, False, device=device,
                            root=root, prepare=prepare)
    finally:
        spans = profiling.collect()
    out = {"workload": name, "seed": seed, "recorder": bool(recorder),
           "correct": line["correct"], "metrics": line["metrics"]}
    if recorder:
        kind = cell["mix"]["kind"]
        numbers = (serve_numbers(spans, kept["tracer"].bounds)
                   if kind == "serve_closed" else train_numbers(spans))
        out["spans"] = numbers
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--recorder", type=int, choices=(0, 1), required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device", file=sys.stderr)
        return 2
    try:
        out = report(args.workload, args.seed, args.seconds,
                     bool(args.recorder))
    except ValueError as e:                # a cell on a mesh
        print(f"portbench.spans: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
