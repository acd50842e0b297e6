"""Traffic kind ``serve_closed``: a closed loop of callers against the
program's ``GenerationService``, in process.

The mix gives the song length (``n_steps``), the service's settings
(``batch``: 0 is the service's auto batch; ``max_wait_ms``,
``pipeline_depth``, ``transport``) and the callers: ``clients_per_batch``
times the batch, each resubmitting a plain request when its future
resolves. The futures' callbacks only count the callers that are free;
one pump thread submits them, all that are free when it wakes
(``submit_many``), so the host spends no thread per caller.

Measured, from the callers' clock: songs completed in the window over the
window's seconds (``songs_per_s``) and the 95th percentile of the
latency, submit to resolved future, of every request completed in it
(``song_latency_p95_ms``).

Output check: after the window, ``check_songs`` of the songs served
(drawn from the seed among those the callbacks kept, ``keep_rows`` rows of
every batch) are replayed by the reference, teacher forced, on the
streams of their batch and row (reference/model.py). Two numbers are
compared: the share of the checked (song, step, track) frames whose
replay gives another frame (``frames_differing``), and the widest margin
by which a served note contradicts its final draw (``worst_margin``).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from portbench import weights as weights_mod
from portbench import yardstick


class ClosedLoop:
    """The callers: ``clients`` requests in flight, each resubmitted when
    it resolves, until ``stop_at``; a pump thread does the submitting."""

    def __init__(self, service, clients: int, keep_rows):
        self.svc = service
        self.keep_rows = frozenset(int(r) for r in keep_rows)
        self.cv = threading.Condition()
        self.free = clients              # callers ready to submit
        self.outstanding = 0
        self.stop_at = float("inf")
        self.stopped = False
        self.submitted = []              # submit times
        self.done = []                   # (t_submit, t_done, queue_s)
        self.kept = {}                   # (batch, row) -> roll
        self.errors = []
        self.pump = threading.Thread(target=self._pump,
                                     name="portbench-pump")

    def _callback(self, t_submit: float, fut) -> None:
        t = time.perf_counter()
        try:
            r = fut.result()
        except Exception as e:           # a failed request counts as failed
            ok, r = False, e
        else:
            ok = True
        with self.cv:
            if ok:
                self.done.append((t_submit, t, r.queue_s))
                if r.row in self.keep_rows:
                    self.kept[(r.batch_index, r.row)] = r.roll
            else:
                self.errors.append(repr(r))
            self.outstanding -= 1
            if t < self.stop_at:
                self.free += 1
            self.cv.notify_all()

    def _pump(self) -> None:
        while True:
            with self.cv:
                while not self.free and not self.stopped:
                    self.cv.wait()
                if self.stopped:
                    return
                n, self.free = self.free, 0
                self.outstanding += n
            t = time.perf_counter()
            futs = self.svc.submit_many(n)
            with self.cv:
                self.submitted += [t] * n
            for f in futs:
                f.add_done_callback(
                    lambda fut, t=t: self._callback(t, fut))

    def start(self, stop_at: float) -> None:
        self.stop_at = stop_at
        self.pump.start()

    def stop(self, timeout: float) -> bool:
        """Stop submitting; wait for every request in flight. False when
        some never resolved."""
        with self.cv:
            self.stopped = True
            self.cv.notify_all()
        self.pump.join(timeout)
        deadline = time.perf_counter() + timeout
        with self.cv:
            while self.outstanding and time.perf_counter() < deadline:
                self.cv.wait(1.0)
            return self.outstanding == 0


def window_metrics(done, t_end: float, seconds: float):
    """(songs_per_s, song_latency_p95_ms) of the requests ``done`` as
    (t_submit, t_done, ...): every request completed by ``t_end`` over the
    window's ``seconds``, and the 95th percentile of all their latencies."""
    lat = [(b - a) * 1e3 for a, b, *_ in done if b <= t_end]
    if not lat:
        return 0.0, float("nan")
    return len(lat) / seconds, float(np.percentile(lat, 95))


def run(ctx) -> dict:
    import torch
    from multinn_torch.serving.service import GenerationService, ServeConfig

    ctx.mark("program imported")
    mix, cfg_file = ctx.mix, ctx.cfg
    cfg = ctx.experiment_config()
    dev = torch.device(ctx.device)
    torch.empty(1, device=dev)
    ctx.mark("device ready")
    wts = weights_mod.draw(cfg.model, ctx.seeds.weights,
                           cfg_file["bv_shift"], dev)
    params = weights_mod.port_params(cfg.model, ctx.program_weights(wts))
    ctx.mark("weights drawn")
    n_steps = mix["n_steps"]
    svc = GenerationService(cfg, params, ServeConfig(
        batch=mix["batch"], n_steps=n_steps, max_wait_ms=mix["max_wait_ms"],
        pipeline_depth=mix["pipeline_depth"], seed=ctx.seeds.program,
        transport=mix["transport"]))
    batch = svc.batch
    ctx.mark("service built and warmed up")
    rng = np.random.default_rng(ctx.seeds.sample)
    keep = rng.choice(batch, size=min(mix["keep_rows"], batch),
                      replace=False)
    loop = ClosedLoop(svc, mix["clients_per_batch"] * batch, keep)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - ctx.t0
    before = svc.stats()
    ctx.tracer.start()
    with ctx.tracer.window(sync=lambda: None):
        t_start = time.perf_counter()
        t_end = t_start + ctx.seconds
        loop.start(t_end)
        time.sleep(max(t_end - time.perf_counter(), 0.0))
    after = svc.stats()
    settled = loop.stop(timeout=120.0)
    svc.close()
    ctx.tracer.finish()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    in_window = [d for d in loop.done if d[1] <= t_end]
    if in_window:
        lat = np.array([b - a for a, b, _ in in_window]) * 1e3
        ctx.note(f"latency ms p5/50/90/95/99/max "
                 f"{np.percentile(lat, [5, 50, 90, 95, 99, 100]).tolist()}")
    songs_per_s, p95 = window_metrics(loop.done, t_end, ctx.seconds)
    attempted = sum(1 for t in loop.submitted if t <= t_end)
    failed = len(loop.errors) + (0 if settled else loop.outstanding)

    # the program's state is freed before the reference runs
    del svc, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = _check(ctx, wts, loop.kept, batch, cfg.model, rng,
                    mix["check_songs"])
    limits = ctx.cell["limits"]
    compared = {k: (v, limits[k]) for k, v in checks.items()}
    correct = (failed == 0 and len(in_window) > 0
               and all(v <= lim for v, lim in compared.values()))

    kept_rolls = list(loop.kept.values())
    density = (float(np.mean([r.mean() for r in kept_rolls]))
               if kept_rolls else 0.0)
    ctx.note(f"note density of the kept songs: {density!r}")
    dims = yardstick.dims_of(cfg_file["model"])
    decoder = cfg_file["model"]["decoder_type"]
    return {
        "e2e": {"songs_per_s": songs_per_s, "song_latency_p95_ms": p95,
                "setup_s": setup_s},
        "records": {
            "kind": "serve", "decoder": decoder, "dims": dims,
            "gen_k": cfg_file["model"]["gen_k"], "n_steps": n_steps,
            "batch": batch, "window_s": ctx.seconds,
            "songs": len(in_window),
            "queue_s": [q for _, _, q in in_window],
            "batches": after["batches"] - before["batches"],
            "padded_rows": after["padded_rows"] - before["padded_rows"],
            "density": density,
        },
        "checks": compared,
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "memory_peak_bytes": peak,
    }


def _check(ctx, wts, kept: dict, batch: int, model_cfg, rng, n: int):
    """Replay a seeded sample of the kept songs with the reference."""
    import torch

    from portbench.reference import model as ref
    from portbench.reference import threefry

    if not kept:
        return {"frames_differing": 1.0, "worst_margin": 1.0}
    ref.no_tf32()
    picks = sorted(kept)
    order = rng.permutation(len(picks))[:n]
    chosen = [picks[i] for i in sorted(order)]
    base = threefry.prng_key(ctx.seeds.program)
    keys = [threefry.fold_in(base, b) for b, _ in chosen]
    rows = [r for _, r in chosen]
    dev = wts["w"].device
    rolls = torch.from_numpy(np.stack([kept[c] for c in chosen])).to(
        dev, torch.float32)
    with torch.no_grad():
        if model_cfg.decoder_type == "rnn-rbm":
            out = ref.rbm_replay(wts, rolls, keys, rows, batch,
                                 model_cfg.gen_k)
        else:
            out = ref.nade_replay(wts, rolls, keys, rows, batch)
    return {"frames_differing": float(out["frames"].sum())
            / (len(chosen) * out["cells"]),
            "worst_margin": float(out["margin"].max())}
