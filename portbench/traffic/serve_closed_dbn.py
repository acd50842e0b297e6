"""Traffic kind ``serve_closed_dbn``: ``serve_closed``'s closed loop of
callers (imported, not edited) against the program's
``GenerationService``, for a per-track model whose RNN-RBM decoders
sample a DBN's latents and whose encoders decode them to pianoroll.

The mix gives what ``serve_closed``'s gives. The service also hands back
the model-space (latent) roll of the ``keep_rows`` rows the callers keep
(``GenerationService``'s ``latent_rows``). Measured: as ``serve_closed``. With
``--trace 1`` the program's span recorder is on over the window
(``profiling.enable``), and its spans, its counters and the window's
bounds on ``time.time_ns()`` go into the records.

Output check: after the window, ``check_songs`` of the kept songs (drawn
from the seed) are replayed by the reference
(``reference/per_track_dbn.py``) on the streams of their batch and row.
Four numbers are compared: the share of the checked (song, step, track)
latent frames whose teacher-forced chain gives another frame
(``latent_frames_differing``) and the widest margin by which a served
latent contradicts its final draw (``latent_worst_margin``); the share
of the checked pianoroll cells that are not ``u < p(v | served latents)``
on the decode's stream (``decode_cells_differing``) and the widest
margin of those (``decode_worst_margin``).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import weights_dbn, yardstick_per_track
from portbench.traffic.serve_closed import ClosedLoop, window_metrics

CHECKS = ("latent_frames_differing", "latent_worst_margin",
          "decode_cells_differing", "decode_worst_margin")


class LatentLoop(ClosedLoop):
    """The callers; of the kept rows they keep the latent roll too."""

    def __init__(self, service, clients: int, keep_rows):
        super().__init__(service, clients, keep_rows)
        self.latents = {}                # (batch, row) -> latent roll

    def _callback(self, t_submit: float, fut) -> None:
        if fut.exception() is None:
            r = fut.result()
            if r.row in self.keep_rows:
                with self.cv:
                    self.latents[(r.batch_index, r.row)] = r.latent
        super()._callback(t_submit, fut)


def run(ctx) -> dict:
    import torch
    from multinn_torch.serving.service import (GenerationService,
                                               ServeConfig, auto_batch)
    from multinn_torch.utils import profiling

    ctx.mark("program imported")
    mix, cfg_file = ctx.mix, ctx.cfg
    cfg = ctx.experiment_config()
    dev = torch.device(ctx.device)
    torch.empty(1, device=dev)
    ctx.mark("device ready")
    wts = weights_dbn.draw(cfg.model, ctx.seeds.weights,
                           cfg_file["bv_shift"], dev)
    params = weights_dbn.port_params(cfg.model, ctx.program_weights(wts))
    ctx.mark("weights drawn")
    n_steps = mix["n_steps"]
    batch = mix["batch"] or auto_batch(cfg, n_steps)
    rng = np.random.default_rng(ctx.seeds.sample)
    keep = rng.choice(batch, size=min(mix["keep_rows"], batch),
                      replace=False)
    svc = GenerationService(cfg, params, ServeConfig(
        batch=batch, n_steps=n_steps, max_wait_ms=mix["max_wait_ms"],
        pipeline_depth=mix["pipeline_depth"], seed=ctx.seeds.program,
        transport=mix["transport"]),
        latent_rows=tuple(int(r) for r in keep))
    ctx.mark("service built and warmed up")
    loop = LatentLoop(svc, mix["clients_per_batch"] * batch, keep)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - ctx.t0
    before = svc.stats()
    if ctx.trace:
        profiling.enable(dev)
    ctx.tracer.start()
    with ctx.tracer.window(sync=lambda: None):
        window_ns = [time.time_ns()]
        t_start = time.perf_counter()
        t_end = t_start + ctx.seconds
        loop.start(t_end)
        time.sleep(max(t_end - time.perf_counter(), 0.0))
        window_ns.append(time.time_ns())
    after = svc.stats()
    settled = loop.stop(timeout=120.0)
    svc.close()
    ctx.tracer.finish()
    spans = profiling.collect() if ctx.trace else []
    counts = profiling.counts() if ctx.trace else {}
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
    checks = _check(ctx, wts, loop.kept, loop.latents, cfg.model, rng,
                    mix["check_songs"])
    limits = ctx.cell["limits"]
    compared = {k: (checks[k], limits[k]) for k in CHECKS}
    correct = (failed == 0 and len(in_window) > 0
               and all(v <= lim for v, lim in compared.values()))

    density = _mean_density(loop.kept.values())
    latent_density = _mean_density(loop.latents.values())
    ctx.note(f"density of the kept songs: pianoroll {density!r}, "
             f"latents {latent_density!r}")
    if counts:
        ctx.note(f"program counters: {counts}")
    return {
        "e2e": {"songs_per_s": songs_per_s, "song_latency_p95_ms": p95,
                "setup_s": setup_s},
        "records": {
            "kind": "serve", "decoder": cfg_file["model"]["decoder_type"],
            "mode": cfg_file["model"]["mode"],
            "dims": yardstick_per_track.dims_of(cfg_file["model"]),
            "gen_k": cfg_file["model"]["gen_k"], "n_steps": n_steps,
            "batch": batch, "window_s": ctx.seconds,
            "songs": len(in_window),
            "queue_s": [q for _, _, q in in_window],
            "batches": after["batches"] - before["batches"],
            "padded_rows": after["padded_rows"] - before["padded_rows"],
            "density": density,
            "window_ns": window_ns,
            "spans": [(s.name, s.start_ns, s.end_ns, s.ident)
                      for s in spans],
            "counts": counts,
        },
        "checks": compared,
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "memory_peak_bytes": peak,
    }


def _mean_density(rolls) -> float:
    rolls = list(rolls)
    return float(np.mean([r.mean() for r in rolls])) if rolls else 0.0


def _check(ctx, wts, kept: dict, latents: dict, model_cfg, rng,
           n: int) -> dict:
    """Replay a seeded sample of the kept songs with the reference."""
    import torch

    from portbench.reference import model as ref
    from portbench.reference import per_track_dbn
    from portbench.reference import threefry

    picks = sorted(kept)
    if not picks:
        return dict.fromkeys(CHECKS, 1.0)
    ref.no_tf32()
    order = rng.permutation(len(picks))[:n]
    chosen = [picks[i] for i in sorted(order)]
    base = threefry.prng_key(ctx.seeds.program)
    keys = [threefry.fold_in(base, b) for b, _ in chosen]
    rows = [r for _, r in chosen]
    dev = wts["w"].device
    stack = lambda rolls: torch.from_numpy(np.stack(
        [rolls[c] for c in chosen])).to(dev, torch.float32)
    lat, roll = stack(latents), stack(kept)
    with torch.no_grad():
        chain = per_track_dbn.latent_replay(wts, lat, keys, rows,
                                            model_cfg.gen_k)
        dec = per_track_dbn.decode_replay(wts, lat, roll, keys, rows)
    m = len(chosen)
    return {
        "latent_frames_differing": float(chain["frames"].sum())
        / (m * chain["cells"]),
        "latent_worst_margin": float(chain["margin"].max()),
        "decode_cells_differing": float(dec["cells"].sum())
        / (m * dec["cells_per_song"]),
        "decode_worst_margin": float(dec["margin"].max()),
    }
