"""Traffic kind ``train_groups``: the program's ``Trainer`` fed groups of
``steps_per_call`` steps, each group one ``run_group`` call (on the card
a captured CUDA graph, replayed).

The mix gives the input: a pool of ``pool_windows`` windows of
Bernoulli(``density``) uint8 pianoroll, drawn on the card from the seed
and held in host memory as a dataset's cache holds its windows. Every
group takes B * ``steps_per_call`` distinct windows of the pool, drawn
from the seed, and is staged (gathered, then copied by ``run_group``)
inside the window, as a training loop stages it. At most ``run_ahead``
groups are queued on the card beyond the one running.

A cell with a ``mesh`` (``{"data": n, "style": "gspmd"}``) trains on
that mesh, one spawned rank a card: B is the batch of one card, every
rank stages the same global batch and takes its block, NCCL (gloo
without cards) joins the ranks through a file store in the run's
scratch directory under TMPDIR, and rank 0 decides for all, through a
gloo group, when the window closes and which groups are traced.

Measured: global frames (B * T * ranks of every step of every group run
in the window) over the window's seconds, the window closed after the
card finished its last group (``train_frames_per_s``). Span: the host
time to stage a group and enqueue it (``group_host_ms``).

Output check: set-up drives the trainer through its first group, which
captures the graph and replays it once; the reference (reference/model.py)
follows the same steps from the same weights, global batches and keys
on one device. Compared: the group's last loss and mean loss
(``loss_gap``), the last step's gradient norm before the clip
(``grad_norm_gap``), and by the worst leaf, as a share of the larger of
that leaf's and the median leaf's reference norm, the norm of each
leaf's change over the group (``change_gap``) and of Adam's first moment
after it, the gradient as the optimizer holds it (``moment_gap``).
Leaves whose reference moment is under a thousandth of the median
leaf's are left out of both.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path

import numpy as np

from portbench import weights as weights_mod
from portbench import yardstick

_CONTINUE, _STOP, _TRACE = 0, 1, 2


class _Pool:
    """The dataset interface the Trainer reads at construction."""

    def n_batches(self, split: str = "train") -> int:
        return 1


def run(ctx) -> dict:
    import torch
    mesh = ctx.cell.get("mesh")
    if mesh:
        results = _run_world(ctx, mesh)
    else:
        results = [_train(ctx, torch.device(ctx.device))]
    return _result(ctx, results, torch.device(ctx.device))


def _train(ctx, dev, mesh=None, rank: int = 0, control_group=None) -> dict:
    """One rank's run (the only one without a mesh): set-up, the first
    group, the window. Returns its numbers; rank 0's also hold the first
    group's inputs and the program's state after it."""
    import torch
    import torch.distributed as dist
    from multinn_torch.ops import sampling
    from multinn_torch.training.trainer import Trainer
    from multinn_torch.utils.config import MeshConfig

    ctx.mark("program imported")
    mix, cfg_file = ctx.mix, ctx.cfg
    cfg = ctx.experiment_config()
    world = 1
    if mesh:
        world = mesh["data"]
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(
                cfg.data, batch_size=cfg.data.batch_size * world),
            mesh=MeshConfig(use_mesh=True, data=world,
                            style=mesh.get("style", "gspmd")))
    torch.empty(1, device=dev)
    ctx.mark("device ready")
    b, t = cfg.data.batch_size, cfg.data.window
    k, d = cfg.model.n_tracks, cfg.model.n_pitches
    spc = cfg.train.steps_per_call
    wts = weights_mod.draw(cfg.model, ctx.seeds.weights,
                           cfg_file["bv_shift"], dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seeds.data)
    pool = (torch.rand((mix["pool_windows"], t, k, d), generator=gen,
                       device=dev) < mix["density"]).to(torch.uint8).cpu()
    pool = pool.numpy()
    rng = np.random.default_rng(ctx.seeds.data)
    ctx.mark("weights and input pool drawn")

    def stage():
        idx = rng.choice(len(pool), size=spc * b, replace=False)
        return pool[idx].reshape(spc, b, t, k, d)

    trainer = Trainer(cfg, dataset=_Pool(),
                      params=weights_mod.port_params(
                          cfg.model, ctx.program_weights(wts)))
    names = weights_mod.leaf_names(trainer.params.decoder)
    ctx.mark("trainer built")

    def next_key():
        trainer.rng, key = sampling.split(trainer.rng)
        return key

    # set-up: the first group captures the graph and runs once
    first, key1 = stage(), next_key()
    out = trainer.run_group(first, key1)
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    sync()
    res = {"rank": rank, "world": world, "batch": b, "window": t,
           "spc": spc, "density": float(pool.mean()),
           "cd_k": cfg.model.cd_k}
    if rank == 0:
        res["first"] = {
            "x": first, "key": [int(w) for w in key1.view(torch.int32)],
            "wts": {n: x.to("cpu", copy=True) for n, x in wts.items()},
            "loss": float(out["loss"]), "loss_mean": float(out["loss_mean"]),
            "grad_norm": float(out["grad_norm"]),
            "params": {n: p.detach().to("cpu", copy=True) for n, p in zip(
                names, trainer._leaves)},
            "mu": {n: m.to("cpu", copy=True) for n, m in zip(
                names, trainer.opt_state["mu"])},
            "lr": cfg.train.lr, "clip": cfg.train.grad_clip,
            "decoder": cfg.model.decoder_type}
    ctx.mark("first group captured and run")

    def decide(code: int) -> int:
        """Rank 0's decision, the same on every rank."""
        if control_group is None:
            return code
        flag = torch.tensor([code])
        dist.broadcast(flag, 0, group=control_group)
        return int(flag)

    spans, ends = [], []
    run_ahead = mix["run_ahead"]

    def group():
        # staged before the wait for the card, so only the enqueue follows it
        t0 = time.perf_counter()
        batch = stage()
        staged = time.perf_counter() - t0
        if len(ends) > run_ahead:
            ends[-run_ahead - 1].synchronize()
        t1 = time.perf_counter()
        trainer.run_group(batch, next_key())
        spans.append(staged + time.perf_counter() - t1)
        if dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)

    if control_group is not None:
        dist.barrier(group=control_group)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res["setup_s"] = time.perf_counter() - ctx.t0
    # with --trace 1 the profiler starts a third into the window, one
    # group before the traced stretch of ``traced_groups`` groups
    traced = not ctx.trace
    traced_s, traced_n = 0.0, 0
    t_start = time.perf_counter()
    t_end = t_start + ctx.seconds
    while True:
        now = time.perf_counter()
        code = (_STOP if now >= t_end else _TRACE
                if not traced and now >= t_start + ctx.seconds / 3
                else _CONTINUE)
        code = decide(code)
        if code == _STOP:
            break
        if code == _TRACE:
            t0, n0 = time.perf_counter(), len(spans)
            ctx.tracer.start()
            group()
            with ctx.tracer.window(sync):
                for _ in range(mix["traced_groups"]):
                    group()
            traced = True
            traced_s, traced_n = time.perf_counter() - t0, len(spans) - n0
            del spans[n0:]
        else:
            group()
    sync()
    res["window_s"] = time.perf_counter() - t_start
    res["groups"] = len(spans) + traced_n
    res["spans"] = spans
    res["untraced"] = (len(spans), res["window_s"] - traced_s)
    res["peak"] = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    ctx.tracer.finish()
    res["trace"] = ctx.tracer.result
    if len(ends) > 1:
        ms = [a.elapsed_time(z) for a, z in zip(ends, ends[1:])]
        ctx.note(f"device ms from one group's end to the "
                 f"next: {np.percentile(ms, [0, 5, 50, 95, 100]).tolist()}")
    return res


def _rank_main(rank: int, world: int, payload: dict) -> None:
    """A spawned rank: join the world, train, write the numbers."""
    import contextlib

    import torch
    import torch.distributed as dist
    from multinn_torch.parallel import mesh as mesh_mod

    from portbench import control, run, spec
    root = Path(payload["root"])
    ctx = run.Context(spec.cell(payload["cell"], root),
                      payload["seed"], payload["seconds"], payload["trace"],
                      payload["device"], payload["t0"], root,
                      workdir=os.path.join(payload["workdir"], f"r{rank}"))
    ctx.cfg = payload["cfg"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = "nccl" if payload["device"] == "cuda" else "gloo"
    mesh_mod.init_distributed(f"file://{payload['workdir']}/store", world,
                              rank, backend)
    dev = mesh_mod.rank_device(backend)
    control_group = dist.new_group(backend="gloo")
    fault = (control.planted(payload["fault"]) if payload["fault"]
             else contextlib.nullcontext())
    try:
        with fault:
            res = _train(ctx, dev, payload["mesh"], rank, control_group)
        res["notes"] = ctx.marks
        torch.save(res, os.path.join(payload["workdir"], f"rank{rank}.pt"))
        dist.barrier(group=control_group)
    except BaseException:
        import traceback
        with open(os.path.join(payload["workdir"], f"rank{rank}.err"),
                  "w") as f:
            f.write(traceback.format_exc())
        # a rank that failed inside a collective can hang on the way out
        os._exit(1)
    finally:
        ctx.close()
    dist.destroy_process_group()


def _run_world(ctx, mesh: dict) -> list:
    """Spawn one rank a chip and wait for them; their numbers by rank."""
    import torch
    import torch.multiprocessing as mp
    world = ctx.cell["chips"]
    if mesh["data"] != world:
        raise ValueError(f"mesh {mesh} does not fill {world} chips")
    payload = dict(cell=ctx.cell["name"], root=str(ctx.root),
                   seed=ctx.seed, seconds=ctx.seconds, trace=ctx.trace,
                   device=torch.device(ctx.device).type, t0=ctx.t0,
                   workdir=ctx.workdir, cfg=ctx.cfg, mesh=mesh,
                   fault=ctx.fault)
    # the spawned ranks find the target by its importable name
    from portbench.traffic import train_groups
    procs = mp.start_processes(train_groups._rank_main, args=(world, payload),
                               nprocs=world, join=False,
                               start_method="spawn")
    deadline = time.time() + ctx.seconds + ctx.mix["world_timeout_s"]
    try:
        while not procs.join(timeout=max(deadline - time.time(), 0.1)):
            if time.time() >= deadline:
                raise TimeoutError(f"the {world} ranks still ran at the "
                                   f"deadline")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
        for p in procs.processes:
            p.join()
    results = []
    for r in range(world):
        res = torch.load(os.path.join(ctx.workdir, f"rank{r}.pt"),
                         weights_only=False)
        ctx.marks += [f"rank {r}: {n}" for n in res.pop("notes")]
        results.append(res)
    return results


def _result(ctx, results: list, dev) -> dict:
    """The kind's result from every rank's numbers (rank 0's first)."""
    import torch
    r0 = results[0]
    world = r0["world"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = _check(r0["first"], dev)
    limits = ctx.cell["limits"]
    compared = {name: (v, limits[name]) for name, v in checks.items()
                if name in limits}
    ctx.note("not compared: " + ", ".join(
        f"{name} {v!r}" for name, v in checks.items() if name not in limits))
    traces = [r["trace"] for r in results if r["trace"]]
    if traces:
        ctx.tracer.result = _merge(traces)
    frames = r0["groups"] * r0["spc"] * r0["batch"] * r0["window"]
    return {
        "e2e": {"train_frames_per_s": frames / r0["window_s"],
                "setup_s": r0["setup_s"]},
        "records": {
            "kind": "train", "decoder": r0["first"]["decoder"],
            "dims": yardstick.dims_of(ctx.cfg["model"]),
            "batch": r0["batch"], "window": r0["window"],
            "rows_per_launch": r0["batch"] // world * r0["window"],
            "chips": world, "steps": r0["untraced"][0] * r0["spc"],
            "window_s": r0["untraced"][1], "group_host_s": r0["spans"],
            "density": r0["density"], "cd_k": r0["cd_k"],
            "idle_by_rank": [1.0 - tr["busy_s"] / tr["window_s"]
                             for tr in traces],
        },
        "checks": compared,
        "correct": all(v <= lim for v, lim in compared.values()),
        "attempted": r0["groups"],
        "failed": 0,
        "memory_peak_bytes": max(r["peak"] for r in results),
    }


def _merge(traces: list) -> dict:
    """The ranks' trace summaries as one: busy and window seconds averaged
    over the ranks, launches summed, rank 0's breakdown."""
    n = len(traces)
    whole: dict = {}
    for tr in traces:
        for name, (c, s) in tr["op_whole"].items():
            c0, s0 = whole.get(name, (0, 0.0))
            whole[name] = (c0 + c, s0 + s)
    return dict(traces[0],
                busy_s=sum(tr["busy_s"] for tr in traces) / n,
                window_s=sum(tr["window_s"] for tr in traces) / n,
                op_whole=whole)


def _check(first: dict, dev) -> dict:
    """The reference's steps of the first group against the program's."""
    import torch

    from portbench.reference import model as ref
    from portbench.reference import threefry

    ref.no_tf32()
    if first["decoder"] != "rnn-rbm":
        raise ValueError("the train check follows RNN-RBM training")
    wts = {n: x.to(dev) for n, x in first["wts"].items()}
    words = [w & threefry.MASK for w in first["key"]]
    x = torch.from_numpy(first["x"]).to(dev, torch.float32)
    keys = [threefry.split(words, i) for i in range(x.shape[0])]
    after, opt, losses, norms = ref.rbm_train(wts, list(x), keys,
                                              first["lr"], first["clip"])

    def rel(a, b):
        return abs(a - b) / abs(b)

    def worst_leaf(prog_norm, ref_norm, live):
        med = float(np.median([ref_norm[n] for n in live]))
        return max(abs(prog_norm[n] - ref_norm[n]) / max(ref_norm[n], med)
                   for n in live)

    mom_ref = {n: float(m.norm()) for n, m in opt.mu.items()}
    med = float(np.median(list(mom_ref.values())))
    live = [n for n, v in mom_ref.items() if v >= 1e-3 * med]
    out_of_check = sorted(set(mom_ref) - set(live))
    change = lambda p: {n: float((p[n].to(dev) - wts[n]).norm())
                        for n in live}
    return {
        "loss_gap": max(rel(first["loss"], losses[-1]),
                        rel(first["loss_mean"], float(np.mean(losses)))),
        "grad_norm_gap": rel(first["grad_norm"], norms[-1]),
        "change_gap": worst_leaf(change(first["params"]), change(after),
                                 live),
        "moment_gap": worst_leaf(
            {n: float(first["mu"][n].norm()) for n in live}, mom_ref, live),
        "leaves_left_out": len(out_of_check),
        "smallest_moment_share": min(mom_ref.values()) / med,
    }
