"""Meshes with one card per rank: the port's mesh training, generation and
serving on NCCL, each ``steps_per_call`` group captured as one CUDA graph
per rank with its collectives inside, checked against one device and
timed.

    python -m multinn_torch.scripts.mesh_cards --cards 4 [--timeout 1500]

Spawns one process per card (rank r on card r; NCCL through a file store
in a temporary directory) after building the kernels once in this
process. Every rank runs the same cases in the same order, each at the
full widths of the two flagships (feedback, K=5, D=84, H=150, U=100,
gen_k=10, T=64) on seeded Bernoulli(0.06) rolls, with the per-card batch
of phase 13 of ``chip_smoke.py`` on every card (RNN-RBM B=16, RNN-NADE
B=64, so the global batch is the card count times that):

  * layouts, ``n`` the card count: gspmd data=n and shard_map data=n (both
    families); gspmd data=n/2 x model=2 (both, H split over two cards;
    n even); seqpipe seq=n (RNN-NADE, T split, ``auto_microbatches``;
    n >= 2); Hessian-free gspmd data=n (RNN-NADE, cg_iters 25, groups of
    2 macro-steps: two captured macro-steps take about 12 GB of graph
    pool at B=64 a card);
  * for each layout: the first mesh step against the one-device step at
    the same global batch on the rank's card (loss rtol 1e-5, params rtol
    1e-4 / atol 1e-6; shard_map's RBM against the mean of the shards'
    gradients under their folded keys); a group of 24 steps replayed
    against the same group run eagerly on the mesh (params within 1e-6
    max|p| per tensor, each replay's launches 24 times one eager step's);
    the eager and the replayed step ms (CUDA events around groups and
    replays, / steps), frames/s, capture seconds, the graph pool's
    bytes, and from ``torch.profiler`` over three replays the device time
    a step of the NCCL kernels (their share of the step: an upper bound
    of the collectives' cost, since a collective's kernel also waits for
    the slowest rank; the least share over the ranks is printed too) and
    of the family's kernels;
  * for gspmd data=n, the same replayed step on one card at the per-card
    batch (weak scaling) and at the global batch (strong scaling);
  * generation on data=n, B=8 a card: at T=16 at least 7 of each card's
    8 samples bit-identical to one device's generation of the whole
    batch; at T=1024 songs/s against one card at B=8 (the fused kernel
    launched once a card a generation), and the device ms of a card's
    generation of its 8 rows alone (CUDA events); a mesh service (batch
    8, 1024 steps) answering 24 requests, rank 0 taking them while the
    others ``follow()``.

Prints one JSON line per case (rank 0's numbers, with every rank's step
ms), the card's name and power limit (``nvidia-smi``), then
``{"gates": {...}, "ok": ...}`` last. Exits 1 when a gate fails, 2 when
the host has fewer cards than ``--cards`` (it says so; it never falls
back to gloo or to shared cards).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SIZES = dict(k=5, d=84, h=150, u=100, t=64, b_rbm=16, b_nade=64, spc=24,
             hf_spc=2, hf_cg=25, t_check=16, t_gen=1024, b_gen=8,
             requests=24)
# a family's kernels, by the substrings of their CUDA function names
KERNELS = {"gibbs_chain": ("gibbs_rows_kernel", "gibbs_split_kernel"),
           "nade_ll_fwd": ("nade_ll_fwd_kernel", "sum_chunks_kernel"),
           "nade_ll_bwd": ("nade_ll_bwd_kernel", "sum_parts_kernel"),
           "threefry": ("threefry2x32_kernel",),
           "gen_fused_rbm": ("gen_fused_rbm_kernel",),
           "gen_fused_nade": ("gen_fused_nade_kernel",)}
FAMILY = {"rnn-rbm": ("gibbs_chain",),
          "rnn-nade": ("nade_ll_fwd", "nade_ll_bwd")}


def layouts(n: int, sizes=SIZES):
    """(case, decoder, mesh keywords, train keywords) for ``n`` cards."""
    out = []
    for dec in ("rnn-rbm", "rnn-nade"):
        fam = "rbm" if dec == "rnn-rbm" else "nade"
        out.append((f"gspmd_data{n}_{fam}", dec, dict(data=n), {}))
        out.append((f"shard_map_data{n}_{fam}", dec,
                    dict(data=n, style="shard_map"), {}))
        if n >= 2 and n % 2 == 0:
            out.append((f"gspmd_data{n // 2}_model2_{fam}", dec,
                        dict(data=n // 2, model=2), {}))
    if n >= 2:
        out.append((f"seqpipe_seq{n}_nade", "rnn-nade",
                    dict(data=1, seq=n, style="seqpipe"), {}))
    out.append((f"hf_gspmd_data{n}_nade", "rnn-nade", dict(data=n),
                dict(optimizer="hf", hf_cg_iters=sizes["hf_cg"],
                     steps_per_call=sizes["hf_spc"])))
    return out


def _cfg(sizes, decoder, mesh, run_dir, **train):
    """An ExperimentConfig of the flagship (feedback) on ``mesh``
    (MeshConfig keywords; None: one device)."""
    from multinn_torch.models import multinn
    from multinn_torch.utils.config import (ExperimentConfig, MeshConfig,
                                            TrainConfig)
    train = dict(dict(steps_per_call=sizes["spc"]), **train)
    model = multinn.MultINNConfig(
        n_tracks=sizes["k"], n_pitches=sizes["d"], mode="feedback",
        decoder_type=decoder, n_hidden=sizes["h"], n_rnn=sizes["u"],
        gen_k=10)
    return ExperimentConfig(
        model=model, train=TrainConfig(log_every_steps=10 ** 9,
                                       ckpt_every_steps=0, run_dir=run_dir,
                                       **train),
        mesh=MeshConfig(use_mesh=mesh is not None, **(mesh or {})))


class _Rolls:
    """``n`` seeded Bernoulli(0.06) batches (B, T, K, D) behind the Dataset
    interface, the same on every rank."""

    def __init__(self, sizes, batch, n, seed):
        rng = np.random.default_rng(seed)
        self.xs = (rng.random((n, batch, sizes["t"], sizes["k"],
                               sizes["d"])) < 0.06).astype(np.uint8)

    def n_batches(self, split="train"):
        return len(self.xs)

    def batches(self, split="train", epoch=0, shuffle=True,
                drop_remainder=True, with_masks=False, augment=False):
        for x in self.xs:
            yield ((x, np.ones(x.shape[:2], np.uint8)) if with_masks else x)


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _rel_diff(got, want) -> float:
    """The largest difference of two lists of tensors, as a share of each
    reference tensor's max |p|."""
    return max(float((a - b).detach().abs().max()
                     / b.detach().abs().max().clamp(min=1e-30))
               for a, b in zip(got, want))


def _profile(fn, steps: int, names, reps: int = 3) -> dict:
    """Device ms a step over ``reps`` calls of ``fn`` (``steps`` steps
    each): every kernel, the NCCL kernels, and each of ``names``' kernels
    (KERNELS). The ranks leave a barrier together, so a collective's
    kernel waits little for a late rank; what it still waits is counted
    (the least share over the ranks is the closest to the transfers)."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    ms = lambda match: sum(e.self_device_time_total for e in kernels
                           if match(e.key)) / 1e3 / (steps * reps)
    out = {"busy_ms": ms(lambda k: True),
           "nccl_ms": ms(lambda k: "nccl" in k.lower())}
    out["kernels_ms"] = {n: ms(lambda k, n=n: any(s in k for s in KERNELS[n]))
                         for n in names}
    return out


def _one_device_step(cfg_one, src, params, x, key, shard_map_shards):
    """The first step on one device at the global batch: the loss and the
    whole params after it. ``shard_map_shards`` > 0: the shard_map RBM's
    reference, one optimizer step on the mean of the shards' gradients,
    each under ``fold_in(key, shard)``."""
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.ops import sampling
    from multinn_torch.training.trainer import Trainer
    ref = Trainer(cfg_one, src, params=params)
    if not shard_map_shards:
        loss = float(ref.train_step(ref._put_batch(x), key)["loss"])
    else:
        n = shard_map_shards
        per = len(x) // n
        grads, losses = None, []
        for s in range(n):
            xs = ref._to_device(x[s * per:(s + 1) * per])
            loss_s, _ = multinn.loss(ref.params, sampling.fold_in(key, s),
                                     xs, detailed=False)
            g = torch.autograd.grad(loss_s, ref._leaves)
            grads = list(g) if grads is None else [a + b for a, b in
                                                   zip(grads, g)]
            losses.append(float(loss_s.detach()))
        ref.optimizer.update(ref._leaves, [g / n for g in grads],
                             ref.opt_state)
        loss = float(np.mean(losses))
    want = [p.detach().clone() for p in multinn.tree_leaves(ref.params)]
    ref.close()
    return loss, want


def _layout_case(ctx, case, decoder, mesh, train):
    """One layout: the first step against one device, then the captured
    group against the eager group on the mesh, with their times."""
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.ops import _build, sampling
    from multinn_torch.training.trainer import Trainer
    from multinn_torch.utils.profiling import cuda_ms
    sizes, dev, n = ctx["sizes"], ctx["dev"], ctx["world"]
    per_card = sizes["b_nade" if decoder == "rnn-nade" else "b_rbm"]
    batch = per_card * n
    spc = train.get("steps_per_call", sizes["spc"])
    src = _Rolls(sizes, batch, spc, seed=15)
    xs = src.xs[:spc]
    run = lambda name: os.path.join(ctx["out"], f"{case}_{name}_{ctx['rank']}")
    cfg = _cfg(sizes, decoder, mesh, run("mesh"), **train)
    params = multinn.init(cfg.model, torch.Generator().manual_seed(15),
                          device=dev)
    key = sampling.PRNGKey(123, device=dev)
    res = dict(case=case, decoder=decoder, mesh=mesh, global_batch=batch,
               steps=spc, rank=ctx["rank"])

    # the first step on the mesh against one device, then the eager group
    eager = Trainer(cfg, src, params=params)
    eager.capture_groups = False
    state0 = [t.detach().clone() for t in eager._state_tensors()]
    loss = float(eager.train_step(eager._put_batch(xs[0]), key)["loss"])
    got = [p.detach().clone() for p in
           multinn.tree_leaves(eager.full_params())]
    eager._load_state_tensors(state0)
    del state0
    shards = n if (mesh.get("style") == "shard_map"
                   and decoder == "rnn-rbm") else 0
    ref_loss, want = _one_device_step(
        _cfg(sizes, decoder, None, run("one"), **train), src, params,
        xs[0], key, shards)
    worst = max(float(((a - b).abs() / (1e-6 + 1e-4 * b.abs())).max())
                for a, b in zip(got, want))
    del got, want
    res.update(loss=loss, ref_loss=ref_loss, worst_over_tol=worst,
               first_step_ok=bool(abs(loss - ref_loss)
                                  <= 1e-5 * abs(ref_loss) and worst <= 1.0))
    _free()

    graph = Trainer(cfg, src, params=params)
    res["capture_on"] = bool(graph.capture_groups
                             and graph.mesh.backend == "nccl")
    torch.cuda.synchronize()
    res["eager_cold_ms"] = cuda_ms(lambda: eager.run_group(xs, key), 1,
                                   warm=False) / spc
    t0 = time.perf_counter()
    graph.run_group(xs, key)                  # warm-up, capture, one replay
    torch.cuda.synchronize()
    res["first_group_s"] = time.perf_counter() - t0
    g = graph.group_graph
    res["replay_diff"] = _rel_diff(graph._leaves, eager._leaves)
    res["capture_s"], res["pool_bytes"] = g.capture_s, g.graph.pool_bytes
    # the launches of one eager step against a replay's
    _build.launches.clear()
    eager.train_step(eager._put_batch(xs[0]), key)
    torch.cuda.synchronize()
    per_step = dict(_build.launches)
    _build.launches.clear()
    graph.run_group(xs, key)
    torch.cuda.synchronize()
    replayed = dict(_build.launches)
    fam = FAMILY[decoder] if not train.get("optimizer") == "hf" else (
        "nade_ll_fwd",)
    res["launches_per_step"] = per_step
    res["replay_launches"] = replayed
    res["replay_ok"] = bool(
        res["replay_diff"] <= 1e-6 and replayed == dict(g.launches)
        and all(per_step.get(k) and replayed.get(k) == spc * per_step[k]
                for k in fam))
    res["eager_ms"] = cuda_ms(lambda: eager.run_group(xs, key), 1,
                              warm=False) / spc
    res["graph_ms"] = cuda_ms(lambda: graph.run_group(xs, key), 3) / spc
    res["frames_per_s"] = batch * sizes["t"] / res["graph_ms"] * 1e3
    res.update(_profile(lambda: graph.run_group(xs, key), spc, fam))
    res["nccl_share"] = res["nccl_ms"] / res["graph_ms"]
    res["ok"] = res["first_step_ok"] and res["capture_on"] and \
        res["replay_ok"]
    eager.close()
    graph.close()
    del eager, graph, g
    _free()
    return res


def _one_card_case(ctx, decoder):
    """The gspmd data=n layout's replayed step on this rank's card alone,
    at the per-card batch (weak scaling) and at the global batch (strong
    scaling)."""
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.ops import sampling
    from multinn_torch.training.trainer import Trainer
    from multinn_torch.utils.profiling import cuda_ms
    sizes, dev, n = ctx["sizes"], ctx["dev"], ctx["world"]
    fam = "rbm" if decoder == "rnn-rbm" else "nade"
    per_card = sizes[f"b_{fam}"]
    spc = sizes["spc"]
    res = dict(case=f"one_card_{fam}", decoder=decoder, rank=ctx["rank"],
               steps=spc)
    for name, batch in (("per_card", per_card), ("global", per_card * n)):
        src = _Rolls(sizes, batch, spc, seed=7)
        cfg = _cfg(sizes, decoder, None, os.path.join(
            ctx["out"], f"one_{fam}_{name}_{ctx['rank']}"))
        params = multinn.init(cfg.model, torch.Generator().manual_seed(15),
                              device=dev)
        t = Trainer(cfg, src, params=params)
        key = sampling.PRNGKey(123, device=dev)
        t.run_group(src.xs, key)
        ms = cuda_ms(lambda: t.run_group(src.xs, key), 3) / spc
        res[f"{name}_batch"] = batch
        res[f"{name}_graph_ms"] = ms
        res[f"{name}_frames_per_s"] = batch * sizes["t"] / ms * 1e3
        res[f"{name}_pool_bytes"] = t.group_graph.graph.pool_bytes
        t.close()
        del t
        _free()
    return res


def _generation_case(ctx, decoder):
    """Batch-sharded generation on data=n, B=8 a card: each card's samples
    against one device's at T=16, songs/s at T=1024 against one card at
    B=8, the fused kernel's device ms."""
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.ops import _build, sampling
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.training.generator import Generator
    from multinn_torch.utils.profiling import cuda_ms
    sizes, dev, n, rank = ctx["sizes"], ctx["dev"], ctx["world"], ctx["rank"]
    fam = "rbm" if decoder == "rnn-rbm" else "nade"
    cfg = _cfg(sizes, decoder, dict(data=n), ctx["out"])
    params = multinn.init(cfg.model, torch.Generator().manual_seed(19),
                          device=dev)
    key = sampling.PRNGKey(5, device=dev)
    b = sizes["b_gen"] * n
    gen = Generator(cfg, params, mesh=mesh_mod.make_mesh(cfg.mesh))
    one = Generator(cfg, params)
    roll = gen.generate(key, n_steps=sizes["t_check"], batch=b)
    ref = one.generate(key, n_steps=sizes["t_check"], batch=b)
    mine = slice(rank * sizes["b_gen"], (rank + 1) * sizes["b_gen"])
    same = (roll == ref).reshape(b, -1).all(axis=1)
    res = dict(case=f"gen_{fam}", decoder=decoder, rank=rank,
               batch_per_card=sizes["b_gen"], t=sizes["t_gen"],
               identical_mine=int(same[mine].sum()),
               identical=int(same.sum()), of=b,
               density=float(roll.mean()))

    def timed(g, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.generate(key, n_steps=sizes["t_gen"], batch=batch)
        return time.perf_counter() - t0

    timed(gen, b)                              # warm at T=1024
    _build.launches.clear()
    res["mesh_s"] = min(timed(gen, b) for _ in range(2))
    torch.cuda.synchronize()
    res["launches"] = dict(_build.launches)    # two mesh generations
    res["songs_per_s"] = b / res["mesh_s"]
    timed(one, sizes["b_gen"])
    res["one_card_s"] = min(timed(one, sizes["b_gen"]) for _ in range(2))
    res["one_card_songs_per_s"] = sizes["b_gen"] / res["one_card_s"]
    # this card's generation alone (the fused kernel on its 8 rows under
    # the row map, no gather), by CUDA events
    shard = mesh_mod.shard_of(gen.mesh, b, False, model_sharded=False)
    state = multinn.init_state(gen.params, sizes["b_gen"])

    def rows():
        with torch.inference_mode():
            multinn.generate(gen.params, key, state, sizes["t_gen"],
                             k=gen._gibbs_k, temperature=gen._temperature,
                             shard=shard)
    res["kernel_ms"] = cuda_ms(rows, 2)
    res["ok"] = (res["identical_mine"] >= sizes["b_gen"] - 1
                 and res["launches"].get(f"gen_fused_{fam}") == 2)
    del gen, one
    _free()
    return res


def _service_case(ctx, decoder):
    """A service on data=n: rank 0 takes the requests at batch 8, the other
    ranks follow its broadcast calls."""
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.serving.service import GenerationService, ServeConfig
    sizes, dev, n = ctx["sizes"], ctx["dev"], ctx["world"]
    fam = "rbm" if decoder == "rnn-rbm" else "nade"
    cfg = _cfg(sizes, decoder, dict(data=n), ctx["out"])
    params = multinn.init(cfg.model, torch.Generator().manual_seed(21),
                          device=dev)
    t0 = time.perf_counter()
    svc = GenerationService(cfg, params, ServeConfig(
        batch=sizes["b_gen"], n_steps=sizes["t_gen"], max_wait_ms=1000.0),
        mesh=mesh_mod.make_mesh(cfg.mesh))
    res = dict(case=f"service_{fam}", decoder=decoder, rank=ctx["rank"])
    if ctx["rank"] != 0:
        res.update(calls=svc.follow(), ok=True,
                   seconds=time.perf_counter() - t0)
        return res
    t1 = time.perf_counter()
    futs = svc.submit_many(sizes["requests"])
    rolls = [f.result(300).roll for f in futs]
    sec = time.perf_counter() - t1
    svc.close()
    shape = (sizes["t_gen"], sizes["k"], sizes["d"])
    res.update(answered=len(rolls), seconds=sec,
               songs_per_s=len(rolls) / sec,
               ok=len(rolls) == sizes["requests"]
               and all(r.shape == shape for r in rolls))
    return res


def _rank(rank, world, out, sizes):
    """A spawned rank: join the NCCL world on card ``rank``, run every
    case and write them to ``<out>/rank<rank>.json``."""
    import torch
    import torch.distributed as dist
    from multinn_torch.parallel import mesh as mesh_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    backend = mesh_mod.init_distributed(f"file://{out}/store", world, rank)
    if backend != "nccl":
        raise RuntimeError(f"the world chose {backend}, not nccl")
    ctx = dict(rank=rank, world=world, out=out, sizes=sizes,
               dev=mesh_mod.rank_device(backend))
    _profile(lambda: None, 1, ())              # the profiler's first start
    cases = []
    try:
        for case, dec, mesh, train in layouts(world, sizes):
            cases.append(_layout_case(ctx, case, dec, mesh, train))
        for dec in ("rnn-rbm", "rnn-nade"):
            cases.append(_one_card_case(ctx, dec))
        for dec in ("rnn-rbm", "rnn-nade"):
            cases.append(_generation_case(ctx, dec))
            cases.append(_service_case(ctx, dec))
        dist.barrier()
    finally:
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(dict(backend=backend, device=str(ctx["dev"]),
                           name=torch.cuda.get_device_name(ctx["dev"]),
                           cases=cases), f)
        dist.destroy_process_group()


def run_world(out, world, sizes=SIZES, timeout=1500.0):
    """Spawn ``world`` ranks and wait at most ``timeout`` seconds (every
    rank is killed at the deadline); returns each rank's result."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank, args=(world, out, sizes), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.time() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
            if time.time() >= deadline:
                raise TimeoutError(f"the world of {world} still ran after "
                                   f"{timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    results = []
    for rank in range(world):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            results.append(json.load(f))
    return results


def summarise(ranks) -> list:
    """One line per case: rank 0's numbers, with every rank's step ms,
    first-step and replay results and ok."""
    lines = []
    for i, case in enumerate(ranks[0]["cases"]):
        line = dict(case)
        line.pop("rank", None)
        per = [r["cases"][i] for r in ranks]
        for key in ("graph_ms", "eager_ms", "replay_diff", "worst_over_tol",
                    "nccl_ms", "nccl_share", "identical_mine",
                    "per_card_graph_ms", "global_graph_ms", "songs_per_s",
                    "kernel_ms", "ok"):
            if key in case:
                line[f"{key}_per_rank"] = [c.get(key) for c in per]
        if "nccl_share" in case:
            line["nccl_share_least"] = min(c["nccl_share"] for c in per)
        line["ok"] = all(c.get("ok", True) for c in per)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cards", type=int, default=4,
                   help="ranks, one card each (default 4)")
    p.add_argument("--timeout", type=float, default=1500.0,
                   help="seconds the world may run")
    args = p.parse_args(argv)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < args.cards:
        print(f"mesh_cards: {args.cards} cards asked for, {have} present; "
              f"it runs one rank a card on NCCL and never shares a card",
              file=sys.stderr)
        return 2
    from multinn_torch.ops import _build
    from multinn_torch.parallel import mesh as mesh_mod
    if mesh_mod.choose_backend(args.cards) != "nccl":
        print("mesh_cards: the world would not run on NCCL",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.ops()                 # build once, before the ranks load it
    build_s = time.perf_counter() - t0
    out = tempfile.mkdtemp(prefix="mesh_cards_")
    try:
        ranks = run_world(out, args.cards, timeout=args.timeout)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    gates = {}
    for r, res in enumerate(ranks):
        gates[f"rank{r}_nccl_on_own_card"] = (
            res["backend"] == "nccl" and res["device"] == f"cuda:{r}")
    for line in summarise(ranks):
        print(json.dumps(line), flush=True)
        gates[line["case"]] = line["ok"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"cards: {' | '.join(smi.strip().splitlines())}; build "
          f"{build_s:.1f} s; total {time.perf_counter() - t0:.1f} s",
          flush=True)
    ok = all(gates.values())
    print(json.dumps({"gates": gates, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
