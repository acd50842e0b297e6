"""Meshes with one card per rank: the port's mesh training, generation and
serving on NCCL, each ``steps_per_call`` group captured as one CUDA graph
per rank with its collectives inside, checked against one device and
timed.

    python -m multinn_torch.scripts.mesh_cards --cards 4 [--k 4]
                                     [--timeout 1500] [--only REGEX]

Spawns one process per card (rank r on card r; NCCL through a file store
in a temporary directory) after building the kernels once in this
process. Every rank runs the same cases in the same order, each at the
full widths of the two flagships (feedback, D=84, H=150, U=100,
gen_k=10, T=64) at ``--k`` tracks (5, the flagship's, by default) on
seeded Bernoulli(0.06) rolls, with the per-card batch of phase 13 of
``chip_smoke.py`` on every card (RNN-RBM B=16, RNN-NADE B=64, so the
global batch is the card count times that). ``layouts(n, k)`` gives a
track layout only where its track count divides K, so there are two
sets:

  * K=5 (no track axis): gspmd data=n and shard_map data=n (both
    families); gspmd data=n/2 x model=2 (both, H split over two cards;
    n even); seqpipe seq=n (RNN-NADE, T split, ``auto_microbatches``;
    n >= 2); Hessian-free gspmd data=n (RNN-NADE, cg_iters 25, groups of
    2 macro-steps: two captured macro-steps take about 12 GB of graph
    pool at B=64 a card);
  * the track set, ``--k 4`` (the JAX package's multichip flagship):
    gspmd data=n as the baseline, data=n/2 x track=2, track=n (one track
    a card), data=n/4 x track=2 x model=2 (the K and the H split on the
    same tensors), each for both families; per-track data=n/2 x track=2
    (RNN-RBM); Hessian-free data=n/2 x track=2 (RNN-NADE);
  * for each layout: the first mesh step against the one-device step at
    the same global batch on the rank's card (loss rtol 1e-5, params rtol
    1e-4 / atol 1e-6; shard_map's RBM against the mean of the shards'
    gradients under their folded keys); a group of 24 steps replayed
    against the same group run eagerly on the mesh (params within 1e-6
    max|p| per tensor, each replay's launches 24 times one eager step's,
    the RBM's chain launched once a step per local track); the eager and
    the replayed step ms (CUDA events around groups and replays, /
    steps), frames/s, capture seconds, the graph pool's bytes, and from
    ``torch.profiler`` over three replays the device time a step of the
    NCCL kernels (their share of the step: an upper bound of the
    collectives' cost, since a collective's kernel also waits for the
    slowest rank; the least share over the ranks is printed too) and of
    the family's kernels; then the collectives alone: those an eager step
    ran (recorded), on buffers of their shapes, captured as one graph and
    replayed after a barrier (``coll_ms``, ``coll_share`` of the step);
  * for gspmd data=n, the same replayed step on one card at the per-card
    batch (weak scaling) and at the global batch (strong scaling);
  * K=5: generation on data=n, B=8 a card: at T=16 at least 7 of each
    card's 8 samples bit-identical to one device's generation of the
    whole batch; at T=1024 songs/s against one card at B=8 (the fused
    kernel launched once a card a generation), and the device ms of a
    card's generation of its 8 rows alone (CUDA events); a mesh service
    (batch 8, 1024 steps) answering 24 requests, rank 0 taking them
    while the others ``follow()``;
  * the track set, on data=n/2 x track=2 for both families:
    track-sharded generation (B=8 a data shard; also on track=n, B=8):
    the scan path with the frames all-gathered every step, every sample
    at T=16 bit-identical to one card's scan path, songs/s at T=1024
    beside one card's scan path and fused kernel at B=8, the sampler's
    launches a step (one a local track) and the busy share;
    ``Trainer.evaluate`` with a short tail against one device (every
    metric within rtol 1e-5); a checkpoint saved on the mesh after a
    captured group, restored into one device bit for bit, its next step
    against the mesh's; accompaniment with track 0 given (bit for bit) against one
    card's; a mesh service answering 24 requests.

Prints one JSON line per case (rank 0's numbers, with every rank's step
ms), the card's name and power limit (``nvidia-smi``), then
``{"gates": {...}, "ok": ...}`` last. Exits 1 when a gate fails, 2 when
the host has fewer cards than ``--cards`` (it says so; it never falls
back to gloo or to shared cards).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

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
           "gen_fused_nade": ("gen_fused_nade_kernel",),
           "nade_sample": ("nade_sample_kernel",)}
FAMILY = {"rnn-rbm": ("gibbs_chain",),
          "rnn-nade": ("nade_ll_fwd", "nade_ll_bwd")}
# the scan path's per-step sampler of each family
SAMPLER = {"rnn-rbm": "gibbs_chain", "rnn-nade": "nade_sample"}
# the torch.distributed collectives the port's comm layer calls
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "broadcast")


def layouts(n: int, k: int, sizes=SIZES):
    """(case, decoder, mode, mesh keywords, train keywords) for ``n`` cards
    and ``k`` tracks. A track layout comes only where its track count
    divides ``k``: the flagship's K=5 gives the K=5 set (gspmd and
    shard_map data=n, data=n/2 x model=2, seqpipe seq=n, HF data=n); a K
    that splits over 2 tracks on an even ``n`` gives the track set (gspmd
    data=n, data=n/2 x track=2, track=n where n divides K, data=n/4 x
    track=2 x model=2 where 4 divides n, each for both families; the
    per-track mode on data=n/2 x track=2 for the RBM; HF on data=n/2 x
    track=2)."""
    out = []
    hf = dict(optimizer="hf", hf_cg_iters=sizes["hf_cg"],
              steps_per_call=sizes["hf_spc"])
    if n >= 2 and n % 2 == 0 and k % 2 == 0:
        half = n // 2
        for dec in ("rnn-rbm", "rnn-nade"):
            fam = "rbm" if dec == "rnn-rbm" else "nade"
            out.append((f"gspmd_data{n}_{fam}", dec, "feedback",
                        dict(data=n), {}))
            out.append((f"gspmd_data{half}_track2_{fam}", dec, "feedback",
                        dict(data=half, track=2), {}))
            if n > 2 and k % n == 0:
                out.append((f"gspmd_track{n}_{fam}", dec, "feedback",
                            dict(data=1, track=n), {}))
            if n % 4 == 0:
                out.append((f"gspmd_data{n // 4}_track2_model2_{fam}", dec,
                            "feedback", dict(data=n // 4, track=2, model=2),
                            {}))
        out.append((f"pertrack_data{half}_track2_rbm", "rnn-rbm",
                    "per-track", dict(data=half, track=2), {}))
        out.append((f"hf_gspmd_data{half}_track2_nade", "rnn-nade",
                    "feedback", dict(data=half, track=2), hf))
        return out
    for dec in ("rnn-rbm", "rnn-nade"):
        fam = "rbm" if dec == "rnn-rbm" else "nade"
        out.append((f"gspmd_data{n}_{fam}", dec, "feedback", dict(data=n),
                    {}))
        out.append((f"shard_map_data{n}_{fam}", dec, "feedback",
                    dict(data=n, style="shard_map"), {}))
        if n >= 2 and n % 2 == 0:
            out.append((f"gspmd_data{n // 2}_model2_{fam}", dec, "feedback",
                        dict(data=n // 2, model=2), {}))
    if n >= 2:
        out.append((f"seqpipe_seq{n}_nade", "rnn-nade", "feedback",
                    dict(data=1, seq=n, style="seqpipe"), {}))
    out.append((f"hf_gspmd_data{n}_nade", "rnn-nade", "feedback",
                dict(data=n), hf))
    return out


def track_set(n: int, k: int) -> bool:
    """Whether ``layouts(n, k)`` is the track set."""
    return any(m.get("track", 1) > 1 for _, _, _, m, _ in layouts(n, k))


def _cfg(sizes, decoder, mesh, run_dir, mode="feedback", **train):
    """The validated ExperimentConfig of the flagship's widths at
    ``sizes["k"]`` tracks in ``mode`` on ``mesh`` (MeshConfig keywords;
    None: one device)."""
    from multinn_torch.models import multinn
    from multinn_torch.utils.config import (DataConfig, ExperimentConfig,
                                            MeshConfig, TrainConfig)
    train = dict(dict(steps_per_call=sizes["spc"]), **train)
    model = multinn.MultINNConfig(
        n_tracks=sizes["k"], n_pitches=sizes["d"], mode=mode,
        decoder_type=decoder, n_hidden=sizes["h"], n_rnn=sizes["u"],
        gen_k=10)
    data = DataConfig.from_preset("synthetic", n_tracks=sizes["k"],
                                  pitch_max=23 + sizes["d"],
                                  window=sizes["t"])
    return ExperimentConfig(
        data=data, model=model,
        train=TrainConfig(log_every_steps=10 ** 9, ckpt_every_steps=0,
                          run_dir=run_dir, **train),
        mesh=MeshConfig(use_mesh=mesh is not None, **(mesh or {}))
    ).validate()


class _Rolls:
    """``n`` seeded Bernoulli(0.06) batches (B, T, K, D) behind the Dataset
    interface, the same on every rank; ``tail`` rows more make a short
    last batch where ``drop_remainder`` is off (an evaluation's)."""

    def __init__(self, sizes, batch, n, seed, tail=0):
        rng = np.random.default_rng(seed)
        self.xs = (rng.random((n, batch, sizes["t"], sizes["k"],
                               sizes["d"])) < 0.06).astype(np.uint8)
        self.tail = (rng.random((tail, sizes["t"], sizes["k"], sizes["d"]))
                     < 0.06).astype(np.uint8)

    def n_batches(self, split="train"):
        return len(self.xs)

    def batches(self, split="train", epoch=0, shuffle=True,
                drop_remainder=True, with_masks=False, augment=False):
        tail = [] if drop_remainder or not len(self.tail) else [self.tail]
        for x in [*self.xs, *tail]:
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


class _Buf(collections.namedtuple("_Buf", "shape dtype")):
    """A recorded collective's tensor argument: its shape and dtype."""


@contextlib.contextmanager
def _recording(calls: list):
    """Record every collective (COLLECTIVES) run meanwhile, from any
    thread, into ``calls`` as (name, args with each tensor a _Buf,
    keywords); each still runs."""
    import torch
    import torch.distributed as dist
    real = {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name):
        def call(*args, **kw):
            calls.append((name, [_Buf(tuple(a.shape), a.dtype)
                                 if torch.is_tensor(a) else a for a in args],
                          kw))
            return real[name](*args, **kw)
        return call
    try:
        for name in COLLECTIVES:
            setattr(dist, name, wrap(name))
        yield calls
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def _collectives_alone(calls, reps: int = 5) -> dict:
    """The recorded collectives alone, in their order on their groups, on
    zero buffers of their shapes: run once eagerly, captured as one CUDA
    graph, replayed once, then ``reps`` times after a barrier, by CUDA
    events. Returns the ms a replay, the count and the bytes each rank
    puts in (each call's input tensor)."""
    import torch
    import torch.distributed as dist
    from multinn_torch.utils.profiling import cuda_ms
    dev = torch.device("cuda", torch.cuda.current_device())
    bound = [(getattr(dist, name),
              [torch.zeros(a.shape, dtype=a.dtype, device=dev)
               if isinstance(a, _Buf) else a for a in args], kw)
             for name, args, kw in calls]
    sent = sum(int(np.prod(bufs[-1].shape)) * bufs[-1].element_size()
               for bufs in ([a for a in args if torch.is_tensor(a)]
                            for _, args, _ in bound))

    def run():
        for fn, args, kw in bound:
            fn(*args, **kw)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        run()
    torch.cuda.current_stream(dev).wait_stream(stream)
    torch.cuda.synchronize(dev)
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        run()
    graph.replay()
    torch.cuda.synchronize(dev)
    dist.barrier()
    ms = cuda_ms(graph.replay, reps, warm=False)
    del graph
    return {"coll_ms": ms, "coll_count": len(calls), "coll_bytes": sent}


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


def _layout_case(ctx, case, decoder, mode, mesh, train):
    """One layout: the first step against one device, then the captured
    group against the eager group on the mesh, with their times, and the
    step's collectives alone (recorded from an eager step)."""
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
    cfg = _cfg(sizes, decoder, mesh, run("mesh"), mode, **train)
    params = multinn.init(cfg.model, torch.Generator().manual_seed(15),
                          device=dev)
    key = sampling.PRNGKey(123, device=dev)
    local_k = sizes["k"] // mesh.get("track", 1)
    res = dict(case=case, decoder=decoder, mode=mode, mesh=mesh,
               global_batch=batch, local_tracks=local_k, steps=spc,
               rank=ctx["rank"])

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
        _cfg(sizes, decoder, None, run("one"), mode, **train), src, params,
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
    # the launches and the collectives of one eager step against a replay's
    calls: list = []
    _build.launches.clear()
    with _recording(calls):
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
                for k in fam)
        # the RBM's CD-1 chain: one launch a step per local track
        and (decoder != "rnn-rbm" or per_step.get("gibbs_chain") == local_k))
    res["eager_ms"] = cuda_ms(lambda: eager.run_group(xs, key), 1,
                              warm=False) / spc
    res["graph_ms"] = cuda_ms(lambda: graph.run_group(xs, key), 3) / spc
    res["frames_per_s"] = batch * sizes["t"] / res["graph_ms"] * 1e3
    res.update(_profile(lambda: graph.run_group(xs, key), spc, fam))
    res["nccl_share"] = res["nccl_ms"] / res["graph_ms"]
    res.update(_collectives_alone(calls))
    res["coll_share"] = res["coll_ms"] / res["graph_ms"]
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


def _mesh_name(mesh) -> str:
    return "_".join(f"{axis}{size}" for axis, size in mesh.items())


def _timed(fn) -> float:
    """Host seconds of ``fn``, the card synchronised on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _track_generation_case(ctx, decoder, mesh):
    """Track-sharded generation on ``mesh`` (B=8 a data shard): the scan
    path, each rank sampling its tracks, the frames all-gathered every
    step. At T=16 every sample against one card's scan path at the same
    batch; at T=1024 songs/s beside one card's scan path and one card's
    fused kernel at B=8, the launches a step on this rank, and the busy
    share: the profiler's device ms a step of a T=128 generation over the
    T=1024 generation's host ms a step."""
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.ops import _build, sampling
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.training.generator import Generator
    sizes, dev, rank = ctx["sizes"], ctx["dev"], ctx["rank"]
    fam = "rbm" if decoder == "rnn-rbm" else "nade"
    cfg = _cfg(sizes, decoder, mesh, ctx["out"])
    params = multinn.init(cfg.model, torch.Generator().manual_seed(19),
                          device=dev)
    key = sampling.PRNGKey(5, device=dev)
    b, t_gen = sizes["b_gen"] * mesh.get("data", 1), sizes["t_gen"]
    gen = Generator(cfg, params, mesh=mesh_mod.make_mesh(cfg.mesh))
    one = Generator(_cfg(sizes, decoder, None, ctx["out"]), params)

    def scan(batch, n_steps):
        with torch.inference_mode():
            _, roll = multinn.generate(params, key,
                                       multinn.init_state(params, batch),
                                       n_steps, fused=False)
        return roll.to(torch.uint8).cpu().numpy()
    roll = gen.generate(key, n_steps=sizes["t_check"], batch=b)
    same = (roll == scan(b, sizes["t_check"])).reshape(b, -1).all(axis=1)
    res = dict(case=f"gen_{_mesh_name(mesh)}_{fam}", decoder=decoder,
               mesh=mesh, rank=rank, batch=b, t=t_gen,
               local_tracks=int(gen.params.decoder.w.shape[0]),
               identical=int(same.sum()), of=b, density=float(roll.mean()))
    mesh_gen = lambda: gen.generate(key, n_steps=t_gen, batch=b)
    _timed(mesh_gen)                           # warm at T=1024
    _build.launches.clear()
    res["mesh_s"] = min(_timed(mesh_gen) for _ in range(2))
    res["launches_per_step"] = {k: v / (2 * t_gen)
                                for k, v in _build.launches.items()}
    res["songs_per_s"] = b / res["mesh_s"]
    res["one_card_scan_s"] = min(_timed(lambda: scan(sizes["b_gen"], t_gen))
                                 for _ in range(2))
    res["one_card_scan_songs_per_s"] = (sizes["b_gen"]
                                        / res["one_card_scan_s"])
    fused = lambda: one.generate(key, n_steps=t_gen, batch=sizes["b_gen"])
    _timed(fused)
    res["one_card_fused_s"] = min(_timed(fused) for _ in range(2))
    res["one_card_fused_songs_per_s"] = (sizes["b_gen"]
                                         / res["one_card_fused_s"])
    t_prof = 128
    prof = _profile(lambda: gen.generate(key, n_steps=t_prof, batch=b),
                    t_prof, (SAMPLER[decoder],), reps=1)
    host_ms = res["mesh_s"] * 1e3 / t_gen
    res.update(busy_ms_per_step=prof["busy_ms"],
               nccl_ms_per_step=prof["nccl_ms"],
               sampler_ms_per_step=prof["kernels_ms"][SAMPLER[decoder]],
               host_ms_per_step=host_ms,
               busy_share=prof["busy_ms"] / host_ms)
    res["ok"] = bool(res["identical"] == b and res["launches_per_step"].get(
        SAMPLER[decoder]) == res["local_tracks"])
    del gen, one
    _free()
    return res


def _eval_case(ctx, decoder, mesh):
    """``Trainer.evaluate("valid")`` on ``mesh`` against one device's from
    the same params on two seeded batches of the global batch and a short
    tail of 3 rows (run whole on every rank): every metric within rtol
    1e-5 (atol 1e-7) of one device's — the NADE's exact log-likelihood,
    the ratios of the whole batch's counts and the RBM's sampled
    monitors."""
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.training.trainer import Trainer
    sizes, dev, n = ctx["sizes"], ctx["dev"], ctx["world"]
    fam = "rbm" if decoder == "rnn-rbm" else "nade"
    batch = sizes[f"b_{fam}"] * n
    src = _Rolls(sizes, batch, 2, seed=17, tail=3)
    run = lambda name: os.path.join(ctx["out"], f"eval_{fam}_{name}_"
                                                f"{ctx['rank']}")
    cfg = _cfg(sizes, decoder, mesh, run("mesh"))
    params = multinn.init(cfg.model, torch.Generator().manual_seed(23),
                          device=dev)
    t = Trainer(cfg, src, params=params)
    got = t.evaluate("valid")
    t.close()
    ref = Trainer(_cfg(sizes, decoder, None, run("one")), src, params=params)
    want = ref.evaluate("valid")
    ref.close()
    over = {k: abs(got[k] - want[k]) / (1e-7 + 1e-5 * abs(want[k]))
            for k in want if k in got}
    res = dict(case=f"eval_{_mesh_name(mesh)}_{fam}", decoder=decoder,
               mesh=mesh, rank=ctx["rank"], global_batch=batch, tail=3,
               metrics=got, ref_metrics=want, over_tol=over,
               worst_over_tol=max(over.values()))
    res["ok"] = bool(set(got) == set(want)
                     and all(np.isfinite(v) for v in got.values())
                     and res["worst_over_tol"] <= 1.0)
    _free()
    return res


def _ckpt_case(ctx, decoder, mesh):
    """One artifact, any topology: a captured group of 4 steps on
    ``mesh``, ``save_checkpoint`` (every rank gathers, rank 0 writes),
    then on rank 0 a one-device Trainer's ``maybe_resume``: its params and
    optimizer state bit-equal to the mesh's gathered state, and its next
    step against the mesh's next step (loss rtol 1e-5, params rtol 1e-4 /
    atol 1e-6)."""
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.ops import sampling
    from multinn_torch.training.trainer import Trainer
    sizes, dev, n, rank = ctx["sizes"], ctx["dev"], ctx["world"], ctx["rank"]
    fam = "rbm" if decoder == "rnn-rbm" else "nade"
    batch, spc = sizes[f"b_{fam}"] * n, 4
    src = _Rolls(sizes, batch, spc + 1, seed=29)
    run = os.path.join(ctx["out"], f"ckpt_{fam}")       # one for the ranks
    cfg = _cfg(sizes, decoder, mesh, run, steps_per_call=spc)
    params = multinn.init(cfg.model, torch.Generator().manual_seed(27),
                          device=dev)
    t = Trainer(cfg, src, params=params)
    t.run_group(src.xs[:spc], sampling.PRNGKey(31, device=dev))
    t.step = spc
    t.save_checkpoint()
    full = [v.detach().clone() for v in t._full_state()]
    res = dict(case=f"ckpt_{_mesh_name(mesh)}_{fam}", decoder=decoder,
               mesh=mesh, rank=rank, captured=t.group_graph is not None,
               state_tensors=len(full))
    one = None
    if rank == 0:
        one = Trainer(_cfg(sizes, decoder, None, run, steps_per_call=spc),
                      src, params=params)
        res["resumed"] = bool(one.maybe_resume())
        res["bit_equal"] = all(torch.equal(a, b) for a, b in
                               zip(one._state_tensors(), full))
    key = sampling.PRNGKey(37, device=dev)
    loss = float(t.train_step(t._put_batch(src.xs[spc]), key)["loss"])
    got = [p.detach().clone() for p in multinn.tree_leaves(t.full_params())]
    res["loss"] = loss
    res["ok"] = bool(res["captured"] and np.isfinite(loss))
    if one is not None:
        ref_loss = float(one.train_step(one._put_batch(src.xs[spc]),
                                        key)["loss"])
        want = multinn.tree_leaves(one.params)
        worst = max(float(((a - b).abs() / (1e-6 + 1e-4 * b.abs())).max())
                    for a, b in zip(got, want))
        res.update(ref_loss=ref_loss, worst_over_tol=worst,
                   next_step_ok=bool(abs(loss - ref_loss)
                                     <= 1e-5 * abs(ref_loss)
                                     and worst <= 1.0))
        res["ok"] = bool(res["ok"] and res["resumed"] and res["bit_equal"]
                         and res["next_step_ok"])
        one.close()
    t.close()
    del t, one, full, got
    _free()
    return res


def _accompany_case(ctx, decoder, mesh):
    """Accompaniment on ``mesh``, track 0 given (B=8, T=1024; the whole
    batch on every rank): the given track bit for bit, the roll equal to
    one card's under the same key."""
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.ops import _build, sampling
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.training.generator import Generator
    sizes, dev = ctx["sizes"], ctx["dev"]
    fam = "rbm" if decoder == "rnn-rbm" else "nade"
    cfg = _cfg(sizes, decoder, mesh, ctx["out"])
    params = multinn.init(cfg.model, torch.Generator().manual_seed(33),
                          device=dev)
    rng = np.random.default_rng(35)
    given = (rng.random((sizes["b_gen"], sizes["t_gen"], sizes["k"],
                         sizes["d"])) < 0.06).astype(np.float32)
    key = sampling.PRNGKey(39, device=dev)
    gen = Generator(cfg, params, mesh=mesh_mod.make_mesh(cfg.mesh))
    _build.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = gen.accompany(key, given, (0,))
    sec = time.perf_counter() - t0
    launches = dict(_build.launches)
    want = Generator(_cfg(sizes, decoder, None, ctx["out"]),
                     params).accompany(key, given, (0,))
    res = dict(case=f"accompany_{_mesh_name(mesh)}_{fam}", decoder=decoder,
               mesh=mesh, rank=ctx["rank"], batch=sizes["b_gen"],
               t=sizes["t_gen"], seconds=sec, launches=launches,
               given_exact=bool((got[:, :, 0] == given[:, :, 0]).all()),
               identical=int((got == want).reshape(len(got), -1).all(
                   axis=1).sum()), of=len(got),
               density=float(got[:, :, 1:].mean()))
    res["ok"] = res["given_exact"] and res["identical"] == res["of"]
    del gen
    _free()
    return res


def _service_case(ctx, decoder, mesh, name):
    """A service on ``mesh``: rank 0 takes the requests at batch 8, the
    other ranks follow its broadcast calls."""
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.serving.service import GenerationService, ServeConfig
    sizes, dev = ctx["sizes"], ctx["dev"]
    cfg = _cfg(sizes, decoder, mesh, ctx["out"])
    params = multinn.init(cfg.model, torch.Generator().manual_seed(21),
                          device=dev)
    t0 = time.perf_counter()
    svc = GenerationService(cfg, params, ServeConfig(
        batch=sizes["b_gen"], n_steps=sizes["t_gen"], max_wait_ms=1000.0),
        mesh=mesh_mod.make_mesh(cfg.mesh))
    res = dict(case=name, decoder=decoder, mesh=mesh, rank=ctx["rank"])
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


def plan(world: int, sizes=SIZES) -> list:
    """(name, run) of every case of the set of ``world`` cards at
    ``sizes["k"]`` tracks, in order; ``run(ctx)`` returns the case."""
    k = sizes["k"]
    out = [(case, functools.partial(_layout_case, case=case, decoder=dec,
                                    mode=mode, mesh=mesh, train=train))
           for case, dec, mode, mesh, train in layouts(world, k, sizes)]
    for dec in ("rnn-rbm", "rnn-nade"):
        fam = "rbm" if dec == "rnn-rbm" else "nade"
        out.append((f"one_card_{fam}",
                    functools.partial(_one_card_case, decoder=dec)))
    for dec in ("rnn-rbm", "rnn-nade"):
        fam = "rbm" if dec == "rnn-rbm" else "nade"
        if not track_set(world, k):
            data = dict(data=world)
            out += [(f"gen_{fam}",
                     functools.partial(_generation_case, decoder=dec)),
                    (f"service_{fam}",
                     functools.partial(_service_case, decoder=dec,
                                       mesh=data, name=f"service_{fam}"))]
            continue
        meshes = [dict(data=world // 2, track=2)]
        if world > 2 and k % world == 0:
            meshes.append(dict(data=1, track=world))
        out += [(f"gen_{_mesh_name(m)}_{fam}",
                 functools.partial(_track_generation_case, decoder=dec,
                                   mesh=m)) for m in meshes]
        dp_track, name = meshes[0], _mesh_name(meshes[0])
        out += [(f"eval_{name}_{fam}",
                 functools.partial(_eval_case, decoder=dec, mesh=dp_track)),
                (f"ckpt_{name}_{fam}",
                 functools.partial(_ckpt_case, decoder=dec, mesh=dp_track)),
                (f"accompany_{name}_{fam}",
                 functools.partial(_accompany_case, decoder=dec,
                                   mesh=dp_track)),
                (f"service_{name}_{fam}",
                 functools.partial(_service_case, decoder=dec, mesh=dp_track,
                                   name=f"service_{name}_{fam}"))]
    return out


def run_cases(ctx):
    """The cases of ``plan`` whose names match ``ctx["only"]`` (a regular
    expression; None: every case), in order, each yielded as it ends with
    its wall ``seconds`` (every rank of the world runs these)."""
    for name, run in plan(ctx["world"], ctx["sizes"]):
        if ctx.get("only") and not re.search(ctx["only"], name):
            continue
        t0 = time.perf_counter()
        res = run(ctx)
        res.setdefault("wall_s", time.perf_counter() - t0)
        yield res


def _rank(rank, world, out, sizes, only=None):
    """A spawned rank: join the NCCL world on card ``rank``, run the cases
    (``run_cases``) and write them to ``<out>/rank<rank>.json``."""
    import torch
    import torch.distributed as dist
    from multinn_torch.parallel import mesh as mesh_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    backend = mesh_mod.init_distributed(f"file://{out}/store", world, rank)
    if backend != "nccl":
        raise RuntimeError(f"the world chose {backend}, not nccl")
    ctx = dict(rank=rank, world=world, out=out, sizes=sizes, only=only,
               dev=mesh_mod.rank_device(backend))
    _profile(lambda: None, 1, ())              # the profiler's first start
    cases: list = []

    def write(error=None):
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(dict(backend=backend, device=str(ctx["dev"]),
                           name=torch.cuda.get_device_name(ctx["dev"]),
                           cases=cases, error=error), f)
    try:
        for case in run_cases(ctx):
            cases.append(case)
            write()                # what a deadline leaves is kept
        dist.barrier()
    except BaseException:
        write(traceback.format_exc())
        # a rank that failed inside a collective or a capture can hang in
        # destroy_process_group: leave at once, so the world fails now and
        # not at its deadline
        os._exit(1)
    write()
    dist.destroy_process_group()


def run_world(out, world, sizes=SIZES, timeout=1500.0, target=None,
              only=None):
    """Spawn ``world`` ranks of ``target`` (``_rank``; a test passes a
    stand-in) and wait at most ``timeout`` seconds; every rank is killed
    at the deadline or as soon as one fails. Returns each rank's result
    (the cases it finished, and its traceback if it failed; an empty one
    for a rank that wrote none) and the error, or None."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(target or _rank,
                             args=(world, out, sizes, only),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.time() + timeout
    error = None
    try:
        while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
            if time.time() >= deadline:
                raise TimeoutError(f"the world of {world} still ran after "
                                   f"{timeout} s")
    except Exception as e:            # a rank failed, or the deadline
        error = f"{type(e).__name__}: {e}"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    results = []
    for rank in range(world):
        path = os.path.join(out, f"rank{rank}.json")
        if os.path.exists(path):
            with open(path) as f:
                results.append(json.load(f))
        else:
            results.append(dict(backend=None, device=None, cases=[],
                                error="wrote no result"))
    return results, error


def summarise(ranks) -> list:
    """One line per case: rank 0's numbers, with every rank's step ms,
    first-step and replay results and ok."""
    lines = []
    n = min(len(r["cases"]) for r in ranks)
    for i, case in enumerate(ranks[0]["cases"][:n]):
        line = dict(case)
        line.pop("rank", None)
        per = [r["cases"][i] for r in ranks]
        for key in ("graph_ms", "eager_ms", "replay_diff", "worst_over_tol",
                    "nccl_ms", "nccl_share", "coll_ms", "coll_share",
                    "identical_mine", "identical", "per_card_graph_ms",
                    "global_graph_ms", "songs_per_s", "kernel_ms",
                    "busy_share", "wall_s", "given_exact", "ok"):
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
    p.add_argument("--k", type=int, default=SIZES["k"],
                   help="tracks (default 5, the flagship's, which no track "
                        "axis splits; 4: the track set)")
    p.add_argument("--timeout", type=float, default=1500.0,
                   help="seconds the world may run")
    p.add_argument("--only", default=None, metavar="REGEX",
                   help="run only the cases whose names match (a partial "
                        "run: its gates are those cases'; default every "
                        "case)")
    args = p.parse_args(argv)
    sizes = dict(SIZES, k=args.k)
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
        ranks, error = run_world(out, args.cards, sizes,
                                 timeout=args.timeout, only=args.only)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    gates = {"world_ended": error is None}
    if error is not None:
        print(f"mesh_cards: {error}", file=sys.stderr)
    for r, res in enumerate(ranks):
        gates[f"rank{r}_nccl_on_own_card"] = (
            res["backend"] == "nccl" and res["device"] == f"cuda:{r}")
        if res.get("error"):
            print(f"mesh_cards: rank {r} failed after "
                  f"{len(res['cases'])} cases:\n{res['error']}",
                  file=sys.stderr)
    for line in summarise(ranks):
        print(json.dumps(line), flush=True)
        gates[line["case"]] = line["ok"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"cards: {' | '.join(smi.strip().splitlines())}; K={args.k} "
          f"({'track' if track_set(args.cards, args.k) else 'K=5'} set"
          f"{'' if args.only is None else f', cases matching {args.only!r}'}"
          f"); build "
          f"{build_s:.1f} s; total {time.perf_counter() - t0:.1f} s",
          flush=True)
    ok = all(gates.values())
    print(json.dumps({"gates": gates, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
