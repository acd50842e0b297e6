#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``multinn_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multinn_torch/csrc`` and runs
twenty phases, one line each or a few; any failure exits non-zero
before the result line. Phases 4-6 drive the RNN-RBM serving path, 7-9 the
RNN-NADE serving path, 10-12 training (the NADE likelihood kernels, then
the Trainer on each family), 13 the train entry point with its steps
captured as CUDA graphs, 14 the two DBN configs, 15 accompaniment, 16 the
generate, evaluate and serve entry points, image summaries and the sparse
transport, 17 joint (composer) mode, Hessian-free training and the bf16
matmul policy, 18 process meshes, 19 the port's scripts
(``multinn_torch/scripts``), 20 the fused kernels' bf16 capacity modes. The roofline (``bound`` and each kernel's
``*_work``), the FLOP counts and the CUDA-event timers are
``multinn_torch.utils.flops`` and ``multinn_torch.utils.profiling``.

  1. environment: card, power limit, torch / CUDA versions, nvcc, ninja;
  2. build: seconds to build and load the kernels;
  3. Threefry: the kernel's stream bit-equal to its plain version on
     (4096, 750) for three seed/salt pairs, and at the main path's shape;
  4. Gibbs chain: kernel vs plain version (same inputs, on the card) at
     N=1040, D=84, H=150, k=25 and at the flagship's sweeps/s shape, N=4096,
     k=25 (``bench.py``'s GIBBS) — at most 1% of rows may differ (a row
     differs only after a last-ulp difference in a probability flips a
     draw) — and at the scan path's shape; at N=4096 the kernel and plain
     ms, sweeps/s (N k / time) and the bound;
  5. fused RBM generation at the flagship widths from primed states:
     B=8, T=16 with at least 7 of 8 samples identical (final h within
     1e-4 on those), then T=1024 with per-track note density within 0.01;
     B=256 (several samples per cluster), T=16 with at least 254 of 256
     samples identical (final h within 1e-4); K=4 (a cluster of four
     CTAs, one track slot each: the four-track flagship of
     ``multinn_torch.scripts.mesh_cards --k 4``), B=8, T=16 with at least
     7 of 8 identical; then the batch sweep B in
     {1, 8, 64, 256} at T=1024 on the flagship with seeded random params:
     ms per song, us per step, the bound (the work this run's rolls need,
     at the card's peak rates), the roofline share and the weights'
     storage, which the reference's rule sets per batch (bf16 at B=64);
  6. the slice: GenerationService(batch=8, n_steps=1024, seed_steps=64) on
     the flagship config with seeded random params serves 16 plain and 8
     seeded requests, then the scan branch of ``multinn.generate`` runs 16
     steps. Launch counts are reset right before and read right after;
     every kernel must have launched. Prints latency p50, songs/s and the
     B=8 64-bar generation time of the kernel (the sweep's) and of its
     plain version;
  7. NADE sampler: kernel vs plain version at D=84, H=150 for one track's
     8 rows (the scan branch's shape) — at most 1 of 8 rows may differ;
  8. fused NADE generation as phase 5 (B=8 and B=256 at T=16, density at
     T=1024, at the kernel's auto speculative depth; K=4 at B=8, T=16)
     and the batch sweep,
     on the NADE flagship; then the kernel at the speculative depths 1, 2
     and 4 and the auto depth at B=1, 8, 32 and 256, T=1024: roll, h and
     c bit-identical to depth 1's at every depth, the ms per song of each
     depth (CUDA events) and the depth the auto rule picks; the same at
     B=1 and 8 with the visible bias lowered by 3 (music's density);
  9. the NADE slice: as phase 6 on the NADE flagship config (the fused
     NADE kernel serves at its auto depth, printed; a 16-step
     ``fused=False`` generation runs the sampler kernel), with its own
     launch counts, reset right before and read right after;
 10. NADE likelihood kernels at the training shape (K=5 tracks x N=4096
     rows, D=84, H=150, per-row biases): forward logits within 1e-4 of the
     plain version, every backward output (dW, dV, dx, dbh; dbv through the
     autograd Function) within 1e-4 * max|ref| + 1e-5; times of the
     kernels, the plain versions and the cumsum form's autograd step;
 11. RBM training: ``Trainer`` on the flagship, B=16, T=64, 20 Adam steps
     (one detailed) and one ``evaluate`` over a masked split, with the
     launch counts reset right before (the Gibbs chain must launch at least
     100 times: 5 tracks x 20 steps); finite loss and grad_norm, every
     parameter moved; one CD-1 chain at N=1024 vs plain (at most 1% of rows
     differ); warm step time, frames/s and the device-busy share;
 12. NADE training: ``Trainer`` on the NADE flagship, B=64, T=64, 20 steps
     on one fixed batch: its NLL falls, both likelihood kernels launch at
     least 20 times in the window, one step's gradients through the
     kernels equal the plain versions' within phase 10's tolerance; step
     time, frames/s and the device-busy share;
 13. the train entry point: for each family (RBM B=16, NADE B=64, T=64)
     one group of 24 steps eagerly and by CUDA-graph replay from the same
     params, optimizer state and key, the params within 1e-6 max|p| per
     leaf; a replay adds the launches its capture recorded, 24 times one
     eager step's for the family's kernels; graph and eager step ms (CUDA
     events), frames/s, the device-busy share (profiler), capture seconds
     and the graph pool's bytes. Then ``multinn_torch.train.main`` on
     ``configs/synthetic_smoke.json`` at the flagship widths (H=150, U=100,
     T=64, B=16, steps_per_call=24, 2 epochs, periodic saves every 24
     steps, keep_last=1) in a temporary run dir, with its own launch
     window (the chain at least once a step): it writes config.json,
     metrics.jsonl, TensorBoard events and checkpoints that follow the
     retention policy (the last plus the best); a run of epoch 1, resumed
     by a second call into epoch 2, ends with the uninterrupted run's
     params within 1e-6 max|p|.
 14. DBN encoders at the published widths (K=5, D=84 -> 64 latents,
     H=150, U=100, T=64, B=16): the pre-training chains, kernel vs plain
     version with at most 1% of rows differing, at the shared encoder's
     N = K*B*T = 5120 rows (D=84, H=64, k=1), at each track's 1024 rows on
     its own key, and at the upper layer of a two-layer DBN (64 -> 32),
     whose visible units are real sigmoid values (the same 1% gate). Then
     for ``configs/lpd5_feedback_rnnnade.json`` and
     ``configs/lpd5_multinn_rnnrbm.json`` on the synthetic source:
     ``pretrain_encoders`` (the configs' two epochs, its own launch
     window: the CD loss,
     the decode calibration within 0.5-2x, seconds); a group of 24 steps
     by replay against eager from the pre-trained params (params within
     1e-6 max|p|, the encoder bit-identical; step ms, frames/s, device
     busy); the family's fused kernel at D=64 against its plain version
     (T=16 B=8, at least 7 of 8 samples identical; latent density gap at
     most 0.01 at T=1024 B=8 for the NADE, at T=128 B=64 for the RBM,
     whose plain version at gen_k=25 takes about 0.14 s a step); the
     kernel's B=8 time and bound, the 64-bar latency at B=1 with the
     decode; a service at batch 8 (16 plain, 8 seeded requests, its own
     launch window): songs/s, p50 / p95;
 15. accompaniment, given track 0 (drums) of synthetic songs, on the RBM
     and NADE flagships (pass-through encoder) and the DBN NADE config
     (pre-trained in phase 14): the fused path against its plain version
     at T=16 B=8 (given tracks bit-equal, at least 7 of 8 samples
     identical), against the scan path at T=1024 B=8 (per-track density
     gap at most 0.01), the fused time; a service with
     ``accompany_tracks=(0,)`` answering 16 accompaniment and 8 plain
     requests at batch 8, the given track passed through bit for bit,
     songs/s and p50 / p95; each config's launch window.
 16. the entry points, each in a launch window of its own: a NADE run of
     20 steps at the flagship widths (``configs/synthetic_smoke.json``)
     with ``train.image_summaries``: its TensorBoard file holds
     valid/reference, equal to ``render_pianoroll`` of the first
     validation window, and valid/sample, a render in the track palette,
     and the summary launched the sampler at least once a step;
     ``multinn_torch.generate.main`` on phase 13's RBM run and on the NADE
     run (8 songs of 1024 steps): 8 MIDI files, 8 PNGs and an npz of
     (8, 1024, 5, 84) bit-equal to ``Generator.generate`` then
     ``finalize`` under ``PRNGKey(seed + 7)`` in this process, the fused
     kernel launched, and the seconds of restore, generate and file
     output; ``--accompany`` of a MIDI file the CLI wrote, its drum track
     passed through bit for bit; ``multinn_torch.evaluate.main`` on both
     runs (valid split, 32 songs): the reference's report keys, ``frame``
     within 1e-6 (relative) of ``Trainer.evaluate``, the chain (RBM) or
     the likelihood forward (NADE) and the fused kernel launched;
     ``multinn_torch.serve.serve`` on the RBM run (batch 8): /healthz, 64
     songs over HTTP as 8 concurrent requests of n=8 ``roll_packed``,
     one midi, one ``seed_b64`` and one ``given_b64`` request (the given
     track back bit for bit), /stats, a clean shutdown; HTTP songs/s
     (64 over first request to last response) and p50 / p95 beside phase
     6's; then the drain (dispatch to host roll, and the fetch after the
     event) of the packed and the sparse transport at B=8 and B=128,
     T=1024, on phase 5's params and on those params with the visible
     bias lowered by 4.5 (about 1 % of cells on, the density the sparse
     records are for), bit-equal rolls, and what ``auto`` resolves to.
 17. joint mode, HF and bf16, at the flagship widths with seeded random
     weights, each path in a launch window of its own: the kernels at the
     joint shapes against their plain versions (the Gibbs chain at N=1024,
     D=420, H=150 in its device-memory plan, at most 1 % of rows
     differing; the sampler on 8 rows of D=420, at most 1 differing; the
     likelihood pair at K=1, N=4096, D=420 to phase 10's tolerances),
     with times and bounds; for each family the joint flagship (K=5 x
     D=84 -> one track of 420 pitches, H=150, U=100, gen_k=10): the gate
     admits B=1 and B=8, the fused kernel against its plain version at
     T=16 B=8 (at least 7 of 8 samples identical), against the scan path
     at T=1024 B=8 (per-track density gap at most 0.01), the kernel's B=8
     time and bound, the B=1 64-bar latency and a service at batch 8; the
     joint NADE kernel at depths 1, 2 and 4 at B=1 and 8, as phase 8;
     captured groups of 24 joint steps against eager (RBM B=16, NADE
     B=64, T=64, as phase 13); ``multinn_torch.train`` then ``generate``
     with ``--model.mode=composer``; Hessian-free training on the NADE
     flagship (B=64, T=64, cg_iters=25) on one fixed batch: the NLL falls
     over an eager group of 2 macro-steps with at least one accepted, the
     same group captured and replayed (params within 1e-6 max|p|), macro-step
     ms, the CG share (CUDA events around replays of the group with
     cg_iters=25 and 0), the graph pool's bytes; ``train
     --train.optimizer=hf`` and ``train --model.matmul_dtype=bf16`` at
     H=150 U=100, B=64 T=64 on the synthetic source, each in a window of
     its own; the bf16 policy on both flagships: a captured group against
     eager that must end away from phase 13's f32 group from the same
     start, its step and kernel time beside phase 13's f32 ones, and 20
     steps whose loss differs from the f32 run's but stays within
     |l16 - l32| < 0.05 (|l32| + 1).
 18. process meshes (multinn_torch/parallel) at the flagship widths, a
     correctness run: the ranks are spawned processes on this one card
     (gloo, CUDA tensors staged through pinned host memory; NCCL refuses
     two ranks on one device), its seconds no scaling number. A world of
     2 ranks: one train step each of gspmd data=2 (both families),
     shard_map (NADE), TP model=2 (H 150 -> 75, both families), seqpipe
     seq=2 (T 64 -> 32, NADE) and a Hessian-free shard_map macro-step
     (NADE, cg_iters=5), each held by rank 0 against the single-device
     step on the card (loss rtol 1e-5, params rtol 1e-4 / atol 1e-6);
     batch-sharded generation of both families (B=8, T=1024, the fused
     kernels' row map) against the single-device roll, at least 7 of 8
     samples bit-identical; a 2-rank service answering 16 requests. A
     world of 5 ranks: the feedback track=5 step of both families and
     track-sharded scan generation (B=8, T=64) against the single-device
     scan path, 8 of 8 identical. A world of one NCCL rank: an all-reduce
     and a broadcast through NCCL and a gspmd data=1 step bit-equal to
     the step without a mesh; a gspmd data=1 Trainer on NCCL captures its
     group of 24 NADE steps (B=64, T=64): the replayed group against the
     eager one, params within 1e-6 max|p|, each replay's launches 24
     times one eager step's (the capture path of a mesh; every group of
     one rank is the identity, so no NCCL collective runs inside the
     graph: ``multinn_torch.scripts.mesh_cards`` runs those on one card a
     rank). Every rank's launch window must show the
     kernels its path runs; each rank's launches, the backend and the
     seconds are printed.
 19. the port's scripts at the flagship widths, each in a launch window of
     its own, each run's JSON on a line of its own: ``prepare_dataset
     synth`` (8 songs) -> ``cachedir`` -> ``multinn_torch.train
     --data.source=cache_dir`` (one replayed group over the cache's
     batches of 8; the chain at least once a step per track, finite
     losses) -> ``stats``; ``serve_loadtest`` at batch 8, 1024 steps a
     song, on the RBM flagship direct (256 requests, 32 clients),
     ``--open-loop`` (512) and ``--http`` (64, 8 clients), and on the NADE
     flagship direct (256, 32): every request answered, no service error,
     the family's fused kernel launched; ``scale_stress`` at H=1024,
     U=512, B=256, T=64, 10 steps a replayed group, in f32 and in bf16
     (step ms, frames/s, model GFLOP a step, MFU against the H100 peak of
     the precision that ran, the Gibbs plan, capture seconds; a finite
     loss), then the Gibbs chain at its N = B*T = 16384 rows, D=84,
     H=1024, k=1 (W in device memory) against its plain version, at most
     1 % of rows differing, with the kernel and plain ms and the bound;
     ``ingest_bench --files 1000 --python-files 50``;
     ``real_corpus_drill --synthetic-standin`` for jsb (RNN-RBM) and
     nottingham (RNN-NADE) at their shipped configs, cut to one epoch of
     the stand-in in batches of 8 with no periodic checkpoints: a finite
     ll/frame, evaluated after at least one step.
 20. the fused kernels' bf16 capacity modes (``generate_rbm(wdtype=)``,
     ``generate_nade(aux_dtype=)``), with seeded weights at phase 5's
     w_std and bias ramp: the Lakh config (``configs/lakh_16th_128bar.json``:
     H=200, U=150, gen_k=25), whose storage rule must pick bf16 at its 4
     samples and whose ``wdtype=None`` launch must equal the bf16 one; its
     kernel against the plain version in bf16 at T=16, B=8 (at least 7 of
     8 samples identical, h within 1e-4 on those, both timed); its
     per-track density in bf16 and f32 at T=1024, B=8 (gap at most 0.13,
     the reference's bound for the modes); its kernel in both modes at
     B=4, T=2048. The flagship RBM checked so at B=32 and timed in both
     modes at B=32 and 128, T=1024; the NADE flagship checked at B=64 and
     timed in both modes there at the auto depth. Each timing prints the
     bound and the plan's shared-memory matrices and most samples a CTA.

Then the total wall time, one JSON line with each kernel's launches (from
its path's window plus the windows of phases 14 to 20, phase 18's summed
over its ranks), error, times and bound. ``ms`` is the device time per
call of the kernel's wrapper (its launches and any small PyTorch kernel it
runs, such as the key's two words, the backward's second pass included):
calls captured in one CUDA graph and its replay timed by CUDA events, since
a short kernel finishes before Python has issued the next call and events
around back-to-back calls would time the host; the fused kernels, at B=8
(the service's batch), take tens of ms, and their ``ms`` is the sweep's
CUDA-event time. ``plain_ms`` is the plain version's
CUDA-event time. ``bound_ms`` is the larger of the bytes the kernel must
move at 3.35 TB/s and the operations this run's inputs need at 67 TFLOP/s,
the H100 SXM's f32 rate outside the tensor cores (Threefry's 32-bit integer
operations, about 80 a draw, counted at the same rate); work that depends
on draws the kernel does not show, the RBM's visible passes, is left out,
so the bound stays a lower bound; ``library_ms`` is null: no single
PyTorch call computes any of these functions. Then the ``nvidia-smi``
name/power-limit line, and the result line
``{"ok": true, "device": {...}}``. The check needs a CUDA device: without
one it exits 1 and prints no result.
"""

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

from multinn_torch.utils.flops import (bound, fused_work, gibbs_work, mfu,
                                       nade_ll_bwd_work, nade_ll_fwd_work,
                                       nade_sample_work, peak_for,
                                       threefry_work, train_step_flops)
from multinn_torch.utils.profiling import cuda_ms, graph_ms

FLAGSHIP = dict(n_tracks=5, n_pitches=84, mode="feedback",
                decoder_type="rnn-rbm", n_hidden=150, n_rnn=100, cd_k=1,
                gen_k=10)
NADE_FLAGSHIP = dict(FLAGSHIP, decoder_type="rnn-nade")
SWEEP_BATCHES = (1, 8, 64, 256)
def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(line: str) -> None:
    print(line, flush=True)


# -- phase 18: process meshes (module level: spawned ranks import these) ----

# the flagship at its full widths; the windows and batches of phases 11-13
MESH_SIZES = dict(k=5, d=84, h=150, u=100, t=64, b_rbm=16, b_nade=64,
                  t_gen=1024, b_gen=8, t_scan=64)


def _mesh_cfg(sizes, decoder, mesh=None, **train):
    """An ExperimentConfig of the flagship (feedback) at ``sizes`` on
    ``mesh`` (MeshConfig keywords; None: one device)."""
    from multinn_torch.models import multinn
    from multinn_torch.utils.config import (ExperimentConfig, MeshConfig,
                                            TrainConfig)
    model = multinn.MultINNConfig(
        n_tracks=sizes["k"], n_pitches=sizes["d"], mode="feedback",
        decoder_type=decoder, n_hidden=sizes["h"], n_rnn=sizes["u"],
        gen_k=10)
    return ExperimentConfig(
        model=model, train=TrainConfig(log_every_steps=1000, **train),
        mesh=MeshConfig(use_mesh=mesh is not None, **(mesh or {})))


class _FixedRolls:
    """One seeded Bernoulli(0.06) batch (B, T, K, D) behind the Dataset
    interface, the same on every rank."""

    def __init__(self, sizes, batch, seed):
        import numpy as np
        rng = np.random.default_rng(seed)
        self.x = (rng.random((batch, sizes["t"], sizes["k"], sizes["d"]))
                  < 0.06).astype(np.uint8)

    def n_batches(self, split="train"):
        return 1

    def batches(self, split="train", epoch=0, shuffle=True,
                drop_remainder=True, with_masks=False, augment=False):
        import numpy as np
        yield ((self.x, np.ones(self.x.shape[:2], np.uint8)) if with_masks
               else self.x)


def _mesh_step(ctx, name, decoder, mesh, **train):
    """One train step of the flagship on ``mesh`` (this rank's part), with
    the launches of its window; rank 0 then runs the same step on one
    device and holds the mesh's loss (rtol 1e-5) and parameters (rtol 1e-4,
    atol 1e-6) against it."""
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.ops import _build, sampling
    from multinn_torch.training.trainer import Trainer
    sizes, dev = ctx["sizes"], ctx["dev"]
    batch = sizes["b_nade" if decoder == "rnn-nade" else "b_rbm"]
    src = _FixedRolls(sizes, batch, 18)

    def step(mesh_kw, run):
        cfg = _mesh_cfg(sizes, decoder, mesh_kw,
                        run_dir=os.path.join(ctx["out"], run), **train)
        params = multinn.init(cfg.model, torch.Generator().manual_seed(18),
                              device=dev)
        t = Trainer(cfg, src, params=params)
        x = t._put_batch(src.x)
        key = sampling.PRNGKey(123, device=dev)
        _build.launches.clear()
        t0 = time.perf_counter()
        loss = float(t.train_step(x, key)["loss"])
        sec = time.perf_counter() - t0
        launches = dict(_build.launches)
        full = [p.detach().clone() for p in
                multinn.tree_leaves(t.full_params())]
        t0 = time.perf_counter()          # a second, warm step
        float(t.train_step(x, key)["loss"])
        warm = time.perf_counter() - t0
        t.close()
        return loss, full, launches, sec, warm

    loss, got, launches, sec, warm = step(mesh, f"{name}_{ctx['rank']}")
    out = dict(case=name, loss=loss, launches=launches, seconds=sec,
               warm_seconds=warm, ok=True)
    if ctx["rank"] == 0:
        ref_loss, want, _, _, _ = step(None, f"{name}_one")
        worst = max(float(((a - b).abs() / (1e-6 + 1e-4 * b.abs())).max())
                    for a, b in zip(got, want))
        out.update(ref_loss=ref_loss, worst_over_tol=worst,
                   ok=abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
                   and worst <= 1.0)
    return out


def _mesh_generation(ctx, name, decoder, mesh):
    """Batch-sharded generation (the whole-generation kernel, the row map)
    of B samples over T steps on ``mesh``, against one device on rank 0:
    the count of bit-identical samples."""
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.ops import _build, sampling
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.training.generator import Generator
    sizes, dev = ctx["sizes"], ctx["dev"]
    cfg = _mesh_cfg(sizes, decoder, mesh)
    params = multinn.init(cfg.model, torch.Generator().manual_seed(19),
                          device=dev)
    key = sampling.PRNGKey(5, device=dev)
    gen = Generator(cfg, params, mesh=mesh_mod.make_mesh(cfg.mesh))
    _build.launches.clear()
    t0 = time.perf_counter()
    roll = gen.generate(key, n_steps=sizes["t_gen"], batch=sizes["b_gen"])
    sec = time.perf_counter() - t0
    out = dict(case=name, launches=dict(_build.launches), seconds=sec,
               density=float(roll.mean()), ok=True)
    if ctx["rank"] == 0:
        ref = Generator(cfg, params).generate(key, n_steps=sizes["t_gen"],
                                              batch=sizes["b_gen"])
        same = int((roll == ref).reshape(len(ref), -1).all(axis=1).sum())
        out.update(identical=same, of=len(ref),
                   ok=same >= len(ref) - 1 and roll.shape == ref.shape)
    return out


def _track_generation(ctx, name, decoder, mesh):
    """Track-sharded generation (the scan path: each rank samples its
    tracks, the frames gathered every step) of B samples over the scan
    length, against one device's scan path on rank 0."""
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.ops import _build, sampling
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.training.generator import Generator
    sizes, dev = ctx["sizes"], ctx["dev"]
    cfg = _mesh_cfg(sizes, decoder, mesh)
    params = multinn.init(cfg.model, torch.Generator().manual_seed(20),
                          device=dev)
    key = sampling.PRNGKey(6, device=dev)
    gen = Generator(cfg, params, mesh=mesh_mod.make_mesh(cfg.mesh))
    _build.launches.clear()
    t0 = time.perf_counter()
    roll = gen.generate(key, n_steps=sizes["t_scan"], batch=sizes["b_gen"])
    sec = time.perf_counter() - t0
    out = dict(case=name, launches=dict(_build.launches), seconds=sec,
               density=float(roll.mean()), ok=True)
    if ctx["rank"] == 0:
        with torch.no_grad():
            _, ref = multinn.generate(
                params, key, multinn.init_state(params, sizes["b_gen"]),
                sizes["t_scan"], fused=False)
        ref = ref.to(torch.uint8).cpu().numpy()
        same = int((roll == ref).reshape(len(ref), -1).all(axis=1).sum())
        out.update(identical=same, of=len(ref), ok=same == len(ref))
    return out


def _mesh_service(ctx, name, decoder, mesh, n_requests=16):
    """A service on ``mesh``: rank 0 takes n requests at batch B, the other
    ranks follow its broadcast calls."""
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.ops import _build
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.serving.service import GenerationService, ServeConfig
    sizes, dev = ctx["sizes"], ctx["dev"]
    cfg = _mesh_cfg(sizes, decoder, mesh)
    params = multinn.init(cfg.model, torch.Generator().manual_seed(21),
                          device=dev)
    _build.launches.clear()
    t0 = time.perf_counter()
    svc = GenerationService(cfg, params, ServeConfig(
        batch=sizes["b_gen"], n_steps=sizes["t_gen"], max_wait_ms=1000.0),
        mesh=mesh_mod.make_mesh(cfg.mesh))
    if ctx["rank"] != 0:
        calls = svc.follow()
        return dict(case=name, launches=dict(_build.launches), ok=True,
                    calls=calls, seconds=time.perf_counter() - t0)
    futs = []
    for _ in range(n_requests // sizes["b_gen"]):
        futs += svc.submit_many(sizes["b_gen"])
    rolls = [f.result(300).roll for f in futs]
    svc.close()
    sec = time.perf_counter() - t0
    return dict(case=name, launches=dict(_build.launches), seconds=sec,
                answered=len(rolls), ok=len(rolls) == n_requests and all(
                    r.shape == (sizes["t_gen"], sizes["k"], sizes["d"])
                    for r in rolls))


def _nccl_step(ctx):
    """On a world of one NCCL rank: an all-reduce and a broadcast through
    NCCL, and the gspmd data=1 step bit-equal to the step without a
    mesh."""
    import torch
    import torch.distributed as dist
    from multinn_torch.models import multinn
    from multinn_torch.ops import _build, sampling
    from multinn_torch.training.trainer import Trainer
    sizes, dev = ctx["sizes"], ctx["dev"]
    probe = torch.arange(4.0, device=dev)
    dist.all_reduce(probe)
    dist.broadcast(probe, 0)
    src = _FixedRolls(sizes, sizes["b_nade"], 22)
    res = {}
    t0 = time.perf_counter()
    for kind, mesh in (("mesh", dict(data=1)), ("one", None)):
        cfg = _mesh_cfg(sizes, "rnn-nade", mesh,
                        run_dir=os.path.join(ctx["out"], f"nccl_{kind}"))
        params = multinn.init(cfg.model, torch.Generator().manual_seed(22),
                              device=dev)
        t = Trainer(cfg, src, params=params)
        _build.launches.clear()
        m = t.train_step(t._put_batch(src.x), sampling.PRNGKey(1, device=dev))
        res[kind] = (float(m["loss"]), [p.detach().clone()
                                        for p in t._all_leaves],
                     dict(_build.launches))
        t.close()
    equal = res["mesh"][0] == res["one"][0] and all(
        torch.equal(a, b) for a, b in zip(res["mesh"][1], res["one"][1]))
    return dict(case="nccl_dp_step", backend=dist.get_backend(),
                probe=probe.tolist(), loss=res["mesh"][0],
                launches=res["mesh"][2],
                seconds=time.perf_counter() - t0,
                ok=equal and probe.tolist() == [
                    0.0, 1.0, 2.0, 3.0])


def _nccl_group(ctx, spc=24):
    """On a world of one NCCL rank: a gspmd data=1 Trainer captures its
    group of ``spc`` NADE steps (the capture rule of an NCCL mesh); the
    replayed group against the eager group from the same params, state
    and key (params within 1e-6 max|p|), each replay's launches ``spc``
    times one eager step's. Every axis group of a world of one is the
    identity, so this checks the capture path under a mesh, not an NCCL
    collective inside a graph (``multinn_torch.scripts.mesh_cards``)."""
    import numpy as np
    import torch
    from multinn_torch.models import multinn
    from multinn_torch.ops import _build, sampling
    from multinn_torch.training.trainer import Trainer
    sizes, dev = ctx["sizes"], ctx["dev"]
    src = _FixedRolls(sizes, sizes["b_nade"], 23)
    xs = np.stack([src.x] * spc)
    cfg = _mesh_cfg(sizes, "rnn-nade", dict(data=1),
                    run_dir=os.path.join(ctx["out"], "nccl_group"),
                    steps_per_call=spc)
    params = multinn.init(cfg.model, torch.Generator().manual_seed(23),
                          device=dev)
    graph, eager = Trainer(cfg, src, params=params), Trainer(cfg, src,
                                                             params=params)
    captures = graph.capture_groups and graph.mesh.backend == "nccl"
    eager.capture_groups = False
    key = sampling.PRNGKey(24, device=dev)
    t0 = time.perf_counter()
    eager.run_group(xs, key)
    graph.run_group(xs, key)                 # warm-up, capture, replay
    torch.cuda.synchronize()
    diff = max(float((a - b).detach().abs().max()
                     / b.detach().abs().max().clamp(min=1e-30))
               for a, b in zip(graph._leaves, eager._leaves))
    _build.launches.clear()
    eager.train_step(eager._put_batch(src.x), key)
    torch.cuda.synchronize()
    per_step = dict(_build.launches)
    _build.launches.clear()
    graph.run_group(xs, key)
    torch.cuda.synchronize()
    replayed = dict(_build.launches)
    g = graph.group_graph
    fam = ("nade_ll_fwd", "nade_ll_bwd")
    out = dict(case="nccl_mesh_group", backend=graph.mesh.backend,
               captured=bool(captures), params_diff=diff,
               launches=replayed,
               replay_per_eager_step={k: replayed.get(k, 0) / per_step[k]
                                      for k in fam if per_step.get(k)},
               capture_s=g.capture_s, pool_bytes=g.graph.pool_bytes,
               seconds=time.perf_counter() - t0,
               ok=bool(captures and diff <= 1e-6
                       and replayed == dict(g.launches)
                       and all(per_step.get(k) and replayed.get(k)
                               == spc * per_step[k] for k in fam)))
    graph.close()
    eager.close()
    return out


def _mesh_job(ctx):
    """The cases of one world: ``mesh2`` (2 ranks), ``mesh5`` (5 ranks),
    ``nccl1`` (1 rank under NCCL)."""
    job = ctx["job"]
    if job == "nccl1":
        return [_nccl_step(ctx), _nccl_group(ctx)]
    if job == "mesh5":
        return [_mesh_step(ctx, "track5_nade", "rnn-nade", dict(track=5)),
                _mesh_step(ctx, "track5_rbm", "rnn-rbm", dict(track=5)),
                _track_generation(ctx, "track5_scan_gen_rbm", "rnn-rbm",
                                  dict(track=5)),
                _track_generation(ctx, "track5_scan_gen_nade", "rnn-nade",
                                  dict(track=5))]
    return [_mesh_step(ctx, "dp2_nade", "rnn-nade", {}),
            _mesh_step(ctx, "dp2_rbm", "rnn-rbm", {}),
            _mesh_step(ctx, "shard_map_nade", "rnn-nade",
                       dict(style="shard_map")),
            _mesh_step(ctx, "tp2_nade", "rnn-nade", dict(model=2)),
            _mesh_step(ctx, "tp2_rbm", "rnn-rbm", dict(model=2)),
            _mesh_step(ctx, "seqpipe2_nade", "rnn-nade",
                       dict(data=1, seq=2, style="seqpipe")),
            _mesh_step(ctx, "hf_shard_map_nade", "rnn-nade",
                       dict(style="shard_map"), optimizer="hf",
                       hf_cg_iters=5),
            _mesh_generation(ctx, "gen_rbm", "rnn-rbm", {}),
            _mesh_generation(ctx, "gen_nade", "rnn-nade", {}),
            _mesh_service(ctx, "service_rbm", "rnn-rbm", {})]


def _mesh_rank(rank, world, job, out, device, sizes):
    """A spawned rank of phase 18: join the world (the backend chosen by
    the port: gloo for ranks that share the card, NCCL for one rank), run
    the job's cases and write them to ``<out>/<job>_r<rank>.json``."""
    import torch
    from multinn_torch.parallel import mesh as mesh_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if device == "cpu":                     # a rehearsal without the card
        torch.set_num_threads(1)
    backend = mesh_mod.init_distributed(
        f"file://{out}/store_{job}", world, rank,
        backend="gloo" if device == "cpu" else None)
    dev = (torch.device("cpu") if device == "cpu"
           else mesh_mod.rank_device(backend))
    ctx = dict(rank=rank, world=world, job=job, out=out, dev=dev,
               sizes=sizes)
    t0 = time.perf_counter()
    try:
        cases = _mesh_job(ctx)
        import torch.distributed as dist
        dist.barrier()
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    with open(os.path.join(out, f"{job}_r{rank}.json"), "w") as f:
        json.dump(dict(backend=backend, device=str(dev),
                       seconds=time.perf_counter() - t0, cases=cases), f)


def run_mesh_world(out, job, world, device="cuda", sizes=MESH_SIZES,
                   timeout=400.0):
    """Spawn ``world`` ranks of ``job`` and wait at most ``timeout``
    seconds (every rank is killed at the deadline); returns each rank's
    result, or raises."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_mesh_rank,
                             args=(world, job, out, device, sizes),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.time() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
            if time.time() >= deadline:
                raise TimeoutError(f"{job} still ran after {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    results = []
    for rank in range(world):
        with open(os.path.join(out, f"{job}_r{rank}.json")) as f:
            results.append(json.load(f))
    return results


# what each phase 18 case's launch window must show, on every rank
MESH_KERNELS = {"dp2_nade": ("nade_ll_fwd", "nade_ll_bwd"),
                "dp2_rbm": ("gibbs_chain",),
                "shard_map_nade": ("nade_ll_fwd", "nade_ll_bwd"),
                "tp2_nade": ("nade_ll_fwd", "nade_ll_bwd"),
                "tp2_rbm": ("gibbs_chain",),
                "seqpipe2_nade": ("nade_ll_fwd", "nade_ll_bwd"),
                "hf_shard_map_nade": ("nade_ll_fwd",),
                "gen_rbm": ("gen_fused_rbm",),
                "gen_nade": ("gen_fused_nade",),
                "service_rbm": ("gen_fused_rbm",),
                "track5_nade": ("nade_ll_fwd", "nade_ll_bwd"),
                "track5_rbm": ("gibbs_chain",),
                "track5_scan_gen_rbm": ("gibbs_chain",),
                "track5_scan_gen_nade": ("nade_sample",),
                "nccl_dp_step": ("nade_ll_fwd", "nade_ll_bwd"),
                "nccl_mesh_group": ("nade_ll_fwd", "nade_ll_bwd")}


def phase18(out, say, fail, device="cuda", sizes=MESH_SIZES):
    """Phase 18: the worlds of 2 and 5 ranks on gloo and of one NCCL rank;
    ``fail`` on any case that is not ok or whose window on a rank lacks a
    kernel of its path; prints each case and world; returns every rank's
    launch windows."""
    os.makedirs(out, exist_ok=True)
    windows = []
    for job, world in (("mesh2", 2), ("mesh5", 5), ("nccl1", 1)):
        t_job = time.perf_counter()
        try:
            ranks = run_mesh_world(out, job, world, device, sizes)
        except Exception as e:  # noqa: BLE001 - any rank's failure fails
            fail(f"phase 18 {job}: {type(e).__name__}: {e}")
            continue
        job_s = time.perf_counter() - t_job
        for r, res in enumerate(ranks):
            for case in res["cases"]:
                if not case["ok"]:
                    fail(f"phase 18 {job} rank {r} {case['case']}: {case}")
                missing = [k for k in MESH_KERNELS[case["case"]]
                           if not case["launches"].get(k)]
                if missing:
                    fail(f"phase 18 {job} rank {r} {case['case']}: its "
                         f"window launched no {missing}: {case['launches']}")
                windows.append(case["launches"])
        for case in ranks[0]["cases"]:
            extra = {k: case[k] for k in ("ref_loss", "loss",
                                          "worst_over_tol", "identical",
                                          "of", "answered", "density",
                                          "probe", "captured", "params_diff",
                                          "replay_per_eager_step",
                                          "capture_s", "pool_bytes")
                     if k in case}
            per_rank = [c["launches"] for res in ranks
                        for c in res["cases"] if c["case"] == case["case"]]
            warm = (f", a second step {case['warm_seconds']:.3f} s"
                    if "warm_seconds" in case else "")
            note = ("; a world of one: the capture path of an NCCL mesh, "
                    "not an NCCL collective inside a graph (every axis "
                    "group of one rank is the identity)"
                    if case["case"] == "nccl_mesh_group" else "")
            say(f"phase 18 {job} {case['case']}: {extra}; launches per rank "
                f"{per_rank}; rank 0 {case['seconds']:.3f} s{warm} "
                f"(correctness run, one shared card){note}")
        say(f"phase 18 {job}: {world} ranks on {ranks[0]['backend']} "
            f"({ranks[0]['device']}), {job_s:.1f} s with start-up "
            f"(correctness run on one shared card, not a scaling number)")
    return windows


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs the card")
    import numpy as np

    from multinn_torch.models import multinn
    from multinn_torch.ops import (_build, gen_fused_nade, gen_fused_rbm,
                                   gibbs_cuda, kernel_prng, nade_cuda,
                                   sampling)
    from multinn_torch.serving.service import GenerationService, ServeConfig
    from multinn_torch.utils.config import (DataConfig, ExperimentConfig,
                                            GenerateConfig)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the plain versions are the f32 reference: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    g = torch.Generator().manual_seed(0)
    results = {}

    def sweep(params, gen_k):
        """The family's fused kernel over SWEEP_BATCHES at T=1024 from a
        fresh state: one row per batch with ms per song (CUDA events), us
        per step, the bound (at the storage the rule gives the batch) and
        the roofline share."""
        key = sampling.PRNGKey(5, device=dev)
        rule = (gen_fused_rbm.rbm_weight_dtype
                if params.cfg.decoder_type == "rnn-rbm"
                else gen_fused_nade.nade_aux_dtype)
        rows = []
        for b in SWEEP_BATCHES:
            state = multinn.init_state(params, b)
            run = lambda: multinn._generate_fused(params, key, state, 1024,
                                                  impl="cuda")[1]
            roll = run()
            ms = cuda_ms(run, 3, warm=False)
            bms, by = bound(*fused_work(params, roll, state.decoder.v_prev,
                                        gen_k, rule(params.cfg, b)))
            rows.append(dict(batch=b, ms=ms, us_per_step=ms * 1e3 / 1024,
                             bound_ms=bms, bound_by=by, share=bms / ms,
                             density=float(roll.mean()),
                             storage=str(rule(params.cfg, b))[6:]))
            del roll
        return rows

    def sweep_line(rows):
        return "; ".join(
            f"B={r['batch']} {r['ms']:.3f} ms/song {r['us_per_step']:.2f} "
            f"us/step, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"share {r['share']:.4%}, density {r['density']:.4f}, "
            f"{r['storage']}" for r in rows)

    def nade_depths(params, batches, name):
        """The NADE kernel at the speculative depths 1, 2 and 4 and the auto
        depth, T=1024 from a fresh state of ``params``: roll, h and c
        bit-identical to depth 1's at every depth, or fail; ms per song at
        each depth (CUDA events). Returns one line."""
        key = sampling.PRNGKey(13, device=dev)
        parts = []
        for b in batches:
            st = multinn.init_state(params, b)
            rows = (torch.stack([c.h for c in st.decoder.cell]),
                    torch.stack([c.c for c in st.decoder.cell]),
                    st.decoder.v_prev)
            run = lambda s: gen_fused_nade.generate_nade(  # noqa: E731
                key, params.decoder, *rows, 1024, spec=s)
            ref = run(1)
            for spec in (2, 4, None):
                if not all(torch.equal(x, y) for x, y in zip(run(spec), ref)):
                    fail(f"{name} B={b}: depth {spec} differs from depth 1 "
                         f"in the roll, h or c")
            ms = {spec: cuda_ms(lambda: run(spec), 2) for spec in (1, 2, 4)}
            auto = gen_fused_nade.auto_depth(params.decoder, b)
            parts.append(f"B={b} " + " ".join(
                f"depth {spec} {ms[spec]:.3f}" for spec in ms)
                + f" ms/song, auto depth {auto}, density "
                f"{float(ref[0].mean()):.4f}")
            del ref
        return "; ".join(parts)

    # 1. environment ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    from torch.utils import cpp_extension
    nvcc = (shutil.which("nvcc") or
            (cpp_extension.CUDA_HOME or "") + "/bin/nvcc")
    say(f"phase 1 environment: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | nvcc {nvcc} | ninja "
        f"{cpp_extension.is_ninja_available()} | device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.ops()
    say(f"phase 2 build: {time.perf_counter() - t0:.1f} s with "
        f"{_build.build_info.get('tool')} into "
        f"{_build.build_info.get('dir')}")

    # 3. Threefry --------------------------------------------------------------
    def word_err(a, b):          # largest difference of the uint32 words
        return float((kernel_prng.as_u64(a) - kernel_prng.as_u64(b))
                     .abs().max())

    tf_err = 0.0
    for seed, salt in ((0, 0), (12345, -7), (-2 ** 31, 2 ** 31 - 1)):
        a = kernel_prng.random_bits((4096, 750), seed, salt, dev, impl="cuda")
        b = kernel_prng.random_bits((4096, 750), seed, salt, dev,
                                    impl="plain")
        tf_err = max(tf_err, word_err(a, b))
        if not torch.equal(a, b):
            fail(f"threefry: kernel != plain for seed={seed} salt={salt} "
                 f"({int((a != b).sum())} of {a.numel()} words differ)")
    key = sampling.PRNGKey(7, device=dev)
    x0 = torch.zeros(1, dtype=torch.int32, device=dev)
    x1 = torch.full((1,), 5, dtype=torch.int32, device=dev)
    yk = kernel_prng.threefry2x32(key, x0, x1)
    yp = kernel_prng.threefry2x32(key, x0, x1, impl="plain")
    tf_err = max([tf_err] + [word_err(p, q) for p, q in zip(yk, yp)])
    if not all(torch.equal(p, q) for p, q in zip(yk, yp)):
        fail("threefry: fold_in-shaped call differs from plain")
    call_ms = cuda_ms(lambda: kernel_prng.threefry2x32(key, x0, x1), 200)
    ms = graph_ms(lambda: kernel_prng.threefry2x32(key, x0, x1), 50)
    plain_ms = cuda_ms(
        lambda: kernel_prng.threefry2x32(key, x0, x1, impl="plain"), 50)
    big = torch.arange(4096 * 750, dtype=torch.int32, device=dev)
    big_ms = cuda_ms(lambda: kernel_prng.threefry2x32(key, big, big), 50)
    big_plain_ms = cuda_ms(
        lambda: kernel_prng.threefry2x32(key, big, big, impl="plain"), 5)
    # one counter (the fold_in shape)
    results["threefry2x32"] = dict(max_abs_err=tf_err, ms=ms,
                                   plain_ms=plain_ms, **dict(zip(
                                       ("bound_ms", "bound_by"),
                                       bound(*threefry_work(1)))))
    say(f"phase 3 threefry: bit-equal on (4096, 750) x 3 keys and at the "
        f"fold_in shape; fold_in-shaped call {call_ms:.4f} ms (kernel "
        f"{ms:.4f} ms; plain "
        f"{plain_ms:.4f} ms); 3.07M counters {big_ms:.4f} ms (plain "
        f"{big_plain_ms:.3f} ms)")

    # 4. Gibbs chain -------------------------------------------------------------
    def gibbs_inputs(n, d=84, h=150, gen=g):
        v0 = (torch.rand(n, d, generator=gen) < 0.2).float().to(dev)
        w = (0.1 * torch.randn(d, h, generator=gen)).to(dev)
        bv = (-1.0 + 0.5 * torch.randn(n, d, generator=gen)).to(dev)
        bh = (0.5 * torch.randn(n, h, generator=gen)).to(dev)
        return v0, w, bv, bh

    key = sampling.PRNGKey(1, device=dev)
    args = gibbs_inputs(1040)
    out_k = gibbs_cuda.gibbs_chain(key, *args, 25)
    out_p = gibbs_cuda.gibbs_chain_plain(key, *args, 25)
    differ = float((out_k != out_p).any(dim=1).float().mean())
    if differ > 0.01:
        fail(f"gibbs: {differ:.4f} of rows differ from plain (limit 0.01)")
    n1040_ms = cuda_ms(lambda: gibbs_cuda.gibbs_chain(key, *args, 25), 20)
    n1040_plain = cuda_ms(
        lambda: gibbs_cuda.gibbs_chain_plain(key, *args, 25), 3)
    small = gibbs_inputs(8)                  # the scan path: B=8, gen_k=10
    sk, sp = (gibbs_cuda.gibbs_chain(key, *small, 10),
              gibbs_cuda.gibbs_chain_plain(key, *small, 10))
    small_err = float((sk - sp).abs().max())
    small_differ = float((sk != sp).any(dim=1).float().mean())
    if small_differ > 1 / 8:
        fail(f"gibbs: {small_differ} of the 8 scan-path rows differ")
    call_ms = cuda_ms(lambda: gibbs_cuda.gibbs_chain(key, *small, 10), 100)
    ms = graph_ms(lambda: gibbs_cuda.gibbs_chain(key, *small, 10), 50)
    plain_ms = cuda_ms(lambda: gibbs_cuda.gibbs_chain_plain(key, *small, 10),
                       10)
    results["gibbs_chain"] = dict(max_abs_err=small_err, ms=ms,
                                  plain_ms=plain_ms, **dict(zip(
                                      ("bound_ms", "bound_by"),
                                      bound(*gibbs_work(8, 10, sk)))))
    bench = gibbs_inputs(4096)              # bench.py's GIBBS: BB=4096, k=25
    bk = gibbs_cuda.gibbs_chain(key, *bench, 25)
    bp = gibbs_cuda.gibbs_chain_plain(key, *bench, 25)
    bench_differ = float((bk != bp).any(dim=1).float().mean())
    if bench_differ > 0.01:
        fail(f"gibbs at N=4096 k=25: {bench_differ:.4f} of rows differ")
    bench_ms = graph_ms(lambda: gibbs_cuda.gibbs_chain(key, *bench, 25), 20)
    bench_plain = cuda_ms(
        lambda: gibbs_cuda.gibbs_chain_plain(key, *bench, 25), 2)
    bench_bound, bench_by = bound(*gibbs_work(4096, 25, bk))
    # RBMs wider than the flagship: (84, 600) and (168, 400), whose W at
    # N=4096 or at any N stays in device memory (the launch plan says so).
    # Their inputs come from a generator of their own, so that every later
    # phase draws what it drew before these checks were added.
    wide, wide_g = [], torch.Generator().manual_seed(4)
    for d_w, h_w in ((84, 600), (168, 400)):
        wa = gibbs_inputs(64, d_w, h_w, gen=wide_g)
        wk = gibbs_cuda.gibbs_chain(key, *wa, 5)
        wp = gibbs_cuda.gibbs_chain_plain(key, *wa, 5)
        w_differ = float((wk != wp).any(dim=1).float().mean())
        if w_differ > 0.01:
            fail(f"gibbs at N=64 D={d_w} H={h_w} k=5: {w_differ:.4f} of "
                 f"rows differ (limit 0.01)")
        plans = [gibbs_cuda.launch_plan(n, _build.sm_count(wk), d_w, h_w)
                 for n in (64, 4096)]
        wide.append(f"D={d_w} H={h_w} N=64 k=5 rows differing "
                    f"{w_differ:.4f} (plan {plans[0]}, at N=4096 {plans[1]})")
    say(f"phase 4 gibbs: N=1040 k=25 rows differing {differ:.4f} (limit "
        f"0.01), kernel {n1040_ms:.3f} ms, plain {n1040_plain:.3f} ms; "
        f"N=4096 k=25 rows differing {bench_differ:.4f} (limit 0.01), "
        f"kernel {bench_ms:.4f} ms = {4096 * 25 / bench_ms * 1e3:.4g} "
        f"sweeps/s, plain {bench_plain:.3f} ms = "
        f"{4096 * 25 / bench_plain * 1e3:.4g} sweeps/s, bound "
        f"{bench_bound:.4f} ms ({bench_by}); scan-path shape (8 rows, k=10) "
        f"rows differing {small_differ}, kernel {ms:.4f} ms (call "
        f"{call_ms:.4f} ms), plain {plain_ms:.3f} ms; {'; '.join(wide)}; "
        f"{smi}")
    del bench, bk, bp

    # 5. fused RBM generation at flagship widths ---------------------------------
    def primed(params, batch, gen=g):
        """h0, c0 and v_prev of a state primed on a seeded random roll."""
        seed = (torch.rand(batch, 16, params.cfg.n_tracks,
                           params.cfg.n_pitches, generator=gen) < 0.1).float()
        st = multinn.prime(params, multinn.init_state(params, batch),
                           seed.to(dev))
        return (torch.stack([c.h for c in st.decoder.cell]),
                torch.stack([c.c for c in st.decoder.cell]),
                st.decoder.v_prev)

    def match16(gen, rows, need, name):
        """Kernel vs plain version at T=16 from the primed rows: at least
        ``need`` samples identical, the final h within 1e-4 on those.
        Returns the count and that error."""
        rk, hk, _ = gen(*rows, 16, "cuda")
        rp, hp, _ = gen(*rows, 16, "plain")
        same = (rk == rp).flatten(1).all(dim=1)
        n_same = int(same.sum())
        if n_same < need:
            fail(f"{name}: only {n_same} of {len(same)} samples match plain "
                 f"at T=16 (need {need})")
        err = float((hk - hp).abs()[:, :, same].max())
        if not err <= 1e-4:
            fail(f"{name}: final h differs by {err} on matching samples")
        return n_same, err

    def density_gap(gen, rows, name):
        """Per-track note density of kernel and plain version at T=1024
        from the primed rows, within 0.01 of each other."""
        dens = [gen(*rows, 1024, impl)[0].mean(dim=(0, 1, 3))
                for impl in ("cuda", "plain")]
        gap = float((dens[0] - dens[1]).abs().max())
        if not gap <= 0.01:
            fail(f"{name}: per-track density gap {gap} at T=1024 (limit "
                 f"0.01)")
        return [[round(float(x), 4) for x in d] for d in dens], gap

    mcfg = multinn.MultINNConfig(**dict(FLAGSHIP, w_std=0.1))
    p5 = multinn.init(mcfg, g, device=dev)
    p5 = dataclasses.replace(p5, decoder=dataclasses.replace(
        p5.decoder, bv=p5.decoder.bv + torch.linspace(-3.0, 1.0, 84,
                                                      device=dev)))
    rows5 = primed(p5, 8)
    key = sampling.PRNGKey(5, device=dev)

    def fused(h0, c0, v0, n_steps, impl):
        return gen_fused_rbm.generate_rbm(key, p5.decoder, h0, c0, v0,
                                          n_steps, 10, impl=impl)

    same8, h_err = match16(fused, rows5, 7, "fused")
    (dens_k, dens_p), dens_gap = density_gap(fused, rows5, "fused")
    # B=256: several samples per cluster, as the sweep times it
    same256, h_err256 = match16(fused, primed(p5, 256), 254, "fused B=256")
    say(f"phase 5 fused: T=16 B=8 {same8}/8 samples identical, final h max "
        f"err {h_err:.2e}; T=16 B=256 {same256}/256 identical (need 254), "
        f"final h max err {h_err256:.2e}; T=1024 per-track density kernel "
        f"{dens_k} plain {dens_p} (max gap {dens_gap:.4f})")
    # K=4 (the track set of multinn_torch.scripts.mesh_cards): a cluster
    # of four CTAs, one track slot each; its own generator, so the draws
    # of the phases after it stay as they were
    def ramped(model, gen):
        """Seeded params of ``model`` at w_std 0.1 with the visible-bias
        ramp of phases 5 and 8."""
        p = multinn.init(multinn.MultINNConfig(**dict(model, w_std=0.1)),
                         gen, device=dev)
        return dataclasses.replace(p, decoder=dataclasses.replace(
            p.decoder, bv=p.decoder.bv + torch.linspace(-3.0, 1.0, 84,
                                                        device=dev)))

    g4 = torch.Generator().manual_seed(54)
    p5k4 = ramped(dict(FLAGSHIP, n_tracks=4), g4)
    same_k4, h_err_k4 = match16(
        lambda h0, c0, v0, n_steps, impl: gen_fused_rbm.generate_rbm(
            key, p5k4.decoder, h0, c0, v0, n_steps, 10, impl=impl),
        primed(p5k4, 8, g4), 7, "fused K=4")
    say(f"phase 5 fused K=4 (a cluster of 4 CTAs, one track each): T=16 "
        f"B=8 {same_k4}/8 samples identical (need 7), final h max err "
        f"{h_err_k4:.2e}")
    params = multinn.init(multinn.MultINNConfig(**FLAGSHIP),
                          torch.Generator().manual_seed(0), device=dev)
    rbm_sweep = sweep(params, FLAGSHIP["gen_k"])
    say(f"phase 5 sweep, T=1024, flagship with seeded random params, "
        f"{smi}: {sweep_line(rbm_sweep)}")

    # 6. the slice ------------------------------------------------------------------
    cfg = ExperimentConfig(
        name="flagship", model=multinn.MultINNConfig(**FLAGSHIP),
        data=DataConfig(dataset="lpd5", pitch_min=24, pitch_max=107,
                        n_tracks=5),
        generate=GenerateConfig(n_steps=1024, seed_steps=64))
    rng = np.random.default_rng(0)
    seeds = (rng.random((8, 64, 5, 84)) < 0.1).astype(np.uint8)

    _build.launches.clear()                  # the main path starts here
    t_serve = time.perf_counter()
    svc = GenerationService(cfg, params, ServeConfig(
        batch=8, n_steps=1024, seed_steps=64, seed=0))
    futs = svc.submit_many(16) + [svc.submit(seed=s) for s in seeds]
    served = [f.result(timeout=600) for f in futs]
    stats = svc.stats()
    svc.close()
    serve_s = time.perf_counter() - t_serve
    with torch.inference_mode():
        state = multinn.init_state(params, 8)
        _, scan_roll = multinn.generate(
            params, sampling.fold_in(sampling.PRNGKey(0, device=dev), 99),
            state, 16, fused=False)
        torch.cuda.synchronize()
    launches = dict(_build.launches)         # ... and ends here
    missing = [n for n in results if not launches.get(n)]
    if missing:
        fail(f"the main path never launched {missing}: {launches}")
    for r in served:
        if (r.roll.shape != (1024, 5, 84) or r.roll.dtype != np.uint8
                or not np.isin(r.roll, (0, 1)).all()):
            fail(f"served roll {r.roll.shape} {r.roll.dtype} is not a "
                 f"binary (1024, 5, 84) uint8 pianoroll")
    prov = sorted((r.batch_index, r.row) for r in served)
    if len(set(prov)) != 24 or stats["batches"] != 3 or stats["errors"]:
        fail(f"provenance / stats wrong: {prov} {stats}")
    density = float(np.mean([r.roll.mean() for r in served]))
    if not 0.0 < density < 1.0:
        fail(f"served density {density}")
    if (scan_roll.shape != (8, 16, 5, 84)
            or not torch.isin(scan_roll, torch.tensor([0.0, 1.0], device=dev)
                              ).all()):
        fail(f"scan-branch roll {tuple(scan_roll.shape)} is not binary")
    # the service is deterministic: batch 0 equals a direct generation
    # under fold_in(PRNGKey(0), 0)
    batch0 = svc.generator.generate(
        sampling.fold_in(sampling.PRNGKey(0, device=dev), 0), 1024, batch=8)
    first = {r.row: r.roll for r in served if r.batch_index == 0}
    if not all(np.array_equal(first[i], batch0[i]) for i in first):
        fail("service batch 0 differs from a direct generation with its key")

    # the kernels line: the service's batch, B=8, from the sweep, and the
    # plain version at the sweep's inputs
    b8 = next(r for r in rbm_sweep if r["batch"] == 8)
    b8_plain_ms = cuda_ms(lambda: multinn._generate_fused(
        params, sampling.PRNGKey(5, device=dev), multinn.init_state(params, 8),
        1024, impl="plain"), 1, warm=False)
    results["gen_fused_rbm"] = dict(
        max_abs_err=max(h_err, h_err256), ms=b8["ms"], plain_ms=b8_plain_ms,
        bound_ms=b8["bound_ms"], bound_by=b8["bound_by"])
    lat = stats["latency_ms"]
    say(f"phase 6 slice: 24 requests (16 plain, 8 seeded) in 3 batches of 8 "
        f"in {serve_s:.2f} s incl. warm-up; latency p50 {lat['p50']:.1f} ms "
        f"p95 {lat['p95']:.1f} ms; {stats.get('songs_per_s', 0.0):.2f} "
        f"songs/s; note density {density:.4f}; scan branch 16 steps ok; "
        f"64-bar B=8 kernel {b8['ms']:.3f} ms, plain {b8_plain_ms:.1f} ms; "
        f"launches {launches}")

    rbm_launches = launches
    serve6 = dict(p50=lat["p50"], p95=lat["p95"],
                  songs=stats.get("songs_per_s", 0.0))

    # 7. NADE sampler -------------------------------------------------------------
    def nade_inputs(n, d=84, h=150, bias=-1.0, gen=g):
        w = (0.1 * torch.randn(d, h, generator=gen)).to(dev)
        v = (0.1 * torch.randn(d, h, generator=gen)).to(dev)
        bv = (bias + 0.5 * torch.randn(n, d, generator=gen)).to(dev)
        bh = (0.5 * torch.randn(n, h, generator=gen)).to(dev)
        return w, v, bv, bh

    key = sampling.PRNGKey(3, device=dev)
    nargs = nade_inputs(8)                   # one track, the scan branch's 8 rows
    nk = nade_cuda.nade_sample(key, *nargs, (8,))
    npl = nade_cuda.nade_sample_plain(key, *nargs, (8,))
    torch.cuda.synchronize()
    nade_err = float((nk - npl).abs().max())
    nade_differ = int((nk != npl).any(dim=1).sum())
    if nade_differ > 1:
        fail(f"nade_sample: {nade_differ} of 8 rows differ from plain "
             f"(limit 1)")
    call_ms = cuda_ms(lambda: nade_cuda.nade_sample(key, *nargs, (8,)), 100)
    ms = graph_ms(lambda: nade_cuda.nade_sample(key, *nargs, (8,)), 50)
    plain_ms = cuda_ms(lambda: nade_cuda.nade_sample_plain(key, *nargs, (8,)),
                       10)
    results["nade_sample"] = dict(max_abs_err=nade_err, ms=ms,
                                  plain_ms=plain_ms, **dict(zip(
                                      ("bound_ms", "bound_by"), bound(
                                          *nade_sample_work(8, 84, 150,
                                                            nk)))))
    # the same at music's density: bv about -3 draws about 0.06 of the dims
    # (its own generator, as phase 4's wide chains)
    sparse = nade_inputs(8, bias=-3.0, gen=torch.Generator().manual_seed(7))
    sk = nade_cuda.nade_sample(key, *sparse, (8,))
    if int((sk != nade_cuda.nade_sample_plain(key, *sparse, (8,))).any(
            dim=1).sum()) > 1:
        fail("nade_sample: more than 1 of 8 rows differ at density 0.06")
    sparse_ms = graph_ms(lambda: nade_cuda.nade_sample(key, *sparse, (8,)),
                         50)
    say(f"phase 7 nade sampler: D=84 H=150, 8 rows, rows differing "
        f"{nade_differ} (limit 1), W and V staged "
        f"{nade_cuda.sample_plan(84, 150)}, window 16 dims; density "
        f"{float(nk.mean()):.4f}: kernel {ms:.4f} ms = {ms * 1e3 / 84:.4f} us per dim (call "
        f"{call_ms:.4f} ms), plain {plain_ms:.3f} ms; density "
        f"{float(sk.mean()):.4f}: kernel {sparse_ms:.4f} ms = "
        f"{sparse_ms * 1e3 / 84:.4f} us per dim; {smi}")

    # 8. fused NADE generation at flagship widths --------------------------------
    ncfg = multinn.MultINNConfig(**dict(NADE_FLAGSHIP, w_std=0.1))
    p8 = multinn.init(ncfg, g, device=dev)
    p8 = dataclasses.replace(p8, decoder=dataclasses.replace(
        p8.decoder, bv=p8.decoder.bv + torch.linspace(-3.0, 1.0, 84,
                                                      device=dev)))
    rows8 = primed(p8, 8)
    key = sampling.PRNGKey(8, device=dev)

    def nfused(h0, c0, v0, n_steps, impl):
        return gen_fused_nade.generate_nade(key, p8.decoder, h0, c0, v0,
                                            n_steps, impl=impl)

    nsame8, nh_err = match16(nfused, rows8, 7, "fused nade")
    (dens_k, dens_p), dens_gap = density_gap(nfused, rows8, "fused nade")
    nsame256, nh_err256 = match16(nfused, primed(p8, 256), 254,
                                  "fused nade B=256")
    say(f"phase 8 fused nade: T=16 B=8 {nsame8}/8 samples identical, final "
        f"h max err {nh_err:.2e}; T=16 B=256 {nsame256}/256 identical (need "
        f"254), final h max err {nh_err256:.2e}; T=1024 per-track density "
        f"kernel {dens_k} plain {dens_p} (max gap {dens_gap:.4f})")
    g4 = torch.Generator().manual_seed(58)
    p8k4 = ramped(dict(NADE_FLAGSHIP, n_tracks=4), g4)
    nsame_k4, nh_err_k4 = match16(
        lambda h0, c0, v0, n_steps, impl: gen_fused_nade.generate_nade(
            key, p8k4.decoder, h0, c0, v0, n_steps, impl=impl),
        primed(p8k4, 8, g4), 7, "fused nade K=4")
    say(f"phase 8 fused nade K=4 (a cluster of 4 CTAs, one track each): "
        f"T=16 B=8 {nsame_k4}/8 samples identical (need 7), final h max "
        f"err {nh_err_k4:.2e}")
    nparams = multinn.init(multinn.MultINNConfig(**NADE_FLAGSHIP),
                           torch.Generator().manual_seed(0), device=dev)
    nade_sweep = sweep(nparams, 0)
    say(f"phase 8 sweep, T=1024, NADE flagship with seeded random params, "
        f"{smi}: {sweep_line(nade_sweep)}")
    say(f"phase 8 speculative depths, T=1024, NADE flagship with seeded "
        f"random params, rolls, h and c bit-identical across depths: "
        f"{nade_depths(nparams, (1, 8, 32, 256), 'phase 8')}; {smi}")
    # at music's density (bv lowered by 3: about 0.06 of the dims drawn)
    quiet = dataclasses.replace(nparams, decoder=dataclasses.replace(
        nparams.decoder, bv=nparams.decoder.bv - 3.0))
    say(f"phase 8 speculative depths, bv - 3: "
        f"{nade_depths(quiet, (1, 8), 'phase 8 bv - 3')}; {smi}")
    del quiet

    # 9. the NADE slice -------------------------------------------------------------
    ncfg9 = ExperimentConfig(
        name="flagship-nade", model=multinn.MultINNConfig(**NADE_FLAGSHIP),
        data=DataConfig(dataset="lpd5", pitch_min=24, pitch_max=107,
                        n_tracks=5),
        generate=GenerateConfig(n_steps=1024, seed_steps=64))
    nseeds = (np.random.default_rng(1).random((8, 64, 5, 84)) < 0.1
              ).astype(np.uint8)

    _build.launches.clear()                  # the NADE path starts here
    t_serve = time.perf_counter()
    svc = GenerationService(ncfg9, nparams, ServeConfig(
        batch=8, n_steps=1024, seed_steps=64, seed=0))
    futs = svc.submit_many(16) + [svc.submit(seed=s) for s in nseeds]
    served = [f.result(timeout=600) for f in futs]
    stats = svc.stats()
    svc.close()
    serve_s = time.perf_counter() - t_serve
    with torch.inference_mode():
        _, scan_roll = multinn.generate(
            nparams, sampling.fold_in(sampling.PRNGKey(0, device=dev), 99),
            multinn.init_state(nparams, 8), 16, fused=False)
        torch.cuda.synchronize()
    nade_launches = dict(_build.launches)    # ... and ends here
    depth9 = gen_fused_nade.auto_depth(nparams.decoder, 8)
    missing = [n for n in ("gen_fused_nade", "nade_sample", "threefry2x32")
               if not nade_launches.get(n)]
    if missing:
        fail(f"the NADE path never launched {missing}: {nade_launches}")
    for r in served:
        if (r.roll.shape != (1024, 5, 84) or r.roll.dtype != np.uint8
                or not np.isin(r.roll, (0, 1)).all()):
            fail(f"served NADE roll {r.roll.shape} {r.roll.dtype} is not a "
                 f"binary (1024, 5, 84) uint8 pianoroll")
    prov = sorted((r.batch_index, r.row) for r in served)
    if len(set(prov)) != 24 or stats["batches"] != 3 or stats["errors"]:
        fail(f"NADE provenance / stats wrong: {prov} {stats}")
    ndensity = float(np.mean([r.roll.mean() for r in served]))
    if not 0.0 < ndensity < 1.0:
        fail(f"served NADE density {ndensity}")
    if (scan_roll.shape != (8, 16, 5, 84)
            or not torch.isin(scan_roll, torch.tensor([0.0, 1.0], device=dev)
                              ).all()):
        fail(f"NADE scan-branch roll {tuple(scan_roll.shape)} is not binary")
    batch0 = svc.generator.generate(
        sampling.fold_in(sampling.PRNGKey(0, device=dev), 0), 1024, batch=8)
    first = {r.row: r.roll for r in served if r.batch_index == 0}
    if not all(np.array_equal(first[i], batch0[i]) for i in first):
        fail("NADE service batch 0 differs from a direct generation with its "
             "key")

    nb8 = next(r for r in nade_sweep if r["batch"] == 8)
    nb8_plain_ms = cuda_ms(lambda: multinn._generate_fused(
        nparams, sampling.PRNGKey(5, device=dev),
        multinn.init_state(nparams, 8), 1024, impl="plain"), 1, warm=False)
    results["gen_fused_nade"] = dict(
        max_abs_err=max(nh_err, nh_err256), ms=nb8["ms"],
        plain_ms=nb8_plain_ms, bound_ms=nb8["bound_ms"],
        bound_by=nb8["bound_by"])
    lat = stats["latency_ms"]
    say(f"phase 9 nade slice: 24 requests (16 plain, 8 seeded) in 3 batches "
        f"of 8 in {serve_s:.2f} s incl. warm-up; latency p50 "
        f"{lat['p50']:.1f} ms p95 {lat['p95']:.1f} ms; "
        f"{stats.get('songs_per_s', 0.0):.2f} songs/s; note density "
        f"{ndensity:.4f}; scan branch 16 steps ok; the service's batch "
        f"runs the auto depth {depth9}; 64-bar B=8 kernel "
        f"{nb8['ms']:.3f} ms, plain {nb8_plain_ms:.1f} ms; launches "
        f"{nade_launches}")

    # 10. NADE likelihood kernels ------------------------------------------
    from multinn_torch.nn import nade as nade_nn
    from multinn_torch.ops import nade_ll

    def ll_inputs(k, n, d=84, h=150, gen=g):
        x = (torch.rand(k, n, d, generator=gen) < 0.06).float()
        w = 0.1 * torch.randn(k, d, h, generator=gen)
        v = 0.1 * torch.randn(k, d, h, generator=gen)
        bv = -1.0 + 0.5 * torch.randn(k, n, d, generator=gen)
        bh = 0.5 * torch.randn(k, n, h, generator=gen)
        cot = torch.randn(k, n, d, generator=gen)
        return [t.to(dev) for t in (x, w, v, bv, bh, cot)]

    def grad_err(a, b):            # the stated backward tolerance, as a ratio
        return float((a - b).abs().max()) / (1e-4 * float(b.abs().max())
                                             + 1e-5)

    xl, wl, vl, bvl, bhl, cot = ll_inputs(5, 4096)
    lk, ak = nade_ll.nade_ll_fwd(xl, wl, vl, bvl, bhl)
    lp, ap = nade_ll.nade_ll_fwd_plain(xl, wl, vl, bvl, bhl)
    fwd_err = float((lk - lp).abs().max())
    if not fwd_err <= 1e-4:
        fail(f"nade_ll_fwd: logits differ from plain by {fwd_err}")
    bk = nade_ll.nade_ll_bwd(xl, wl, vl, cot, ak, want_dx=True)
    bp = nade_ll.nade_ll_bwd_plain(xl, wl, vl, cot, ap, want_dx=True)
    ratios = {n: grad_err(a, b) for n, a, b in zip(("dW", "dV", "dx", "dbh"),
                                                    bk, bp)}
    leaves = lambda: [t.clone().requires_grad_(True)
                      for t in (xl, wl, vl, bvl, bhl)]
    fk, fp = leaves(), leaves()
    gk = torch.autograd.grad(nade_ll.nade_logits(*fk, impl="cuda"), fk, cot)
    gp = torch.autograd.grad(nade_ll.nade_logits(*fp, impl="plain"), fp, cot)
    for n, a, b in zip(("dx", "dW", "dV", "dbv", "dbh"), gk, gp):
        ratios["fn_" + n] = grad_err(a, b)
    if max(ratios.values()) > 1.0:
        fail(f"nade_ll_bwd: gradients outside 1e-4*max|ref|+1e-5 (error / "
             f"tolerance): {ratios}")
    bwd_err = max(float((a - b).abs().max()) for a, b in zip(bk, bp))
    fwd_ms = cuda_ms(lambda: nade_ll.nade_ll_fwd(xl, wl, vl, bvl, bhl), 20)
    fwd_plain = cuda_ms(
        lambda: nade_ll.nade_ll_fwd_plain(xl, wl, vl, bvl, bhl), 3)
    fwd_dev = graph_ms(lambda: nade_ll.nade_ll_fwd(xl, wl, vl, bvl, bhl), 20)
    bwd_ms = cuda_ms(lambda: nade_ll.nade_ll_bwd(xl, wl, vl, cot, ak,
                                                 want_dx=False), 20)
    bwd_dx_ms = cuda_ms(lambda: nade_ll.nade_ll_bwd(xl, wl, vl, cot, ak), 20)
    bwd_dev = graph_ms(lambda: nade_ll.nade_ll_bwd(
        xl, wl, vl, cot, ak, want_dx=False), 20)
    bwd_dx_dev = graph_ms(lambda: nade_ll.nade_ll_bwd(xl, wl, vl, cot, ak),
                          20)
    bwd_plain = cuda_ms(lambda: nade_ll.nade_ll_bwd_plain(
        xl, wl, vl, cot, ap, want_dx=False), 3)

    def ll_step(logits_fn):        # forward + backward into the four weights
        ps = [t.clone().requires_grad_(True) for t in (wl, vl, bvl, bhl)]
        torch.autograd.grad(logits_fn(xl, *ps), ps, cot)

    step_kernel = cuda_ms(lambda: ll_step(nade_ll.nade_logits), 10)
    step_cumsum = cuda_ms(lambda: ll_step(nade_nn.conditionals_logits), 3)
    results["nade_ll_fwd"] = dict(
        max_abs_err=fwd_err, ms=fwd_dev, plain_ms=fwd_plain, **dict(zip(
            ("bound_ms", "bound_by"),
            bound(*nade_ll_fwd_work(5, 4096, 84, 150, xl)))))
    results["nade_ll_bwd"] = dict(
        max_abs_err=bwd_err, ms=bwd_dev, plain_ms=bwd_plain, **dict(zip(
            ("bound_ms", "bound_by"),
            bound(*nade_ll_bwd_work(5, 4096, 84, 150, xl)))))
    say(f"phase 10 nade likelihood: K=5 N=4096 D=84 H=150; logits max err "
        f"{fwd_err:.2e} (limit 1e-4); backward error / tolerance "
        f"{ {n: round(r, 4) for n, r in ratios.items()} }; forward kernel "
        f"{fwd_dev:.4f} ms (call {fwd_ms:.4f} ms), plain {fwd_plain:.3f} ms; "
        f"backward kernel {bwd_dev:.4f} ms ({bwd_dx_dev:.4f} ms with dx; "
        f"calls {bwd_ms:.4f} / {bwd_dx_ms:.4f} ms), plain {bwd_plain:.3f} "
        f"ms; {smi}; autograd step through the kernels "
        f"{step_kernel:.3f} ms, through the cumsum form {step_cumsum:.3f} ms")
    del lk, ak, lp, ap, bk, bp, fk, fp, gk, gp
    # widths beyond the flagship's: H=600 (the kernels split H into chunks)
    # and D=420 (the joint mode's one track of K D), at small N, from a
    # generator of their own (as phase 4's wide chains)
    wide, wide_g = [], torch.Generator().manual_seed(10)
    for d_w, h_w in ((84, 600), (420, 150)):
        xw, ww, vw, bvw, bhw, cw = ll_inputs(2, 300, d_w, h_w, gen=wide_g)
        lk, ak = nade_ll.nade_ll_fwd(xw, ww, vw, bvw, bhw)
        lp, ap = nade_ll.nade_ll_fwd_plain(xw, ww, vw, bvw, bhw)
        w_err = float((lk - lp).abs().max())
        got = nade_ll.nade_ll_bwd(xw, ww, vw, cw, ak, want_dx=True)
        want = nade_ll.nade_ll_bwd_plain(xw, ww, vw, cw, ap, want_dx=True)
        w_ratio = max(grad_err(a, b) for a, b in zip(got, want))
        if not (w_err <= 1e-4 and w_ratio <= 1.0):
            fail(f"nade likelihood at D={d_w} H={h_w}: logits err {w_err}, "
                 f"gradients at {w_ratio} of the tolerance")
        sms = _build.sm_count(xw)
        wide.append(f"D={d_w} H={h_w} logits err {w_err:.2e}, gradients at "
                    f"{w_ratio:.4f} of the tolerance (plans: forward "
                    f"{nade_ll.fwd_plan(2, 300, d_w, h_w, sms)}, backward "
                    f"{nade_ll.bwd_plan(2, 300, d_w, h_w, sms)})")
    say(f"phase 10 wider likelihoods, K=2 N=300: {'; '.join(wide)}")

    # 11. RBM training --------------------------------------------------------
    import tempfile

    from multinn_torch.training.checkpoint import Checkpointer
    from multinn_torch.training.trainer import Trainer
    from multinn_torch.utils.config import TrainConfig
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")     # the trainers' run dirs

    class RollSource:
        """Seeded Bernoulli(0.06) pianorolls (bench.py's density) behind the
        Dataset interface: ``train`` holds n_train batches (one batch
        n_train times with ``fixed``), ``valid`` ends in a short batch whose
        last window is half masked."""

        def __init__(self, n_train, n_valid, batch, seed, fixed=False):
            rng = np.random.default_rng(seed)
            draw = lambda n: (rng.random((n, 64, 5, 84)) < 0.06).astype(
                np.uint8)
            self.windows = {"train": draw(batch if fixed else
                                          n_train * batch),
                            "valid": draw(n_valid)}
            self.masks = {k: np.ones(v.shape[:2], np.uint8)
                          for k, v in self.windows.items()}
            self.masks["valid"][-1, 32:] = 0
            self.batch, self.n_train, self.fixed = batch, n_train, fixed

        def n_batches(self, split="train"):
            return (self.n_train if split == "train"
                    else -(-len(self.windows[split]) // self.batch))

        def batches(self, split="train", epoch=0, shuffle=True,
                    drop_remainder=True, with_masks=False, augment=False):
            data, masks = self.windows[split], self.masks[split]
            if self.fixed and split == "train":
                yield from [data] * self.n_train
                return
            idx = np.arange(len(data))
            if shuffle:
                np.random.default_rng(epoch).shuffle(idx)
            for c in range(0, len(data), self.batch):
                sel = idx[c:c + self.batch]
                if len(sel) < self.batch and drop_remainder:
                    break
                yield (data[sel], masks[sel]) if with_masks else data[sel]

    def device_busy(trainer, x, key, reps=5):
        """Kernel time per step (torch.profiler) and the top kernels."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        trainer.train_step(x, key)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                trainer.train_step(x, key)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
        return total, [(e.key[:40], round(e.self_device_time_total / 1e3
                                          / reps, 3)) for e in top]

    def train_phase(model, batch, fixed, seed):
        tcfg = ExperimentConfig(
            model=multinn.MultINNConfig(**model),
            train=TrainConfig(log_every_steps=20, run_dir=f"{tmp}/{seed}"))
        src = RollSource(20, 2 * batch + batch // 2, batch, seed, fixed)
        p0 = multinn.init(tcfg.model, torch.Generator().manual_seed(seed),
                          device=dev)
        return Trainer(tcfg, src, params=p0), src, p0

    def moved(trainer, p0):
        return all(not torch.equal(a, b) for a, b in zip(
            trainer._leaves, multinn.tree_leaves(p0)))

    def step_time(trainer, x):
        """Warm step ms (CUDA events) and what the profiler says of it."""
        key = sampling.PRNGKey(123, device=dev)
        ms = cuda_ms(lambda: trainer.train_step(x, key), 10)
        busy_ms, top = device_busy(trainer, x, key)
        busy = (f"kernel time per step {busy_ms:.2f} ms (device busy "
                f"{busy_ms / ms:.1%}), top {top}" if busy_ms else
                "device busy share not measured (the profiler saw no "
                "device time)")
        return ms, busy

    trainer, src, p0 = train_phase(FLAGSHIP, 16, False, 11)
    _build.launches.clear()                  # the RBM training path starts
    last = trainer.train_epoch()
    ev = trainer.evaluate("valid")
    torch.cuda.synchronize()
    rbm_train_launches = dict(_build.launches)   # ... and ends here
    if trainer.step != 20 or not last:
        fail(f"rbm training ran {trainer.step} steps, logged {last}")
    if not (np.isfinite(last["loss"]) and np.isfinite(last["grad_norm"])
            and all(np.isfinite(v) for v in ev.values())):
        fail(f"rbm training: non-finite metrics {last} {ev}")
    if not moved(trainer, p0):
        fail("rbm training: a parameter leaf did not move")
    if rbm_train_launches.get("gibbs_chain", 0) < 100:
        fail(f"rbm training launched the Gibbs chain "
             f"{rbm_train_launches.get('gibbs_chain', 0)} times (< 100)")
    cd_args = gibbs_inputs(1024)
    key = sampling.PRNGKey(2, device=dev)
    ck = gibbs_cuda.gibbs_chain(key, *cd_args, 1)
    cp = gibbs_cuda.gibbs_chain_plain(key, *cd_args, 1)
    cd_differ = float((ck != cp).any(dim=1).float().mean())
    if cd_differ > 0.01:
        fail(f"gibbs at N=1024 k=1: {cd_differ:.4f} of rows differ")
    cd_ms = graph_ms(lambda: gibbs_cuda.gibbs_chain(key, *cd_args, 1), 50)
    cd_plain = cuda_ms(
        lambda: gibbs_cuda.gibbs_chain_plain(key, *cd_args, 1), 5)
    x16 = trainer._to_device(next(src.batches("train", shuffle=False)))
    rbm_ms, rbm_busy = step_time(trainer, x16)
    say(f"phase 11 rbm training: 20 steps B=16 T=64, loss {last['loss']:.4f} "
        f"grad_norm {last['grad_norm']:.4f} f1 {last.get('f1', 0):.4f}; eval "
        f"loss {ev['loss']:.4f} ll/frame {ev['ll_per_frame']:.4f}; every leaf "
        f"moved; launches {rbm_train_launches}; CD-1 chain N=1024 rows "
        f"differing {cd_differ:.4f}, kernel {cd_ms:.4f} ms, plain "
        f"{cd_plain:.3f} ms; warm step {rbm_ms:.2f} ms = "
        f"{16 * 64 / rbm_ms * 1e3:.0f} frames/s; {rbm_busy}")
    del trainer

    # 12. NADE training -----------------------------------------------------
    trainer, src, p0 = train_phase(NADE_FLAGSHIP, 64, True, 12)
    x64 = trainer._to_device(next(src.batches("train", shuffle=False)))
    key = sampling.PRNGKey(0, device=dev)
    with torch.no_grad():
        nll0 = float(multinn.loss(trainer.params, key, x64,
                                  detailed=False)[0])
    _build.launches.clear()                  # the NADE training path starts
    last = trainer.train_epoch()
    torch.cuda.synchronize()
    nade_train_launches = dict(_build.launches)  # ... and ends here
    with torch.no_grad():
        nll20 = float(multinn.loss(trainer.params, key, x64,
                                   detailed=False)[0])
    if not nll20 < nll0:
        fail(f"nade training: NLL {nll0} -> {nll20} did not fall")
    if (nade_train_launches.get("nade_ll_fwd", 0) < 20
            or nade_train_launches.get("nade_ll_bwd", 0) < 20):
        fail(f"nade training launches {nade_train_launches}")
    if not moved(trainer, p0):
        fail("nade training: a parameter leaf did not move")
    grads = {}
    for impl in ("cuda", "plain"):
        loss, _ = multinn.loss(trainer.params, key, x64, detailed=False,
                               impl=impl)
        grads[impl] = torch.autograd.grad(loss, trainer._leaves)
    g_ratio = max(grad_err(a, b) for a, b in zip(grads["cuda"],
                                                 grads["plain"]))
    if g_ratio > 1.0:
        fail(f"nade training: kernel gradients vs plain at {g_ratio:.3f} of "
             f"the tolerance")
    nade_ms, nade_busy = step_time(trainer, x64)
    say(f"phase 12 nade training: 20 steps B=64 T=64 on one batch, NLL "
        f"{nll0:.4f} -> {nll20:.4f}; launches {nade_train_launches}; model "
        f"gradients kernel vs plain at {g_ratio:.4f} of the tolerance; warm "
        f"step {nade_ms:.2f} ms = {64 * 64 / nade_ms * 1e3:.0f} frames/s; "
        f"{nade_busy}")

    # 13. the train entry point on the card --------------------------------
    t13 = time.perf_counter()
    from multinn_torch import train as train_cli

    spc = 24

    def rel_diff(got, want):
        """The largest difference of two lists of tensors, as a share of
        each reference tensor's max |p|."""
        return max(float((a - b).detach().abs().max()
                         / b.detach().abs().max().clamp(min=1e-30))
                   for a, b in zip(got, want))

    def group_check(model, batch, seed, p0=None):
        """One group of 24 steps eagerly and by graph replay from the same
        params (``p0``, else drawn from ``seed``), optimizer state and key;
        a DBN encoder bit-identical through both; then the graph's step
        time by CUDA events over replays, the kernels' share of it
        (profiler) and the launches a replay adds against one eager
        step's."""
        cfg = ExperimentConfig(
            model=multinn.MultINNConfig(**model),
            train=TrainConfig(steps_per_call=spc, log_every_steps=1000,
                              run_dir=f"{tmp}/group_{seed}_"
                                      f"{model.get('matmul_dtype', 'f32')}"))
        src = RollSource(spc, 2, batch, seed)
        xs = np.stack(list(src.batches("train", shuffle=False)))
        if p0 is None:
            p0 = multinn.init(cfg.model, torch.Generator().manual_seed(seed),
                              device=dev)
        graph, eager = Trainer(cfg, src, params=p0), Trainer(cfg, src,
                                                             params=p0)
        eager.capture_groups = False
        key = sampling.PRNGKey(seed, device=dev)
        eager_ms = cuda_ms(lambda: eager.run_group(xs, key), 1,
                           warm=False) / spc
        graph.run_group(xs, key)                 # warm-up, capture, replay
        torch.cuda.synchronize()
        g = graph.group_graph
        diff = rel_diff(graph._leaves, eager._leaves)
        if not diff <= 1e-6:
            fail(f"phase 13: graph vs eager group, params differ by "
                 f"{diff:.3e} of max|p| (> 1e-6)")
        leaves = [t.detach().clone() for t in graph._leaves]
        enc0 = multinn.tree_leaves(p0.encoder)
        if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(
                multinn.tree_leaves(graph.params.encoder),
                multinn.tree_leaves(eager.params.encoder), enc0)):
            fail("a group changed the frozen DBN encoder")
        _build.launches.clear()
        eager.train_step(eager._to_device(xs[0]), key)
        torch.cuda.synchronize()
        per_step = dict(_build.launches)
        _build.launches.clear()
        graph.run_group(xs, key)
        torch.cuda.synchronize()
        if dict(_build.launches) != dict(g.launches):
            fail(f"phase 13: a replay added {dict(_build.launches)}, the "
                 f"capture recorded {dict(g.launches)}")
        fam = [k for k in ("gibbs_chain", "nade_ll_fwd", "nade_ll_bwd")
               if per_step.get(k)]
        if not fam or any(g.launches[k] != spc * per_step[k] for k in fam):
            fail(f"phase 13: replay launches {dict(g.launches)} vs {spc} x "
                 f"one eager step's {per_step}")
        graph_ms = cuda_ms(lambda: graph.run_group(xs, key), 3) / spc
        busy_ms, _ = device_busy_fn(lambda: graph.run_group(xs, key), 1,
                                    spc)
        peak = peak_for(cfg.model.matmul_dtype,
                        torch.backends.cuda.matmul.allow_tf32)
        return dict(diff=diff, leaves=leaves, eager_ms=eager_ms,
                    graph_ms=graph_ms,
                    frames=batch * 64 / graph_ms * 1e3, busy_ms=busy_ms,
                    mfu=mfu(train_step_flops(cfg.model, batch, 64),
                            graph_ms / 1e3, peak), peak=peak.name,
                    capture_s=g.capture_s, pool=g.graph.pool_bytes,
                    per_step={k: v / spc for k, v in g.launches.items()})

    def device_busy_fn(fn, reps, steps):
        """The profiler's kernel time per step over ``reps`` calls."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        return (sum(e.self_device_time_total for e in kernels) / 1e3
                / (reps * steps)), kernels

    groups = {"rbm": group_check(FLAGSHIP, 16, 13),
              "nade": group_check(NADE_FLAGSHIP, 64, 14)}

    def run_main(run_dir, epochs):
        rc = train_cli.main([
            "--config", "configs/synthetic_smoke.json", "--device", "cuda",
            "--model.n_hidden=150", "--model.n_rnn=100",
            "--data.window=64", "--data.batch_size=16",
            "--data.synthetic_songs=500", f"--train.steps_per_call={spc}",
            f"--train.epochs={epochs}", "--train.ckpt_every_steps=24",
            "--train.keep_last=1", f"--train.run_dir={run_dir}"])
        if rc != 0:
            fail(f"phase 13: multinn_torch.train.main exited {rc}")

    main_dir = f"{tmp}/main"
    _build.launches.clear()                  # the train entry point starts
    t_main = time.perf_counter()
    run_main(main_dir, 2)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    main_launches = dict(_build.launches)    # ... and ends here
    ck = Checkpointer(f"{main_dir}/ckpt", keep_last=1)
    steps, best = ck.all_steps(), ck.best_step()
    from multinn_torch.data.datasets import Dataset
    from multinn_torch.utils.config import load_json
    n_batches = Dataset(load_json(f"{main_dir}/config.json").data).n_batches()
    n_steps = 2 * n_batches
    if n_batches < 2 * spc:
        fail(f"phase 13: an epoch of {n_batches} batches holds fewer than "
             f"two groups of {spc}")
    if steps[-1] != n_steps or best is None or set(steps) != {n_steps, best}:
        fail(f"phase 13: checkpoints {steps} (best {best}) break the "
             f"retention policy at {n_steps} steps")
    with open(f"{main_dir}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    events = [n for n in os.listdir(f"{main_dir}/tb")
              if n.startswith("events.out.tfevents.")]
    if not (os.path.exists(f"{main_dir}/config.json") and events
            and {r["split"] for r in rows} == {"train", "valid"}
            and all(np.isfinite(r["loss"]) for r in rows)):
        fail(f"phase 13: the run's files: {sorted(os.listdir(main_dir))}, "
             f"{len(rows)} metric rows")
    per_gibbs = groups["rbm"]["per_step"]["gibbs_chain"]
    if main_launches.get("gibbs_chain", 0) < (n_steps + 2) * per_gibbs:
        fail(f"phase 13: the chain launched {main_launches} times in "
             f"{n_steps} steps (at least {(n_steps + 2) * per_gibbs})")
    # resume: epoch 1 alone, then a second call resumes into epoch 2
    run_main(f"{tmp}/resume", 1)
    run_main(f"{tmp}/resume", 2)
    want, _ = ck.restore(n_steps)
    got, _ = Checkpointer(f"{tmp}/resume/ckpt", keep_last=1).restore(n_steps)
    resume_diff = rel_diff(got["params"], want["params"])
    if not resume_diff <= 1e-6:
        fail(f"phase 13: the resumed run's params differ by "
             f"{resume_diff:.3e} of max|p| from the uninterrupted run's")
    for fam, r in groups.items():
        busy = (f"kernel time per step {r['busy_ms']:.3f} ms (device busy "
                f"{r['busy_ms'] / r['graph_ms']:.1%})" if r["busy_ms"] else
                "device busy share not measured (the profiler saw no "
                "device time)")
        say(f"phase 13 {fam} group of {spc} (B={16 if fam == 'rbm' else 64}"
            f" T=64): graph vs eager params max diff {r['diff']:.3e} of "
            f"max|p|; graph step {r['graph_ms']:.3f} ms = "
            f"{r['frames']:.0f} frames/s, MFU {r['mfu']:.4%} of the "
            f"{r['peak']}, eager step {r['eager_ms']:.3f} "
            f"ms in the same call; {busy}; capture {r['capture_s']:.2f} s, "
            f"graph pool {r['pool']} bytes; launches per replayed step "
            f"{r['per_step']}")
    say(f"phase 13 train entry point: main() {n_steps} steps in 2 epochs "
        f"({main_s:.1f} s, capture included), checkpoints {steps} (best "
        f"{best}), {len(rows)} metric rows, events {events[0]}; launches "
        f"{main_launches}; resumed run vs uninterrupted {resume_diff:.3e} "
        f"of max|p|; phase {time.perf_counter() - t13:.1f} s")

    # 14. DBN encoders at the published widths ------------------------------
    t14 = time.perf_counter()
    import logging

    from multinn_torch.data.datasets import synthetic_song
    from multinn_torch.utils.config import apply_overrides
    from multinn_torch.utils.logging import setup_logger

    def windows_sum(*windows):
        out = {}
        for w in windows:
            for name, n in w.items():
                out[name] = out.get(name, 0) + n
        return out

    def rows_differ(a, b):
        return float((a != b).any(dim=1).float().mean())

    # the pre-training chains: CD-1 at D=84, H=64 over the shared encoder's
    # K*B*T = 5120 rows, and over each track's B*T = 1024 rows on its own
    # key (the per-track encoders); the configs' w_std and a visible bias
    # at the data's density, logit(0.06)
    g14 = torch.Generator().manual_seed(14)

    def pre_chain(n, d, h, v0=None):
        if v0 is None:
            v0 = (torch.rand(n, d, generator=g14) < 0.06).float()
        return [x.to(dev) for x in (
            v0, 0.01 * torch.randn(d, h, generator=g14),
            torch.full((d,), -2.75), torch.zeros(h))]

    key = sampling.PRNGKey(14, device=dev)
    shared = pre_chain(5120, 84, 64)
    sk, sp = (gibbs_cuda.gibbs_chain(key, *shared, 1),
              gibbs_cuda.gibbs_chain_plain(key, *shared, 1))
    pre_differ = rows_differ(sk, sp)
    pre_ms = graph_ms(lambda: gibbs_cuda.gibbs_chain(key, *shared, 1), 50)
    pre_plain = cuda_ms(lambda: gibbs_cuda.gibbs_chain_plain(key, *shared, 1),
                        5)
    pre_bound = bound(*gibbs_work(5120, 1, sk, 84, 64))
    tracks = [pre_chain(1024, 84, 64) for _ in range(5)]
    tkeys = sampling.split(key, 5)
    track_differ = max(rows_differ(gibbs_cuda.gibbs_chain(kk, *a, 1),
                                   gibbs_cuda.gibbs_chain_plain(kk, *a, 1))
                       for kk, a in zip(tkeys, tracks))
    tracks_ms = graph_ms(lambda: [gibbs_cuda.gibbs_chain(kk, *a, 1)
                                  for kk, a in zip(tkeys, tracks)], 20)
    # the upper layer of a two-layer DBN (64, 32): its visible units are
    # layer 0's sigmoid probabilities, not 0/1, so the hidden pass's
    # products round; the same gate as for binary rows
    x84 = shared[0]
    w0 = shared[1]
    upper = pre_chain(5120, 64, 32, v0=torch.sigmoid(
        (x84 @ w0) + 0.5 * torch.randn(64, generator=g14).to(dev)).cpu())
    upper_differ = rows_differ(gibbs_cuda.gibbs_chain(key, *upper, 1),
                               gibbs_cuda.gibbs_chain_plain(key, *upper, 1))
    if max(pre_differ, track_differ, upper_differ) > 0.01:
        fail(f"pre-training chains: rows differing {pre_differ} (5120 rows)"
             f", {track_differ} (per track), {upper_differ} (upper layer "
             f"64 -> 32); limit 0.01")
    say(f"phase 14 pre-training chains, D=84 H=64 k=1: N=5120 rows "
        f"differing {pre_differ:.4f}, kernel {pre_ms:.4f} ms, plain "
        f"{pre_plain:.3f} ms, bound {pre_bound[0]:.5f} ms ({pre_bound[1]}); "
        f"5 tracks x 1024 rows on their own keys: worst rows differing "
        f"{track_differ:.4f}, the five {tracks_ms:.4f} ms; upper layer "
        f"(64 -> 32, real-valued v0) N=5120 rows differing "
        f"{upper_differ:.4f} (limit 0.01 for all); {smi}")

    log_lines = []
    handler = logging.Handler()
    handler.emit = lambda record: log_lines.append(record.getMessage())
    setup_logger().addHandler(handler)
    dbn = {}
    for fam, path, fused_gen in (
            ("nade", "configs/lpd5_feedback_rnnnade.json",
             lambda p, k, h0, c0, v0, n, impl: gen_fused_nade.generate_nade(
                 k, p.decoder, h0, c0, v0, n, impl=impl)),
            ("rbm", "configs/lpd5_multinn_rnnrbm.json",
             lambda p, k, h0, c0, v0, n, impl: gen_fused_rbm.generate_rbm(
                 k, p.decoder, h0, c0, v0, n, p.cfg.gen_k, impl=impl))):
        t_fam = time.perf_counter()
        cfg14 = apply_overrides(load_json(path), [
            "data.source=synthetic", f"train.run_dir={tmp}/dbn_{fam}"])
        mcfg = cfg14.model
        p0 = multinn.init(mcfg, torch.Generator().manual_seed(140),
                          device=dev)
        trainer = Trainer(cfg14, params=p0)
        log_lines.clear()
        _build.launches.clear()              # pre-training starts here
        t0 = time.perf_counter()
        trainer.pretrain_encoders()
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        pre_launches = dict(_build.launches)     # ... and ends here
        cd = [ln for ln in log_lines if "cd-loss" in ln]
        cal = trainer.calibration
        if (not cd or not np.isfinite(float(cd[-1].split()[-1]))
                or cal is None or not 0.5 <= cal["ratio"] <= 2.0
                or pre_launches.get("gibbs_chain", 0)
                < trainer.dataset.n_batches("train")):
            fail(f"phase 14 {fam}: pre-training {cd} {cal} {pre_launches}")
        params = multinn.tree_map(lambda t: t.detach().clone(),
                                  trainer.params)
        del trainer
        # one group of 24 steps by replay against eager, from the
        # pre-trained params; the encoder stays bit-identical
        grp = group_check(dataclasses.asdict(mcfg), 16, 141, p0=params)
        # the kernel at the latent width against its plain version
        gk = sampling.PRNGKey(142, device=dev)
        run = lambda *a: fused_gen(params, gk, *a)
        rows = primed(params, 8)
        same8, h_err = match16(run, rows, 7, f"dbn {fam}")
        if fam == "nade":
            dens, gap = density_gap(run, rows, f"dbn {fam}")
            gap_at = "T=1024 B=8"
        else:
            # gen_k=25: the plain version takes about 0.14 s a step, so the
            # same 8192 frames per track come from T=128 at B=64
            rows64 = primed(params, 64)
            dens = [run(*rows64, 128, impl)[0].mean(dim=(0, 1, 3))
                    for impl in ("cuda", "plain")]
            gap = float((dens[0] - dens[1]).abs().max())
            if not gap <= 0.01:
                fail(f"phase 14 rbm: per-track density gap {gap} (limit "
                     f"0.01)")
            dens = [[round(float(x), 4) for x in d] for d in dens]
            gap_at = "T=128 B=64"
        st8 = multinn.init_state(params, 8)
        lat8 = run(*[torch.stack([getattr(c, n) for c in st8.decoder.cell])
                     for n in ("h", "c")], st8.decoder.v_prev, 1024,
                   "cuda")[0]
        kern_ms = cuda_ms(lambda: run(
            *[torch.stack([getattr(c, n) for c in st8.decoder.cell])
              for n in ("h", "c")], st8.decoder.v_prev, 1024, "cuda"), 3)
        kb = bound(*fused_work(params, lat8, st8.decoder.v_prev,
                               mcfg.gen_k))
        st1 = multinn.init_state(params, 1)
        b1_ms = cuda_ms(lambda: multinn._generate_fused(
            params, gk, st1, 1024, impl="cuda"), 3)
        # the service at batch 8: 16 plain and 8 seeded requests
        seeds14 = (np.random.default_rng(143).random((8, 64, 5, 84)) < 0.1
                   ).astype(np.uint8)
        _build.launches.clear()              # the DBN serving path starts
        svc = GenerationService(cfg14, params, ServeConfig(
            batch=8, n_steps=1024, seed_steps=64, seed=0))
        futs = svc.submit_many(16) + [svc.submit(seed=x) for x in seeds14]
        served = [f.result(timeout=600) for f in futs]
        stats = svc.stats()
        svc.close()
        torch.cuda.synchronize()
        serve_launches = dict(_build.launches)   # ... and ends here
        kern = "gen_fused_" + fam
        if (stats["errors"] or stats["batches"] != 3
                or not serve_launches.get(kern)
                or any(r.roll.shape != (1024, 5, 84)
                       or not np.isin(r.roll, (0, 1)).all()
                       for r in served)):
            fail(f"phase 14 {fam}: service {stats} {serve_launches}")
        density = float(np.mean([r.roll.mean() for r in served]))
        lat = stats["latency_ms"]
        dbn[fam] = dict(params=params, cfg=cfg14,
                        windows=(pre_launches, serve_launches))
        busy = (f"{grp['busy_ms'] / grp['graph_ms']:.1%}" if grp["busy_ms"]
                else "not measured")
        say(f"phase 14 {path} (synthetic source, K=5 D=84 -> "
            f"{mcfg.feature_dim()} latents, H=150 U=100, B=16 T=64): "
            f"pre-training {cfg14.train.pretrain_encoder_epochs} epochs "
            f"{pre_s:.2f} s, {cd[-1]}, decode "
            f"calibration {cal['ratio']:.3f}x (data {cal['data_mean']:.4f},"
            f" decode {cal['decode_mean']:.4f}), launches {pre_launches}; "
            f"group of {spc}: graph vs eager {grp['diff']:.3e} of max|p|, "
            f"encoder bit-identical, graph step {grp['graph_ms']:.3f} ms = "
            f"{grp['frames']:.0f} frames/s (eager {grp['eager_ms']:.3f} ms)"
            f", device busy {busy}; fused at D={mcfg.feature_dim()}: T=16 "
            f"B=8 {same8}/8 identical (final h err {h_err:.2e}), {gap_at} "
            f"per-track latent density kernel {dens[0]} plain {dens[1]} "
            f"(gap {gap:.4f}); kernel B=8 T=1024 {kern_ms:.3f} ms (bound "
            f"{kb[0]:.4f} ms, {kb[1]}); 64-bar latency B=1 with the decode "
            f"{b1_ms:.3f} ms; service batch 8: {stats.get('songs_per_s', 0):.2f}"
            f" songs/s, p50 {lat['p50']:.1f} ms p95 {lat['p95']:.1f} ms, "
            f"note density {density:.4f}, launches {serve_launches}; "
            f"{time.perf_counter() - t_fam:.1f} s; {smi}")
    setup_logger().removeHandler(handler)
    say(f"phase 14 {time.perf_counter() - t14:.1f} s")

    # 15. accompaniment ------------------------------------------------------
    t15 = time.perf_counter()
    song_rng = np.random.default_rng(15)
    given_np = np.stack([synthetic_song(song_rng, 1024, 5, 84)
                         for _ in range(8)]).astype(np.float32)
    given = torch.from_numpy(given_np).to(dev)   # track 0 (drums) is given
    acc_windows = []
    for name, cfg15, params in (
            ("RBM flagship", cfg, p5),
            ("NADE flagship", ncfg9, p8),
            ("lpd5_feedback_rnnnade", dbn["nade"]["cfg"],
             dbn["nade"]["params"])):
        t_acc = time.perf_counter()
        key = sampling.PRNGKey(150, device=dev)
        st = multinn.init_state(params, 8)
        with torch.inference_mode():
            ak, ap = (multinn._generate_accomp_fused(
                params, key, st, given[:, :16], (0,), impl=impl)[1]
                for impl in ("cuda", "plain"))
            if not (torch.equal(ak[:, :, 0], given[:, :16, 0])
                    and torch.equal(ap[:, :, 0], given[:, :16, 0])):
                fail(f"phase 15 {name}: a given track did not pass through")
            a_same = int((ak == ap).flatten(1).all(dim=1).sum())
            if a_same < 7:
                fail(f"phase 15 {name}: {a_same} of 8 samples match plain")
            acc_ms = cuda_ms(lambda: multinn._generate_accomp_fused(
                params, key, st, given, (0,), impl="cuda"), 3)
            gen_ms = cuda_ms(lambda: multinn._generate_fused(
                params, key, st, 1024, impl="cuda"), 3)
            _build.launches.clear()          # the accompaniment path starts
            fk = multinn.generate_accompaniment(params, key, st, given,
                                                (0,))[1]
            sc = multinn.generate_accompaniment(params, key, st, given,
                                                (0,), fused=False)[1]
            torch.cuda.synchronize()
        dens = [r[:, :, 1:].mean(dim=(0, 1, 3)) for r in (fk, sc)]
        gap = float((dens[0] - dens[1]).abs().max())
        if not (gap <= 0.01 and torch.equal(fk[:, :, 0], given[:, :, 0])
                and torch.equal(sc[:, :, 0], given[:, :, 0])):
            fail(f"phase 15 {name}: fused vs scan density gap {gap}, or a "
                 f"given track changed")
        svc = GenerationService(cfg15, params, ServeConfig(
            batch=8, n_steps=1024, seed=0, accompany_tracks=(0,),
            accompany_steps=1024))
        g_req = given_np.astype(np.uint8)
        futs = (svc.submit_many(8, given=g_req[0])
                + svc.submit_many(8, given=g_req[1]) + svc.submit_many(8))
        served = [f.result(timeout=600) for f in futs]
        stats = svc.stats()
        svc.close()
        torch.cuda.synchronize()
        window = dict(_build.launches)       # ... and ends here
        acc_windows.append(window)
        passed = all(np.array_equal(served[i].roll[:, 0],
                                    g_req[i // 8, :, 0]) for i in range(16))
        if (not passed or stats["errors"] or stats["accompany_batches"] != 2
                or stats["batches"] != 3):
            fail(f"phase 15 {name}: service passed the given track "
                 f"{passed}, stats {stats}")
        lat = stats["latency_ms"]
        # the bound of the kernel's work (pass-through: the roll is its
        # output; a DBN's kernel bound is phase 14's)
        acc_bound = ("" if params.encoder else
                     ", bound {:.4f} ms ({})".format(*bound(*fused_work(
                         params, fk, st.decoder.v_prev, params.cfg.gen_k))))
        say(f"phase 15 accompaniment, {name}, given track 0 of a synthetic "
            f"roll: T=16 B=8 given tracks bit-equal, {a_same}/8 samples "
            f"identical to plain; T=1024 B=8 per-track density fused "
            f"{[round(float(x), 4) for x in dens[0]]} scan "
            f"{[round(float(x), 4) for x in dens[1]]} (gap {gap:.4f}); "
            f"fused B=8 T=1024 {acc_ms:.3f} ms{acc_bound} (unconditioned "
            f"{gen_ms:.3f} ms); service (16 accompaniment, "
            f"8 plain, batch 8): given track bit for bit, "
            f"{stats.get('songs_per_s', 0):.2f} songs/s, p50 "
            f"{lat['p50']:.1f} ms p95 {lat['p95']:.1f} ms; launches "
            f"{window}; {time.perf_counter() - t_acc:.1f} s; {smi}")
    say(f"phase 15 {time.perf_counter() - t15:.1f} s")

    # 16. the entry points on the card ----------------------------------------
    t16 = time.perf_counter()
    import base64
    import contextlib
    import http.client
    import io
    import threading

    from multinn_torch import evaluate as evaluate_cli
    from multinn_torch import generate as generate_cli
    from multinn_torch import serve as serve_cli
    from multinn_torch.data import midi as midi_mod
    from multinn_torch.data import pianoroll as pr
    from multinn_torch.data.datasets import parse_midi_file
    from multinn_torch.serving.service import _resolve_transport
    from multinn_torch.training.generator import Generator
    from multinn_torch.utils import images, tb
    from multinn_torch.utils.config import load_run_config

    windows16 = []               # each entry point's launch window

    def windowed(fn):
        """``fn()`` in a launch window of its own: (result, launches,
        seconds of wall time)."""
        torch.cuda.synchronize()
        _build.launches.clear()              # the window starts here
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        w = dict(_build.launches)            # ... and ends here
        windows16.append(w)
        return out, w, secs

    def quiet(fn):
        """``fn()`` with its standard output kept: (result, the output)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn()
        return out, buf.getvalue()

    # the NADE run: the same config at the NADE flagship's widths, 20 steps
    # in one epoch, with image summaries
    nade_dir = f"{tmp}/nade_run"
    rc, w_img, img_s = windowed(lambda: train_cli.main([
        "--config", "configs/synthetic_smoke.json", "--device", "cuda",
        "--model.decoder_type=rnn-nade", "--model.n_hidden=150",
        "--model.n_rnn=100", "--data.window=64", "--data.batch_size=16",
        "--data.synthetic_songs=200", "--train.steps_per_call=10",
        "--train.epochs=1", "--train.image_summaries=true",
        f"--train.run_dir={nade_dir}"]))
    if rc != 0:
        fail(f"phase 16: the image-summary run exited {rc}")
    (ev_path,) = [os.path.join(nade_dir, "tb", n)
                  for n in os.listdir(os.path.join(nade_dir, "tb"))]
    imgs = {tag: im for e in tb.read_events(ev_path)
            for tag, im in e["images"].items()}
    nade_cfg = load_run_config(nade_dir, None, [])
    from multinn_torch.data.datasets import Dataset
    ref_roll = Dataset(nade_cfg.data).windows["valid"][0]
    if set(imgs) != {"valid/reference", "valid/sample"}:
        fail(f"phase 16: the run's image summaries are {sorted(imgs)}")
    if not np.array_equal(images.decode_png(imgs["valid/reference"]["png"]),
                          images.render_pianoroll(ref_roll)):
        fail("phase 16: valid/reference is not the first validation window")
    sample_img = images.decode_png(imgs["valid/sample"]["png"])
    # every colour a sum of track colours: the image render_pianoroll makes
    palette = {tuple(np.clip(sum((images._TRACK_COLORS[i].astype(int)
                                  for i in range(5) if m >> i & 1),
                                 np.zeros(3, int)), 0, 255))
               for m in range(32)}
    colours = {tuple(c) for c in sample_img.reshape(-1, 3).tolist()}
    if (sample_img.shape != (168, 128, 3) or not colours <= palette
            or images.encode_png(sample_img) != imgs["valid/sample"]["png"]
            or len(colours) < 2):
        fail(f"phase 16: valid/sample {sample_img.shape} with colours "
             f"{sorted(colours - palette)[:4]} outside the palette")
    if w_img.get("nade_sample", 0) < 64:
        fail(f"phase 16: the summary's 64 steps launched the sampler "
             f"{w_img.get('nade_sample', 0)} times")
    say(f"phase 16 image summaries: NADE flagship run of 20 steps "
        f"({img_s:.1f} s), valid/reference equal to render_pianoroll of the "
        f"first validation window, valid/sample {sample_img.shape} in the "
        f"palette ({len(colours)} colours); launches {w_img}")

    runs16 = {"rbm": main_dir, "nade": nade_dir}
    gen_args = ["--generate.n_steps=1024", "--generate.n_samples=8"]
    cli_times = {}
    for fam, run in runs16.items():
        fused = "gen_fused_rbm" if fam == "rbm" else "gen_fused_nade"
        (rc, out), w_gen, gen_s = windowed(lambda: quiet(
            lambda: generate_cli.main(["--run", run] + gen_args)))
        if rc != 0 or not w_gen.get(fused):
            fail(f"phase 16 {fam}: generate exited {rc}, launches {w_gen}")
        sdir = os.path.join(run, "samples")
        names = os.listdir(sdir)
        n_mid = sum(n.endswith(".mid") for n in names)
        n_png = sum(n.endswith(".png") for n in names)
        with np.load(os.path.join(sdir, "pianorolls.npz")) as z:
            cli_rolls = z["rolls"]
        if (n_mid, n_png, cli_rolls.shape) != (8, 8, (8, 1024, 5, 84)):
            fail(f"phase 16 {fam}: {n_mid} MIDI, {n_png} PNG, rolls "
                 f"{cli_rolls.shape}")
        # the same generation in this process, phase by phase
        t0 = time.perf_counter()
        cfg16 = load_run_config(run, None, gen_args)
        tr16 = Trainer(cfg16, device="cuda")
        tr16.restore(tr16.ckpt.best_step())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gen16 = Generator(cfg16, tr16.params)
        seed16 = tr16.dataset.seed_windows("valid", n=8)[:, :16]
        rolls16 = gen16.finalize(gen16.generate(
            sampling.PRNGKey(cfg16.train.seed + 7, device=dev), 1024,
            seed=seed16))
        t2 = time.perf_counter()
        gen16.write_files(rolls16, f"{tmp}/files_{fam}")
        np.savez_compressed(f"{tmp}/files_{fam}/pianorolls.npz",
                            rolls=rolls16)
        t3 = time.perf_counter()
        tr16.close()
        if not np.array_equal(cli_rolls, rolls16):
            fail(f"phase 16 {fam}: the CLI's rolls differ from Generator."
                 f"generate with its key")
        cli_times[fam] = dict(cli=gen_s, restore=t1 - t0, generate=t2 - t1,
                              files=t3 - t2)
        say(f"phase 16 generate {fam}: main() {gen_s:.2f} s for 8 songs of "
            f"1024 steps ({n_mid} MIDI, {n_png} PNG, npz {cli_rolls.shape}, "
            f"density {cli_rolls.mean():.4f}), bit-equal to Generator.generate"
            f" with PRNGKey(seed + 7); in-process restore {t1 - t0:.2f} s, "
            f"generate {t2 - t1:.3f} s, write files {t3 - t2:.2f} s; "
            f"launches {w_gen}; {smi}")

    # accompaniment from a MIDI file the port wrote: its drum track given
    given_mid = os.path.join(main_dir, "samples", "sample_000.mid")
    (rc, _), w_acc, acc_s = windowed(lambda: quiet(lambda: generate_cli.main(
        ["--run", main_dir, "--accompany", given_mid,
         "--accompany-tracks", "0", "--generate.out_dir=accomp"]
        + gen_args)))
    with np.load(os.path.join(main_dir, "accomp", "pianorolls.npz")) as z:
        acc_rolls = z["rolls"]
    given16 = parse_midi_file(given_mid, load_run_config(
        main_dir, None, []).data.spec(), use_native=False)[:1024]
    if (rc != 0 or acc_rolls.shape != (1,) + given16.shape
            or not np.array_equal(acc_rolls[0, :, 0], given16[:, 0])):
        fail(f"phase 16: accompaniment exited {rc}, rolls "
             f"{acc_rolls.shape}, or the given track did not pass through")
    say(f"phase 16 generate --accompany sample_000.mid --accompany-tracks 0: "
        f"{acc_s:.2f} s, rolls {acc_rolls.shape}, the given track bit for "
        f"bit; launches {w_acc}")

    for fam, run in runs16.items():
        fused = "gen_fused_rbm" if fam == "rbm" else "gen_fused_nade"
        kernel = "gibbs_chain" if fam == "rbm" else "nade_ll_fwd"
        (rc, _), w_ev, ev_s = windowed(lambda: quiet(
            lambda: evaluate_cli.main(["--run", run, "--latest", "--split",
                                       "valid", "--n-gen", "32"])))
        with open(os.path.join(run, "eval_valid.json")) as f:
            report = json.load(f)
        keys = {"run", "step", "split", "encoding", "frame",
                "musical_generated", "musical_corpus",
                "musical_significance"}
        if rc != 0 or set(report) != keys:
            fail(f"phase 16 {fam}: evaluate exited {rc}, report keys "
                 f"{sorted(report)}")
        if not (w_ev.get(kernel) and w_ev.get(fused)):
            fail(f"phase 16 {fam}: evaluate launched {w_ev}")
        tr16 = Trainer(load_run_config(run, None, []), device="cuda")
        tr16.restore()
        frame = tr16.evaluate("valid")
        tr16.close()
        diff = max(abs(report["frame"][k] - v) / max(1.0, abs(v))
                   for k, v in frame.items())
        if set(frame) != set(report["frame"]) or not diff <= 1e-6:
            fail(f"phase 16 {fam}: frame differs from Trainer.evaluate by "
                 f"{diff}")
        cli_times[fam]["evaluate"] = ev_s
        sig = report["musical_significance"]
        n_ev = load_run_config(run, None, []).generate.n_steps
        say(f"phase 16 evaluate {fam}: main() {ev_s:.2f} s (valid split, 32 "
            f"songs of the config's {n_ev} steps), frame vs Trainer.evaluate max rel diff "
            f"{diff:.2e}, ll_per_frame {report['frame']['ll_per_frame']:.4f},"
            f" note density generated "
            f"{sig['note_density']['generated_mean']} corpus "
            f"{sig['note_density']['corpus_mean']}; launches {w_ev}")

    # serve the RBM run over HTTP, batch 8, at phase 6's gen_k
    args16, ovr16 = serve_cli.parse_args([
        "--run", main_dir, "--port", "0", "--batch", "8", "--n-steps",
        "1024", "--seed-steps", "64", "--accompany-tracks", "0",
        "--generate.gibbs_k=10"])           # phase 6's 10 sweeps a step
    ready, box = threading.Event(), []

    def post(port, payload):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", "/generate", json.dumps(payload))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        t1 = time.perf_counter()
        conn.close()
        return resp.status, body, t0, t1

    def serve_all():
        th = threading.Thread(target=serve_cli.serve,
                              args=(args16, ovr16, ready, box), daemon=True)
        th.start()
        if not ready.wait(timeout=600):
            fail("phase 16: the server did not start")
        httpd, svc16 = box[0]
        port = httpd.server_port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        res = [None] * 8

        def one(i):
            res[i] = post(port, {"format": "roll_packed", "n": 8})
        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        seed = np.zeros((64, 5, 84), np.uint8)
        seed[::4, 1, 40] = 1
        buf = io.BytesIO()
        np.savez_compressed(buf, roll=seed)
        given = acc_rolls[0, :1024]
        extra = [post(port, {"format": "midi"}),
                 post(port, {"format": "roll", "seed_b64": base64.b64encode(
                     buf.getvalue()).decode()}),
                 post(port, {"format": "roll", "given_b64": base64.b64encode(
                     midi_mod.dumps(pr.roll_to_midi(
                         given, svc16.cfg.data.spec()))).decode()})]
        conn.request("GET", "/stats")
        st = json.loads(conn.getresponse().read())
        conn.close()
        httpd.shutdown()
        th.join(timeout=120)
        alive = (th.is_alive() or svc16._dispatcher.is_alive()
                 or svc16._drainer.is_alive())
        return health, res, extra, st, alive, given

    (health, res, extra, st16, alive, given), w_srv, srv_s = windowed(
        serve_all)
    bulk_ok = all(r[0] == 200 and r[1]["shape"] == [8, 1024, 5, 84]
                  for r in res)
    given_back = None
    if extra[2][0] == 200:
        with np.load(io.BytesIO(base64.b64decode(
                extra[2][1]["roll_b64"]))) as z:
            given_back = z["roll"]
    if (not health.get("ok") or not bulk_ok
            or [e[0] for e in extra] != [200, 200, 200]
            or given_back is None
            or not np.array_equal(given_back[:len(given), 0], given[:, 0])
            or given_back[len(given):, 0].any()
            or st16["errors"] or st16["requests"] != 67 or alive
            or not w_srv.get("gen_fused_rbm")):
        fail(f"phase 16 serve: health {health}, bulk {bulk_ok}, extra "
             f"{[e[0] for e in extra]}, stats {st16}, threads alive {alive}")
    first = min(r[2] for r in res)
    last = max(r[3] for r in res)
    http_rtt = np.asarray([r[3] - r[2] for r in res]) * 1e3
    http_songs = 64 / (last - first)
    slat = st16["latency_ms"]
    say(f"phase 16 serve (RBM run, batch 8, HTTP): 64 songs in 8 requests "
        f"of n=8 roll_packed in {last - first:.2f} s = {http_songs:.1f} "
        f"songs/s, request p50 {np.percentile(http_rtt, 50):.1f} ms p95 "
        f"{np.percentile(http_rtt, 95):.1f} ms, service p50 "
        f"{slat['p50']:.1f} ms p95 {slat['p95']:.1f} ms, transport "
        f"{st16['transport']} (phase 6 in process: {serve6['songs']:.1f} "
        f"songs/s, p50 {serve6['p50']:.1f} ms p95 {serve6['p95']:.1f} ms); "
        f"midi, seed_b64 and given_b64 answered 200 (the given track bit "
        f"for bit); stats {st16['requests']} requests {st16['batches']} "
        f"batches; shut down clean; {srv_s:.1f} s with warm-up; launches "
        f"{w_srv}")

    # the transports: dispatch to host roll, packed against sparse
    def drain(gen, b, packed):
        key = sampling.PRNGKey(16, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen.generate_async(key, 1024, b, packed=packed)
        out.event.synchronize()
        t1 = time.perf_counter()
        rolls = gen.fetch_rolls(out)
        t2 = time.perf_counter()
        return rolls, (t2 - t0) * 1e3, (t2 - t1) * 1e3

    def transports():
        rows = []
        # about 1 % of cells on, the density the sparse records are for
        quiet_bv = dataclasses.replace(p5, decoder=dataclasses.replace(
            p5.decoder, bv=p5.decoder.bv - 4.5))
        for name, prm in (("phase 5", p5), ("phase 5, bv - 4.5", quiet_bv)):
            gen = Generator(cfg, prm)
            for b in (8, 128):
                got = {True: [], "sparse": []}
                for packed in (True, "sparse", "sparse", True):
                    rolls, total, fetch = drain(gen, b, packed)
                    got[packed].append((rolls, total, fetch,
                                        gen.last_sparse_count,
                                        gen.last_sparse_overflowed))
                want = got[True][0][0]
                if not all(np.array_equal(r[0], want)
                           for r in got[True] + got["sparse"]):
                    fail(f"phase 16 transport {name} B={b}: sparse and "
                         f"packed rolls differ")
                rows.append(dict(
                    name=name, b=b, density=float(want.mean()),
                    packed=[r[1] for r in got[True]],
                    sparse=[r[1] for r in got["sparse"]],
                    packed_fetch=[r[2] for r in got[True]],
                    sparse_fetch=[r[2] for r in got["sparse"]],
                    count=got["sparse"][0][3],
                    overflow=got["sparse"][0][4],
                    auto=_resolve_transport("auto", cfg, b, 1024, dev),
                    auto_ref=_resolve_transport("auto", cfg, b, 1024)))
        return rows

    rows16, _, _ = windowed(transports)
    for r in rows16:
        say(f"phase 16 transport {r['name']} B={r['b']} T=1024 (density "
            f"{r['density']:.4f}, sparse records {r['count']}, overflow "
            f"{r['overflow']}): dispatch to host roll packed "
            f"{min(r['packed']):.1f} ms sparse {min(r['sparse']):.1f} ms "
            f"(fetch after the event packed {min(r['packed_fetch']):.2f} ms "
            f"sparse {min(r['sparse_fetch']):.2f} ms; runs packed "
            f"{[round(x, 1) for x in r['packed']]} sparse "
            f"{[round(x, 1) for x in r['sparse']]}); rolls bit-equal; auto "
            f"resolves to {'sparse' if r['auto'] == 'sparse' else 'packed'}"
            f" on the card (the reference's rule: "
            f"{'sparse' if r['auto_ref'] == 'sparse' else 'packed'}); {smi}")
    say(f"phase 16 launches, its windows summed: {windows_sum(*windows16)}")
    say(f"phase 16 {time.perf_counter() - t16:.1f} s; CLI seconds "
        f"{ {k: {n: round(x, 2) for n, x in v.items()} for k, v in cli_times.items()} }")

    # 17. joint mode, Hessian-free training and the bf16 matmul policy -----
    t17 = time.perf_counter()
    windows17 = []               # each path's launch window

    def window17(fn):
        """``fn()`` in a launch window of its own: (result, launches)."""
        torch.cuda.synchronize()
        _build.launches.clear()              # the window starts here
        out = fn()
        torch.cuda.synchronize()
        w = dict(_build.launches)            # ... and ends here
        windows17.append(w)
        return out, w

    JOINT = dict(FLAGSHIP, mode="joint")     # K=5 x D=84 -> one 420 track
    JOINT_NADE = dict(NADE_FLAGSHIP, mode="joint")
    jg = torch.Generator().manual_seed(17)   # phase 17's own inputs
    joint_rows = []
    # the Gibbs chain of joint training: N = B*T = 1024 rows, D=420, whose
    # W (252 KB) stays in device memory
    jargs = gibbs_inputs(1024, 420, 150, gen=jg)
    jkey = sampling.PRNGKey(170, device=dev)
    jplan = gibbs_cuda.launch_plan(1024, _build.sm_count(jargs[0]), 420, 150)
    jk = gibbs_cuda.gibbs_chain(jkey, *jargs, 1)
    j_differ = rows_differ(jk, gibbs_cuda.gibbs_chain_plain(jkey, *jargs, 1))
    if j_differ > 0.01:
        fail(f"phase 17: gibbs at N=1024 D=420: {j_differ:.4f} of rows differ")
    j_ms = graph_ms(lambda: gibbs_cuda.gibbs_chain(jkey, *jargs, 1), 20)
    j_plain = cuda_ms(lambda: gibbs_cuda.gibbs_chain_plain(jkey, *jargs, 1),
                      5)
    jb = bound(*gibbs_work(1024, 1, jk, 420, 150))
    joint_rows.append(f"gibbs_chain N=1024 D=420 H=150 k=1 plan {jplan}: "
                      f"rows differing {j_differ:.4f}, kernel {j_ms:.4f} ms, "
                      f"plain {j_plain:.3f} ms, bound {jb[0]:.4f} ms "
                      f"({jb[1]})")
    # the sampler on the joint scan path's 8 rows of 420 dims
    sargs = nade_inputs(8, 420, 150, gen=jg)
    sk = nade_cuda.nade_sample(jkey, *sargs, (8,))
    s_differ = int((sk != nade_cuda.nade_sample_plain(jkey, *sargs, (8,))
                    ).any(dim=1).sum())
    if s_differ > 1:
        fail(f"phase 17: nade_sample at D=420: {s_differ} of 8 rows differ")
    s_ms = graph_ms(lambda: nade_cuda.nade_sample(jkey, *sargs, (8,)), 50)
    s_plain = cuda_ms(lambda: nade_cuda.nade_sample_plain(jkey, *sargs,
                                                          (8,)), 3)
    sb = bound(*nade_sample_work(8, 420, 150, sk))
    joint_rows.append(f"nade_sample 8 rows D=420 H=150 plan "
                      f"{nade_cuda.sample_plan(420, 150)}: rows differing "
                      f"{s_differ}, kernel {s_ms:.4f} ms = "
                      f"{s_ms * 1e3 / 420:.4f} us per dim, plain "
                      f"{s_plain:.3f} ms, bound {sb[0]:.4f} ms ({sb[1]})")
    # the likelihood pair at K=1, N=4096, D=420
    xl, wl, vl, bvl, bhl, cot = ll_inputs(1, 4096, 420, gen=jg)
    lk, ak = nade_ll.nade_ll_fwd(xl, wl, vl, bvl, bhl)
    lp, ap = nade_ll.nade_ll_fwd_plain(xl, wl, vl, bvl, bhl)
    jl_err = float((lk - lp).abs().max())
    jl_ratio = max(grad_err(a, b) for a, b in zip(
        nade_ll.nade_ll_bwd(xl, wl, vl, cot, ak, want_dx=True),
        nade_ll.nade_ll_bwd_plain(xl, wl, vl, cot, ap, want_dx=True)))
    if not (jl_err <= 1e-4 and jl_ratio <= 1.0):
        fail(f"phase 17: likelihood at K=1 N=4096 D=420: logits err "
             f"{jl_err}, gradients at {jl_ratio} of the tolerance")
    fwd17 = graph_ms(lambda: nade_ll.nade_ll_fwd(xl, wl, vl, bvl, bhl), 20)
    bwd17 = graph_ms(lambda: nade_ll.nade_ll_bwd(xl, wl, vl, cot, ak,
                                                 want_dx=False), 20)
    fwd17_plain = cuda_ms(
        lambda: nade_ll.nade_ll_fwd_plain(xl, wl, vl, bvl, bhl), 3)
    bwd17_plain = cuda_ms(lambda: nade_ll.nade_ll_bwd_plain(
        xl, wl, vl, cot, ap, want_dx=False), 3)
    fb = bound(*nade_ll_fwd_work(1, 4096, 420, 150, xl))
    bb = bound(*nade_ll_bwd_work(1, 4096, 420, 150, xl))
    sms = _build.sm_count(xl)
    joint_rows.append(
        f"nade_ll K=1 N=4096 D=420 H=150 (plans fwd "
        f"{nade_ll.fwd_plan(1, 4096, 420, 150, sms)}, bwd "
        f"{nade_ll.bwd_plan(1, 4096, 420, 150, sms)}): logits err "
        f"{jl_err:.2e}, gradients at {jl_ratio:.4f} of the tolerance; fwd "
        f"{fwd17:.4f} ms (plain {fwd17_plain:.3f}, bound {fb[0]:.4f} ms "
        f"{fb[1]}), bwd {bwd17:.4f} ms (plain {bwd17_plain:.3f}, bound "
        f"{bb[0]:.4f} ms {bb[1]})")
    del lk, ak, lp, ap
    say(f"phase 17 joint-shape kernels: {'; '.join(joint_rows)}; {smi}")

    # both whole-generation kernels at Keff=1, D=420: against the plain
    # version at T=16 B=8, against the scan path at T=1024 B=8, the kernel's
    # times, B=1 64-bar latency and a service at batch 8
    for fam, model in (("rbm", JOINT), ("nade", JOINT_NADE)):
        jcfg = multinn.MultINNConfig(**dict(model, w_std=0.1))
        if not (gen_fused_rbm.supported(jcfg, 1, 1024)
                and gen_fused_rbm.supported(jcfg, 8, 1024)
                if fam == "rbm" else
                gen_fused_nade.supported_nade(jcfg, 1, 1024)
                and gen_fused_nade.supported_nade(jcfg, 8, 1024)):
            fail(f"phase 17 {fam}: the gate refuses the joint flagship")
        pj = multinn.init(jcfg, jg, device=dev)
        pj = dataclasses.replace(pj, decoder=dataclasses.replace(
            pj.decoder, bv=pj.decoder.bv + torch.linspace(
                -3.0, 1.0, 84, device=dev).repeat(5)))
        gkey = sampling.PRNGKey(171, device=dev)
        if fam == "rbm":
            gen = lambda h0, c0, v0, n, impl: gen_fused_rbm.generate_rbm(
                gkey, pj.decoder, h0, c0, v0, n, 10, impl=impl)
        else:
            gen = lambda h0, c0, v0, n, impl: gen_fused_nade.generate_nade(
                gkey, pj.decoder, h0, c0, v0, n, impl=impl)
        rows = primed(pj, 8)
        (same8, h_err), w_match = window17(
            lambda: match16(gen, rows, 7, f"phase 17 joint {fam}"))
        if not w_match.get("gen_fused_" + fam):
            fail(f"phase 17 {fam}: the fused kernel did not launch "
                 f"({w_match})")
        k16_ms = cuda_ms(lambda: gen(*rows, 16, "cuda"), 3)
        p16_ms = cuda_ms(lambda: gen(*rows, 16, "plain"), 1, warm=False)
        state8 = multinn.prime(pj, multinn.init_state(pj, 8), (torch.rand(
            8, 16, 5, 84, generator=jg) < 0.1).float().to(dev))
        (_, fused_roll), w_fused = window17(lambda: multinn.generate(
            pj, gkey, state8, 1024))
        (_, scan_roll), w_scan = window17(lambda: multinn.generate(
            pj, sampling.PRNGKey(172, device=dev), state8, 1024,
            fused=False))
        scan_kernel = "gibbs_chain" if fam == "rbm" else "nade_sample"
        if (not w_fused.get("gen_fused_" + fam)
                or not w_scan.get(scan_kernel)):
            fail(f"phase 17 {fam}: fused window {w_fused}, scan window "
                 f"{w_scan}")
        dens = [r.mean(dim=(0, 1, 3)) for r in (fused_roll, scan_roll)]
        gap = float((dens[0] - dens[1]).abs().max())
        if not gap <= 0.01:
            fail(f"phase 17 {fam}: per-track density fused {dens[0]} vs "
                 f"scan {dens[1]} (gap {gap}, limit 0.01)")
        st8 = multinn.init_state(pj, 8)
        run8 = lambda: multinn._generate_fused(pj, gkey, st8, 1024,
                                               impl="cuda")[1]
        roll8 = run8()
        k8_ms = cuda_ms(run8, 3)
        kb = bound(*fused_work(pj, roll8, st8.decoder.v_prev, 10))
        st1 = multinn.init_state(pj, 1)
        b1_ms = cuda_ms(lambda: multinn._generate_fused(
            pj, gkey, st1, 1024, impl="cuda"), 3)
        cfg17 = ExperimentConfig(
            model=jcfg, data=DataConfig(n_tracks=5, pitch_min=24,
                                        pitch_max=107),
            generate=GenerateConfig(n_steps=1024, seed_steps=64))
        seeds17 = (np.random.default_rng(173).random((8, 64, 5, 84)) < 0.1
                   ).astype(np.uint8)

        def serve17():
            svc = GenerationService(cfg17, pj, ServeConfig(
                batch=8, n_steps=1024, seed_steps=64, seed=0))
            futs = svc.submit_many(16) + [svc.submit(seed=x)
                                          for x in seeds17]
            served = [f.result(timeout=600) for f in futs]
            stats = svc.stats()
            svc.close()
            return served, stats

        (served, stats), w_serve = window17(serve17)
        if (stats["errors"] or stats["batches"] != 3
                or not w_serve.get("gen_fused_" + fam)
                or any(r.roll.shape != (1024, 5, 84) for r in served)):
            fail(f"phase 17 {fam}: service {stats} {w_serve}")
        lat = stats["latency_ms"]
        say(f"phase 17 joint {fam} generation (K=5 x D=84 -> one track of "
            f"420, H=150 U=100): T=16 B=8 {same8}/8 samples equal the plain "
            f"version (final h err {h_err:.2e}); T=1024 B=8 per-track "
            f"density fused {[round(float(x), 4) for x in dens[0]]} scan "
            f"{[round(float(x), 4) for x in dens[1]]} (gap {gap:.4f}); "
            f"kernel B=8 T=1024 {k8_ms:.3f} ms (bound {kb[0]:.4f} ms, "
            f"{kb[1]}); at T=16 B=8 kernel {k16_ms:.3f} ms, plain "
            f"{p16_ms:.1f} ms; B=1 64-bar latency {b1_ms:.3f} ms; service "
            f"batch 8: "
            f"{stats.get('songs_per_s', 0):.2f} songs/s, p50 "
            f"{lat['p50']:.1f} ms p95 {lat['p95']:.1f} ms; launches fused "
            f"{w_fused}, scan {w_scan}, service {w_serve}; {smi}")
        if fam == "nade":
            say(f"phase 17 joint nade speculative depths, T=1024, rolls, h "
                f"and c bit-identical across depths: "
                f"{nade_depths(pj, (1, 8), 'phase 17 joint nade')}; {smi}")
        del fused_roll, scan_roll, roll8

    # joint training: captured groups of 24 against eager, both families
    for fam, model, batch, seed in (("rbm", JOINT, 16, 174),
                                    ("nade", JOINT_NADE, 64, 175)):
        (r, ), w = window17(lambda: (group_check(model, batch, seed), ))
        busy = (f"kernel time per step {r['busy_ms']:.3f} ms (device busy "
                f"{r['busy_ms'] / r['graph_ms']:.1%})" if r["busy_ms"] else
                "device busy share not measured")
        say(f"phase 17 joint {fam} group of {spc} (B={batch} T=64): graph vs "
            f"eager {r['diff']:.3e} of max|p|; graph step "
            f"{r['graph_ms']:.3f} ms = {r['frames']:.0f} frames/s, eager "
            f"step {r['eager_ms']:.3f} ms; {busy}; capture "
            f"{r['capture_s']:.2f} s, pool {r['pool']} bytes; launches per "
            f"replayed step {r['per_step']}")

    # the joint composer alias through the entry points: train -> generate
    jrun = f"{tmp}/joint_cli"

    def joint_cli():
        rc = train_cli.main([
            "--config", "configs/synthetic_smoke.json", "--device", "cuda",
            "--model.mode=composer", "--model.n_hidden=150",
            "--model.n_rnn=100", "--data.synthetic_songs=16",
            "--train.epochs=1", f"--train.run_dir={jrun}"])
        if rc != 0:
            fail(f"phase 17: composer train.main exited {rc}")
        rc = generate_cli.main(["--run", jrun, "--generate.n_steps=256",
                                "--generate.n_samples=2"])
        if rc != 0:
            fail(f"phase 17: composer generate.main exited {rc}")

    (_, w_cli) = window17(lambda: quiet(joint_cli))
    with np.load(f"{jrun}/samples/pianorolls.npz") as z:
        cli_roll = z["rolls"]
    if (cli_roll.shape != (2, 256, 5, 84) or not w_cli.get("gibbs_chain")
            or not w_cli.get("gen_fused_rbm")):
        fail(f"phase 17: composer CLI rolls {cli_roll.shape}, launches "
             f"{w_cli}")
    say(f"phase 17 composer CLI: train.main (1 epoch, K=5 x D=84 joint, "
        f"H=150) then generate.main (2 songs of 256 steps) {cli_roll.shape}"
        f", launches {w_cli}")

    # Hessian-free training on the NADE flagship, one fixed batch
    hf_model = multinn.MultINNConfig(**NADE_FLAGSHIP)
    hsrc = RollSource(4, 2, 64, 176, fixed=True)
    hx = np.stack([next(hsrc.batches("train", shuffle=False))] * 2)
    hp0 = multinn.init(hf_model, torch.Generator().manual_seed(176),
                       device=dev)

    def hf_trainer(name, spc_hf, cg_iters=25):
        cfg = ExperimentConfig(model=hf_model, train=TrainConfig(
            optimizer="hf", hf_cg_iters=cg_iters, steps_per_call=spc_hf,
            log_every_steps=1000, run_dir=f"{tmp}/hf_{name}"))
        return Trainer(cfg, hsrc, params=hp0)

    eager_hf = hf_trainer("eager", 2)
    eager_hf.capture_groups = False
    hkey = sampling.PRNGKey(176, device=dev)
    x64 = eager_hf._to_device(hx[0])
    with torch.no_grad():
        nll0 = float(multinn.loss(eager_hf.params, hkey, x64,
                                  detailed=False)[0])
    t_hf = time.perf_counter()
    _, w_hf = window17(lambda: eager_hf.run_group(hx, hkey))
    hf_eager_ms = (time.perf_counter() - t_hf) * 1e3 / 2
    with torch.no_grad():
        nll2 = float(multinn.loss(eager_hf.params, hkey, x64,
                                  detailed=False)[0])
    accepted = int(eager_hf.opt_state.accepted)
    hf_lam = float(eager_hf.opt_state.lam)
    if not (nll2 < nll0 and accepted >= 1
            and w_hf.get("nade_ll_fwd") and w_hf.get("nade_ll_bwd")):
        fail(f"phase 17 hf: NLL {nll0} -> {nll2}, {accepted} accepted, "
             f"launches {w_hf}")
    graph_hf = hf_trainer("graph", 2)
    graph_hf.run_group(hx, hkey)                # warm-up, capture, replay
    torch.cuda.synchronize()
    hf_diff = rel_diff(graph_hf._leaves, eager_hf._leaves)
    if not (hf_diff <= 1e-6
            and int(graph_hf.opt_state.accepted) == accepted):
        fail(f"phase 17 hf: graph vs eager params differ by {hf_diff:.3e} "
             f"of max|p|, accepts {int(graph_hf.opt_state.accepted)} vs "
             f"{accepted}")
    hg = graph_hf.group_graph
    hf_capture = (hg.capture_s, hg.graph.pool_bytes)
    # the CG share on one clock: CUDA events around replays of the same
    # captured group with 25 CG iterations and with none
    hf_graph_ms = cuda_ms(lambda: graph_hf.run_group(hx, hkey), 2,
                          warm=False) / 2
    del eager_hf, graph_hf, hg
    cg0_hf = hf_trainer("cg0", 2, cg_iters=0)
    hf_cg0_ms = cuda_ms(lambda: cg0_hf.run_group(hx, hkey), 2) / 2
    del cg0_hf
    cg_share = (hf_graph_ms - hf_cg0_ms) / hf_graph_ms
    say(f"phase 17 hf (NADE flagship K=5 D=84, B=64 T=64, cg_iters=25, "
        f"one fixed batch): NLL {nll0:.4f} -> {nll2:.4f} after 2 "
        f"macro-steps, {accepted} accepted, lambda {hf_lam:.4f}; captured "
        f"group of 2 vs eager {hf_diff:.3e} of max|p| (the HF groups run as "
        f"CUDA graphs); "
        f"macro-step graph {hf_graph_ms:.2f} ms, eager {hf_eager_ms:.2f} ms "
        f"(host clock); the same graph with cg_iters=0 {hf_cg0_ms:.2f} ms, "
        f"so the 25 CG iterations take {cg_share:.1%} of the macro-step "
        f"({(hf_graph_ms - hf_cg0_ms) / 25:.2f} ms each, CUDA events); "
        f"capture {hf_capture[0]:.2f} s, pool {hf_capture[1]} bytes; "
        f"launches {w_hf}; {smi}")

    # the entry point at the same widths: train.main with the HF optimizer
    # on 80 synthetic songs (2 windows of 64 each), one group of 2 steps
    wide = ["--config", "configs/synthetic_smoke.json", "--device", "cuda",
            "--model.n_hidden=150", "--model.n_rnn=100", "--data.window=64",
            "--data.batch_size=64", "--data.synthetic_songs=80",
            "--train.epochs=1", "--train.log_every_steps=1"]

    def cli_rows(run_dir, args):
        rc = train_cli.main(wide + args + [f"--train.run_dir={run_dir}"])
        with open(f"{run_dir}/metrics.jsonl") as f:
            return rc, [json.loads(line) for line in f]

    t_cli = time.perf_counter()
    ((hrc, hrows), _), w_hcli = window17(lambda: quiet(lambda: cli_rows(
        f"{tmp}/hf_cli", ["--model.decoder_type=rnn-nade",
                          "--train.optimizer=hf", "--train.hf_cg_iters=25"])))
    hf_cli_s = time.perf_counter() - t_cli
    hsteps = [r for r in hrows if "hf_lambda" in r]
    if (hrc != 0 or not hsteps or not w_hcli.get("nade_ll_fwd")
            or not w_hcli.get("nade_ll_bwd")):
        fail(f"phase 17 hf: train.main --train.optimizer=hf exited {hrc}, "
             f"rows {hrows[:2]}, launches {w_hcli}")
    last = {k: hsteps[-1][k] for k in ("loss", "hf_lambda", "hf_accepted")}
    say(f"phase 17 hf train.main (rnn-nade, H=150 U=100, B=64 T=64, "
        f"cg_iters=25, 1 epoch): {len(hsteps)} logged rows, last {last}, "
        f"{hf_cli_s:.1f} s, launches {w_hcli}")
    # ... and under the bf16 matmul policy, rnn-rbm, the config's optimizer
    t_cli = time.perf_counter()
    ((brc, brows), _), w_bcli = window17(lambda: quiet(lambda: cli_rows(
        f"{tmp}/bf16_cli", ["--model.matmul_dtype=bf16"])))
    bf16_cli_s = time.perf_counter() - t_cli
    bsteps = [r for r in brows if r["split"] == "train" and "loss" in r]
    if (brc != 0 or not bsteps or not w_bcli.get("gibbs_chain")
            or not all(math.isfinite(r["loss"]) for r in bsteps)):
        fail(f"phase 17 bf16: train.main --model.matmul_dtype=bf16 exited "
             f"{brc}, rows {brows[:2]}, launches {w_bcli}")
    say(f"phase 17 bf16 train.main (rnn-rbm, H=150 U=100, B=64 T=64, 1 "
        f"epoch): {len(bsteps)} metric rows, last loss "
        f"{bsteps[-1]['loss']:.4f}, {bf16_cli_s:.1f} s, launches {w_bcli}")

    # the bf16 policy: captured groups from phase 13's params, batches and
    # key (which must end elsewhere than f32's did, or the policy never
    # reached the captured step), and 20 steps that track f32
    for fam, model, batch, seed, seed20 in (
            ("rbm", FLAGSHIP, 16, 13, 177),
            ("nade", NADE_FLAGSHIP, 64, 14, 178)):
        m16 = dict(model, matmul_dtype="bf16")
        (r, ), w = window17(lambda: (group_check(m16, batch, seed), ))
        f32 = groups[fam]
        off_f32 = rel_diff(r["leaves"], f32["leaves"])
        if not off_f32 > 0.0:
            fail(f"phase 17 bf16 {fam}: the captured bf16 group ended on "
                 f"f32's params")
        src = RollSource(20, 2, batch, seed20)
        p0 = multinn.init(multinn.MultINNConfig(**model),
                          torch.Generator().manual_seed(seed20), device=dev)
        pair = {}
        for dt in ("bf16", "f32"):
            cfg = ExperimentConfig(
                model=multinn.MultINNConfig(**dict(model, matmul_dtype=dt)),
                train=TrainConfig(log_every_steps=1000,
                                  run_dir=f"{tmp}/bf16_{fam}_{dt}"))
            pair[dt] = Trainer(cfg, src, params=p0)
        worst = 0.0
        for i, b in enumerate(src.batches("train", shuffle=False)):
            k = sampling.PRNGKey(1000 + i, device=dev)
            l16 = float(pair["bf16"].train_step(pair["bf16"]._to_device(b),
                                                k)["loss"])
            l32 = float(pair["f32"].train_step(pair["f32"]._to_device(b),
                                               k)["loss"])
            worst = max(worst, abs(l16 - l32) / (0.05 * (abs(l32) + 1.0)))
        if not 0.0 < worst <= 1.0:
            fail(f"phase 17 bf16 {fam}: the loss left f32's bound or never "
                 f"differed from it (|l16 - l32| / 0.05 (|l32| + 1) = "
                 f"{worst:.3f})")
        kern = (f"kernel time per step {r['busy_ms']:.3f} ms vs f32 "
                f"{f32['busy_ms']:.3f} ms = "
                f"{r['busy_ms'] / f32['busy_ms']:.3f}x"
                if r["busy_ms"] and f32["busy_ms"] else
                "kernel time not measured")
        say(f"phase 17 bf16 {fam} group of {spc} (B={batch} T=64): graph vs "
            f"eager {r['diff']:.3e} of max|p|, vs phase 13's f32 group "
            f"{off_f32:.3e} of max|p|; graph step "
            f"{r['graph_ms']:.3f} ms vs f32 {f32['graph_ms']:.3f} ms (phase "
            f"13) = {r['graph_ms'] / f32['graph_ms']:.3f}x, {kern}; 20 "
            f"steps' loss vs f32 at "
            f"{worst:.4f} of the bound; launches per replayed step "
            f"{r['per_step']}")
        del pair
    say(f"phase 17 launches, its windows summed: {windows_sum(*windows17)}; "
        f"phase {time.perf_counter() - t17:.1f} s")

    # 18. process meshes -----------------------------------------------------
    # every rank shares this one card (gloo, host staging) except the NCCL
    # world of one; the kernels were built above, so the ranks only load
    # them. Its seconds are those of a correctness run, not a speed.
    t18 = time.perf_counter()
    windows18 = phase18(os.path.join(tmp, "mesh"), say, fail)
    say(f"phase 18 launches, its windows summed: {windows_sum(*windows18)}; "
        f"phase {time.perf_counter() - t18:.1f} s")

    # 19. the port's scripts ------------------------------------------------
    # each run's JSON on a line of its own; a script that exits non-zero, a
    # request unanswered, a loss not finite or the chain out of its gate
    # fails the phase
    t19 = time.perf_counter()
    import contextlib
    import io

    from multinn_torch.scripts import (ingest_bench, prepare_dataset,
                                       real_corpus_drill, scale_stress,
                                       serve_loadtest)
    windows19 = []

    def window19(fn):
        """``fn()`` in a launch window of its own: (result, launches)."""
        torch.cuda.synchronize()
        _build.launches.clear()              # the window starts here
        out = fn()
        torch.cuda.synchronize()
        w = dict(_build.launches)            # ... and ends here
        windows19.append(w)
        return out, w

    def script(name, main_fn, argv):
        """``main_fn(argv)`` with its standard output captured: (the JSON
        of its last line or None, seconds); a non-zero exit fails."""
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main_fn(argv)
        secs = time.perf_counter() - t0
        lines = buf.getvalue().strip().splitlines()
        if rc != 0:
            fail(f"phase 19: {name} exited {rc}: {lines[-3:]}")
        try:
            return json.loads(lines[-1]), secs
        except (IndexError, json.JSONDecodeError):
            return None, secs

    # prepare -> cache directory -> one replayed group -> stats
    p19 = os.path.join(tmp, "p19")
    script("prepare_dataset synth", prepare_dataset.main,
           ["synth", "--out", f"{p19}/midi", "--songs", "8"])
    script("prepare_dataset cachedir", prepare_dataset.main,
           ["cachedir", "--source", "midi_dir", "--path", f"{p19}/midi",
            "--window", "64", "--out", f"{p19}/cache"])
    n_cache = Dataset(DataConfig.from_preset(
        "synthetic", source="cache_dir", path=f"{p19}/cache", window=64,
        batch_size=8)).n_batches()
    if n_cache < 2:
        fail(f"phase 19: the cache holds {n_cache} batches of 8 (< 2)")
    t0 = time.perf_counter()
    rc, w = window19(lambda: train_cli.main([
        "--config", "configs/synthetic_smoke.json", "--device", "cuda",
        "--data.source=cache_dir", f"--data.path={p19}/cache",
        "--data.window=64", "--data.batch_size=8", "--model.n_hidden=150",
        "--model.n_rnn=100", f"--train.steps_per_call={n_cache}",
        "--train.epochs=1", f"--train.run_dir={p19}/run"]))
    cache_train_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"phase 19: train on the cache directory exited {rc}")
    with open(f"{p19}/run/metrics.jsonl") as f:
        cache_rows = [json.loads(line) for line in f]
    if not (w.get("gibbs_chain", 0) >= 5 * n_cache and cache_rows
            and all(np.isfinite(r["loss"]) for r in cache_rows)):
        fail(f"phase 19: the cache run's launches {w}, metrics {cache_rows}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = prepare_dataset.main(["stats", "--source", "cache_dir",
                                   "--path", f"{p19}/cache", "--window",
                                   "64"])
    if rc != 0:
        fail(f"phase 19: prepare_dataset stats exited {rc}")
    say("phase 19 prepare_dataset: synth 8 songs -> cachedir -> "
        f"multinn_torch.train --data.source=cache_dir (one replayed group "
        f"of {n_cache} steps, {cache_train_s:.1f} s, launches {w}, valid "
        f"loss {cache_rows[-1]['loss']:.4f}) -> stats:")
    say(json.dumps(json.loads(buf.getvalue())))

    # the serving load test on both flagships at batch 8, 64 bars a song
    lt_base = ["--config", "configs/synthetic_smoke.json", "--batch", "8",
               "--n-steps", "1024", "--model.n_hidden=150",
               "--model.n_rnn=100", "--model.gen_k=10"]
    lt_runs = (("rbm direct", ["--requests", "256", "--clients", "32"]),
               ("rbm open-loop", ["--open-loop", "--requests", "512"]),
               ("rbm http", ["--http", "--requests", "64", "--clients",
                             "8"]),
               ("nade direct", ["--requests", "256", "--clients", "32",
                                "--model.decoder_type=rnn-nade"]))
    for name, extra in lt_runs:
        (rep, secs), w = window19(lambda: script(
            f"serve_loadtest {name}", serve_loadtest.main, lt_base + extra))
        kernel = "gen_fused_nade" if "nade" in name else "gen_fused_rbm"
        if (rep is None or rep["failed"] or rep["errors"]
                or rep["completed"] != rep["requests"] or not w.get(kernel)):
            fail(f"phase 19: serve_loadtest {name}: {rep}, launches {w}")
        say(f"phase 19 serve_loadtest {name} ({secs:.1f} s, launches {w}):")
        say(json.dumps(rep))

    # scale stress: the flagship far past its widths, f32 and bf16
    stress = {}
    for dtype in ("f32", "bf16"):
        (rep, w) = window19(lambda: scale_stress.measure(
            1024, 512, 256, 64, n_iter=10, dtype=dtype, device="cuda"))
        if not rep["loss_finite"]:
            fail(f"phase 19: scale_stress {dtype}: the loss is not finite")
        stress[dtype] = rep
        say(f"phase 19 scale_stress {dtype} (launches {w}):")
        say(json.dumps(rep))
    # #1 at the scale-stress shape: the CD chain's N = B*T rows per track
    sg = torch.Generator().manual_seed(19)
    sa = gibbs_inputs(16384, 84, 1024, gen=sg)
    skey = sampling.PRNGKey(190, device=dev)
    splan = gibbs_cuda.launch_plan(16384, _build.sm_count(sa[0]), 84, 1024)
    s_out = gibbs_cuda.gibbs_chain(skey, *sa, 1)
    s_differ = rows_differ(s_out, gibbs_cuda.gibbs_chain_plain(skey, *sa, 1))
    if s_differ > 0.01:
        fail(f"phase 19: gibbs at N=16384 D=84 H=1024: {s_differ:.4f} of "
             f"rows differ (limit 0.01)")
    s_ms = graph_ms(lambda: gibbs_cuda.gibbs_chain(skey, *sa, 1), 20)
    s_plain = cuda_ms(lambda: gibbs_cuda.gibbs_chain_plain(skey, *sa, 1), 3)
    s_bound = bound(*gibbs_work(16384, 1, s_out, 84, 1024))
    say(f"phase 19 gibbs_chain N=16384 D=84 H=1024 k=1 plan {splan}: rows "
        f"differing {s_differ:.4f}, kernel {s_ms:.4f} ms, plain "
        f"{s_plain:.3f} ms, bound {s_bound[0]:.4f} ms ({s_bound[1]}), "
        f"launches per replayed step "
        f"{stress['f32']['launches_per_step'].get('gibbs_chain')}; {smi}")

    # ingest and the real-corpus drill's stand-in path
    rep, secs = script("ingest_bench", ingest_bench.main,
                       ["--files", "1000", "--python-files", "50"])
    say(f"phase 19 ingest_bench ({secs:.1f} s):")
    say(json.dumps(rep))
    # cut: one epoch of each stand-in (the shipped configs' widths) in
    # batches of 8: at the configs' 32 the stand-in's 30 training windows
    # make no full batch, and the epoch would take no step
    drill_cut = ["--train.epochs=1", "--train.ckpt_every_steps=0",
                 "--data.batch_size=8"]
    for corpus, run_name in (("jsb", "jsb_rnnrbm_standin"),
                             ("nottingham", "nottingham_rnnnade_standin")):
        (rep, secs), w = window19(lambda: script(
            f"real_corpus_drill {corpus}", real_corpus_drill.main,
            ["--corpus", corpus, "--data-root", f"{p19}/drill_data",
             "--run-root", f"{p19}/drill_runs", "--synthetic-standin",
             "--device", "cuda"] + drill_cut))
        row = (rep or {}).get(run_name)
        with open(f"{p19}/drill_runs/drill_{run_name}/eval_test.json") as f:
            drill_step = json.load(f)["step"]
        if (row is None or not np.isfinite(row["ll_per_frame"])
                or not drill_step > 0):
            fail(f"phase 19: real_corpus_drill {corpus}: {rep}, evaluated "
                 f"at step {drill_step}")
        say(f"phase 19 real_corpus_drill --synthetic-standin {corpus} "
            f"({' '.join(drill_cut)}; {drill_step} steps, {secs:.1f} s, "
            f"launches {w}):")
        say(json.dumps(row))
    say(f"phase 19 launches, its windows summed: {windows_sum(*windows19)}; "
        f"phase {time.perf_counter() - t19:.1f} s")

    # 20. the capacity modes -------------------------------------------------
    # the whole-generation kernels in bf16 storage (the RBM's wdtype, the
    # NADE's aux_dtype) beside f32, where the reference's rule picks bf16:
    # the Lakh config, the flagship RBM at B=32 and 128, the NADE flagship
    # at B=64. Each comparison with a plain version at T=16 in the same
    # mode, at least 7 of 8 samples identical; the launch windows hold the
    # runs of the modes, not the comparisons.
    t20 = time.perf_counter()
    from multinn_torch.utils.config import load_json
    bf16, f32 = torch.bfloat16, torch.float32
    windows20 = []

    def window20(fn):
        """``fn()`` in a launch window of its own."""
        torch.cuda.synchronize()
        _build.launches.clear()              # the window starts here
        out = fn()
        torch.cuda.synchronize()
        windows20.append(dict(_build.launches))   # ... and ends here
        return out

    def plan20(dec, batch, dtype):
        """w_smem bits and s_max of the launch's plan in a storage mode."""
        k, d, hid = dec.w.shape
        u, gw = dec.wuh.shape[1], dec.cell[0].wh.shape[-1]
        pl = _build.ops().gen_fused_plan(
            int(hasattr(dec, "v")), k, d, hid, u,
            len(dec.cell), int(gw == 4 * u), batch, int(dtype == bf16))
        return f"w_smem {pl[2]:#b} s_max {pl[5]}"

    def modes20(name, params, batch, n_steps, gen, gen_k):
        """``gen(rows, n_steps, dtype)`` at T=``n_steps`` from a fresh
        state in both modes: ms per call (CUDA events), the bound, the
        plan. Returns one line."""
        st = multinn.init_state(params, batch)
        rows = (torch.stack([c.h for c in st.decoder.cell]),
                torch.stack([c.c for c in st.decoder.cell]),
                st.decoder.v_prev)
        parts = []
        for dtype in (f32, bf16):
            roll = gen(rows, n_steps, dtype)[0]
            ms = cuda_ms(lambda: gen(rows, n_steps, dtype), 2)
            bms, by = bound(*fused_work(params, roll, rows[2], gen_k, dtype))
            parts.append(f"{'bf16' if dtype == bf16 else 'f32'} {ms:.3f} ms "
                         f"(bound {bms:.4f} ms, {by}; "
                         f"{plan20(params.decoder, batch, dtype)}; density "
                         f"{float(roll.mean()):.4f})")
            del roll
        return f"{name} B={batch} T={n_steps}: " + ", ".join(parts)

    def seeded20(model, seed):
        """Seeded params at phase 5's w_std and visible-bias ramp."""
        pr = multinn.init(dataclasses.replace(model, w_std=0.1),
                          torch.Generator().manual_seed(seed), device=dev)
        return dataclasses.replace(pr, decoder=dataclasses.replace(
            pr.decoder, bv=pr.decoder.bv + torch.linspace(
                -3.0, 1.0, 84, device=dev)))

    def check20(gen, rows, name):
        """The bf16 mode's kernel against its plain version at T=16 from
        ``rows`` (match16: at least 7 of 8 samples identical, outside the
        launch windows), and both timed there (CUDA events). Returns
        (samples identical, final h max err, kernel ms, plain ms)."""
        b = rows[2].shape[1]
        n_same, err = match16(lambda *a: gen(a[:3], a[3], bf16, a[4]), rows,
                              -(-7 * b // 8), name)
        k_ms = cuda_ms(lambda: gen(rows, 16, bf16, "cuda"), 2)
        p_ms = cuda_ms(lambda: gen(rows, 16, bf16, "plain"), 1, warm=False)
        return n_same, err, k_ms, p_ms

    def check_line(b, c):
        return (f"kernel vs plain in bf16 T=16 B={b} {c[0]}/{b} identical "
                f"(need {-(-7 * b // 8)}), final h max err {c[1]:.2e}, "
                f"kernel {c[2]:.3f} ms, plain {c[3]:.1f} ms")

    # (i) the Lakh config (README's example): K=5, D=84, H=200, U=150,
    # gen_k=25, 4 samples of 2048 steps
    lakh = load_json("configs/lakh_16th_128bar.json")
    lk = lakh.model.gen_k
    if gen_fused_rbm.rbm_weight_dtype(lakh.model,
                                      lakh.generate.n_samples) != bf16:
        fail("phase 20: the rule does not pick bf16 for the Lakh config at "
             f"B={lakh.generate.n_samples}")
    plk = seeded20(lakh.model, 20)
    key20 = sampling.PRNGKey(20, device=dev)

    def lgen(rows, n_steps, dtype, impl=None):
        return gen_fused_rbm.generate_rbm(key20, plk.decoder, *rows, n_steps,
                                          lk, impl=impl, wdtype=dtype)

    rows20 = primed(plk, 8)
    lcheck = check20(lgen, rows20, "phase 20 lakh bf16")
    # the auto rule at the config's batch runs the bf16 kernel
    rows4 = tuple(x[..., :4, :] for x in rows20)
    auto = window20(lambda: lgen(rows4, 16, None))
    if not all(torch.equal(x, y) for x, y in zip(auto, lgen(rows4, 16, bf16))):
        fail("phase 20 lakh: wdtype=None at B=4 is not the bf16 launch")
    if torch.equal(auto[1], lgen(rows4, 16, f32)[1]):
        fail("phase 20 lakh: the bf16 and f32 launches end in the same h")
    ldens = {dt: lgen(rows20, 1024, dt)[0].mean(dim=(0, 1, 3))
             for dt in (f32, bf16)}
    lgap = float((ldens[f32] - ldens[bf16]).abs().max())
    if not lgap <= 0.13:
        fail(f"phase 20 lakh: per-track density bf16 vs f32 gap {lgap} "
             f"(the reference's bound of the modes, 0.13)")
    say(f"phase 20 lakh (w_std 0.1, bv ramp): rule at B=4 bf16; "
        f"{check_line(8, lcheck)}; wdtype=None at B=4 equals the bf16 "
        f"launch; T=1024 B=8 per-track density f32 "
        f"{[round(float(x), 4) for x in ldens[f32]]} bf16 "
        f"{[round(float(x), 4) for x in ldens[bf16]]} (max gap {lgap:.4f})")
    say("phase 20 " + window20(lambda: modes20(
        "lakh", plk, lakh.generate.n_samples, lakh.generate.n_steps, lgen,
        lk)) + f"; {smi}")
    del rows20, rows4, auto, ldens

    # (ii) the flagship RBM at serving batches 32 and 128 (the rule: bf16)
    pf = seeded20(multinn.MultINNConfig(**FLAGSHIP), 21)

    def fgen(rows, n_steps, dtype, impl=None):
        return gen_fused_rbm.generate_rbm(key20, pf.decoder, *rows, n_steps,
                                          10, impl=impl, wdtype=dtype)

    fcheck = check20(fgen, primed(pf, 32), "phase 20 flagship rbm bf16")
    flines = [window20(lambda: modes20("flagship rbm", pf, b, 1024, fgen, 10))
              for b in (32, 128)]
    say(f"phase 20 flagship rbm: rule at B=32 / 128 "
        f"{gen_fused_rbm.rbm_weight_dtype(pf.cfg, 32)} / "
        f"{gen_fused_rbm.rbm_weight_dtype(pf.cfg, 128)}; "
        f"{check_line(32, fcheck)}; {'; '.join(flines)}; {smi}")

    # (iii) the NADE flagship at B=64, at the auto depth
    pn = seeded20(multinn.MultINNConfig(**NADE_FLAGSHIP), 22)

    def ngen(rows, n_steps, dtype, impl=None):
        return gen_fused_nade.generate_nade(key20, pn.decoder, *rows, n_steps,
                                            impl=impl, aux_dtype=dtype)

    ncheck = check20(ngen, primed(pn, 64), "phase 20 nade flagship bf16")
    nline = window20(lambda: modes20("nade flagship", pn, 64, 1024, ngen, 0))
    say(f"phase 20 nade flagship: rule at B=64 "
        f"{gen_fused_nade.nade_aux_dtype(pn.cfg, 64)}, auto depth f32 "
        f"{gen_fused_nade.auto_depth(pn.decoder, 64, f32)} bf16 "
        f"{gen_fused_nade.auto_depth(pn.decoder, 64, bf16)}; "
        f"{check_line(64, ncheck)}; {nline}; {smi}")
    w20 = windows_sum(*windows20)
    if not (w20.get("gen_fused_rbm") and w20.get("gen_fused_nade")):
        fail(f"phase 20: its windows launched {w20}")
    say(f"phase 20 launches, its windows summed: {w20}; phase "
        f"{time.perf_counter() - t20:.1f} s")

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                           "multinn_tpu"))
    if leaked:
        fail(f"the port imported the JAX package or JAX: {leaked[:5]}")

    # name: (source, the TPU kernel it replaces, the path whose window
    # counted its launches)
    sources = {"threefry2x32": ("multinn_torch/csrc/threefry.cu",
                                "multinn_tpu/ops/kernel_prng.py:29",
                                rbm_launches),
               "gibbs_chain": ("multinn_torch/csrc/gibbs_chain.cu",
                               "multinn_tpu/ops/gibbs_pallas.py:62",
                               rbm_launches),
               "gen_fused_rbm": ("multinn_torch/csrc/gen_fused_rbm.cu",
                                 "multinn_tpu/ops/gen_fused_rbm.py:169",
                                 rbm_launches),
               "nade_sample": ("multinn_torch/csrc/nade_sample.cu",
                               "multinn_tpu/ops/nade_pallas.py:45",
                               nade_launches),
               "gen_fused_nade": ("multinn_torch/csrc/gen_fused_nade.cu",
                                  "multinn_tpu/ops/gen_fused_nade.py:242",
                                  nade_launches),
               "nade_ll_fwd": ("multinn_torch/csrc/nade_ll.cu",
                               "multinn_tpu/ops/nade_ll_pallas.py:123",
                               nade_train_launches),
               "nade_ll_bwd": ("multinn_torch/csrc/nade_ll.cu",
                               "multinn_tpu/ops/nade_ll_pallas.py:153",
                               nade_train_launches)}
    # each kernel's launches: its path's window above plus the windows of
    # the DBN paths (pre-training, serving) and of accompaniment
    new_windows = windows_sum(*dbn["nade"]["windows"], *dbn["rbm"]["windows"],
                              *acc_windows, *windows16, *windows17,
                              *windows18, *windows19, *windows20)
    say(f"launches in the DBN, accompaniment, entry-point, joint, HF, bf16, "
        f"mesh, script and capacity-mode windows: {new_windows}")
    shutil.rmtree(tmp, ignore_errors=True)
    say(f"total wall time {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=src, replaces=rep,
             launches=counts[n] + new_windows.get(n, 0), **results[n],
             library_ms=None)
        for n, (src, rep, counts) in sources.items()]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
