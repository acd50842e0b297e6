"""The rank side of the mesh tests (tests/test_torch_parallel.py,
tests/test_torch_seqpipe.py, tests/test_torch_mesh_graphs.py): jobs that
each rank of a gloo world on the CPU runs, spawned by ``run_world`` (and
``cards2``, an NCCL world of one card a rank, for
tests/test_torch_cuda.py). This module imports only torch, numpy and
multinn_torch, so a spawned rank never loads JAX.

A job is a function ``job(rank, world, out)`` that runs its cases and
writes their results as ``<out>/<case>.npz`` (rank 0's) and, where every
rank's copy is checked, ``<out>/<case>_r<rank>.npz``; the test process
compares them. The single-device references run in rank 0 of the same
job, on the same seeded data and parameters.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

TINY = dict(n_tracks=2, n_pitches=24, n_hidden=12, n_rnn=8, gen_k=2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:                 # a spawned rank finds the package
    sys.path.insert(0, ROOT)


# -- the harness --------------------------------------------------------------

def _entry(rank: int, world: int, out: str, job: str,
           backend: str = "gloo") -> None:
    torch.set_num_threads(1)
    from multinn_torch.parallel import mesh as mesh_mod
    mesh_mod.init_distributed(f"file://{out}/store_{job}", world, rank,
                              backend=backend)
    try:
        JOBS[job](rank, world, out)
        dist.barrier()
    except Exception:
        with open(os.path.join(out, f"{job}_error_r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        if backend == "nccl":
            # a rank that failed inside a collective or a capture can hang
            # in destroy_process_group: leave at once, so the world fails
            # now and not at its deadline
            os._exit(1)
        raise
    finally:
        dist.destroy_process_group()


def run_world(out, world: int, job: str, timeout: float = 240.0,
              backend: str = "gloo") -> None:
    """Spawn ``world`` ranks running ``job`` on ``backend`` (gloo on the
    CPU; ``nccl``: one card a rank) and wait at most ``timeout`` seconds;
    a rank that raises, or a world still running at the deadline (every
    rank is then killed), fails with the ranks' tracebacks."""
    import torch.multiprocessing as mp
    out = str(out)
    ctx = mp.start_processes(_entry, args=(world, out, job, backend),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.time() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
            if time.time() >= deadline:
                raise TimeoutError(f"{job}: the world of {world} ranks "
                                   f"still ran after {timeout} s")
    except Exception as e:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        errs = [open(os.path.join(out, n)).read() for n in
                sorted(os.listdir(out)) if n.startswith(f"{job}_error")]
        raise AssertionError(f"{job} failed: {e}\n" + "\n".join(errs))


def load(out, case: str, rank=None) -> dict:
    name = case if rank is None else f"{case}_r{rank}"
    with np.load(os.path.join(str(out), f"{name}.npz")) as f:
        return dict(f)


def _save(out, case: str, rank: int, every_rank: bool = False, **arrays):
    if every_rank:
        np.savez(os.path.join(out, f"{case}_r{rank}.npz"), **arrays)
    if rank == 0:
        np.savez(os.path.join(out, f"{case}.npz"), **arrays)


# -- configs and steps --------------------------------------------------------

def exp_cfg(run_dir, mesh=None, mode="per-track", dec="rnn-nade",
            window=8, songs=8, steps=32, model_kw=None, n_tracks=2,
            **train_kw):
    """The reference's small config (tests/test_parallel.py): K=2 (or
    ``n_tracks``: 4 is the JAX package's tiny multichip flagship), 24
    pitches, H=12, U=8, window 8, B=8."""
    from multinn_torch.models.multinn import MultINNConfig
    from multinn_torch.utils import config as cfg_mod
    data = cfg_mod.DataConfig.from_preset(
        "synthetic", n_tracks=n_tracks, pitch_min=40, pitch_max=63,
        window=window, batch_size=8, synthetic_songs=songs,
        synthetic_steps=steps)
    model = MultINNConfig(**dict(TINY, mode=mode, decoder_type=dec,
                                 n_tracks=n_tracks, **(model_kw or {})))
    train = cfg_mod.TrainConfig(**dict(dict(
        epochs=1, lr=1e-3, log_every_steps=100, ckpt_every_steps=0,
        run_dir=str(run_dir)), **train_kw))
    return cfg_mod.ExperimentConfig(
        name="par", data=data, model=model, train=train,
        mesh=mesh or cfg_mod.MeshConfig()).validate()


def mesh_cfg(**kw):
    from multinn_torch.utils.config import MeshConfig
    return MeshConfig(use_mesh=True, **kw)


def trainer(out, name, mesh=None, **kw):
    from multinn_torch.training.trainer import Trainer
    return Trainer(exp_cfg(os.path.join(out, name), mesh, **kw),
                   device="cpu")


def leaves(params):
    from multinn_torch.models import multinn
    return [t.detach().numpy().copy() for t in multinn.tree_leaves(params)]


def first_batch(t):
    return next(iter(t.dataset.batches("train", epoch=0)))


def one_step(t, seed: int = 123):
    """One hot-path step on the first train batch under PRNGKey(seed) (the
    reference's ``_one_step``): the whole params after it and the loss."""
    from multinn_torch.ops import sampling
    m = t.train_step(t._put_batch(first_batch(t)),
                     sampling.PRNGKey(seed, device="cpu"))
    return leaves(t.full_params()), float(m["loss"])


def step_case(out, rank, case, mesh, **kw):
    """One step on ``mesh`` and, in rank 0, on one device: saved as
    ``case`` with arrays p<i> / ref_p<i> and the losses."""
    t = trainer(out, case, mesh, **kw)
    got, loss = one_step(t)
    t.close()
    arrays = {f"p{i}": a for i, a in enumerate(got)}
    arrays["loss"] = np.float64(loss)
    if rank == 0:
        ref = trainer(out, case + "_ref", **kw)
        want, ref_loss = one_step(ref)
        ref.close()
        arrays.update({f"ref_p{i}": a for i, a in enumerate(want)})
        arrays["ref_loss"] = np.float64(ref_loss)
    _save(out, case, rank, every_rank=True, **arrays)


def rbm_shard_map_case(out, rank, case, n_data):
    """shard_map RBM: the mesh step against one optimizer step on the mean
    of the single-device gradients of each shard's rows under
    ``fold_in(key, shard)``, computed in rank 0."""
    from multinn_torch.models import multinn
    from multinn_torch.ops import sampling
    t = trainer(out, case, mesh_cfg(style="shard_map"), dec="rnn-rbm")
    got, loss = one_step(t)
    t.close()
    arrays = {f"p{i}": a for i, a in enumerate(got)}
    arrays["loss"] = np.float64(loss)
    if rank == 0:
        ref = trainer(out, case + "_ref", dec="rnn-rbm")
        batch = first_batch(ref)
        key = sampling.PRNGKey(123, device="cpu")
        per = len(batch) // n_data
        grads, losses = None, []
        for s in range(n_data):
            x = ref._to_device(batch[s * per:(s + 1) * per])
            loss_s, _ = multinn.loss(ref.params, sampling.fold_in(key, s), x,
                                     detailed=False)
            g = torch.autograd.grad(loss_s, ref._leaves)
            grads = list(g) if grads is None else [a + b for a, b in
                                                   zip(grads, g)]
            losses.append(float(loss_s.detach()))
        grads = [g / n_data for g in grads]
        ref.optimizer.update(ref._leaves, grads, ref.opt_state)
        arrays.update({f"ref_p{i}": a for i, a in
                       enumerate(leaves(ref.params))})
        arrays["ref_loss"] = np.float64(np.mean(losses))
        ref.close()
    _save(out, case, rank, **arrays)


def eval_case(out, rank, case, mesh, **kw):
    """``evaluate('valid')`` with a short tail batch (synthetic_steps=36,
    window 8: 4 full and 1 masked tail window per song; 9 valid windows
    at batch 8 leave a tail of 1) on ``mesh`` and, in rank 0, on one
    device."""
    t = trainer(out, case, mesh, songs=10, steps=36, **kw)
    got = t.evaluate("valid")
    t.close()
    arrays = {k: np.float64(v) for k, v in got.items()}
    if rank == 0:
        ref = trainer(out, case + "_ref", songs=10, steps=36, **kw)
        arrays.update({f"ref_{k}": np.float64(v)
                       for k, v in ref.evaluate("valid").items()})
        ref.close()
    _save(out, case, rank, **arrays)


def detailed_step_case(out, rank, case, mesh, **kw):
    """One detailed step (the form a group's last step takes) on ``mesh``
    and, in rank 0, on one device: every metric it returns."""
    from multinn_torch.ops import sampling

    def step(t):
        m = t.train_step(t._put_batch(first_batch(t)),
                         sampling.PRNGKey(123, device="cpu"), detailed=True)
        return {k: np.asarray(v.detach().numpy(), np.float64)
                for k, v in m.items()}
    t = trainer(out, case, mesh, **kw)
    arrays = step(t)
    t.close()
    if rank == 0:
        ref = trainer(out, case + "_ref", **kw)
        arrays.update({f"ref_{k}": v for k, v in step(ref).items()})
        ref.close()
    _save(out, case, rank, **arrays)


def hf_case(out, rank, case, mesh, **kw):
    """One Hessian-free macro-step (cg_iters=8) on ``mesh`` and, in rank 0,
    on one device: params, loss and the accept flag."""
    def step(t):
        from multinn_torch.ops import sampling
        m = t.train_step(t._put_batch(first_batch(t)),
                         sampling.PRNGKey(123, device="cpu"))
        return (leaves(t.full_params()), float(m["loss"]),
                float(m["hf_accepted"]))
    t = trainer(out, case, mesh, optimizer="hf", hf_cg_iters=8, **kw)
    got, loss, acc = step(t)
    t.close()
    arrays = {f"p{i}": a for i, a in enumerate(got)}
    arrays.update(loss=np.float64(loss), accepted=np.float64(acc))
    if rank == 0:
        ref = trainer(out, case + "_ref", optimizer="hf", hf_cg_iters=8,
                      **kw)
        want, ref_loss, ref_acc = step(ref)
        ref.close()
        arrays.update({f"ref_p{i}": a for i, a in enumerate(want)})
        arrays.update(ref_loss=np.float64(ref_loss),
                      ref_accepted=np.float64(ref_acc))
    _save(out, case, rank, **arrays)


def _params_and_seed(out, name, **kw):
    t = trainer(out, name, **kw)
    params, cfg = t.params, t.cfg
    seed = t.dataset.seed_windows("valid", n=8)
    t.close()
    return params, cfg, seed


def gen_case(out, rank, mesh, dec, case=None, **kw):
    """Batch-sharded generation on ``mesh`` (its data axis): seeded (B=8)
    and unseeded (B=16, and B=3, which the data axis does not divide)
    through the Generator — the whole-generation kernel's plain version —
    and the scan path of multinn.generate (B=8), each against one device
    on the same path."""
    case = case or f"gen_{dec}"
    from multinn_torch.models import multinn
    from multinn_torch.ops import sampling
    from multinn_torch.parallel import comm, mesh as mesh_mod
    from multinn_torch.training.generator import Generator
    params, cfg, seed = _params_and_seed(out, case, dec=dec, **kw)
    m = mesh_mod.make_mesh(mesh)
    key = lambda s: sampling.PRNGKey(s, device="cpu")
    gen = Generator(cfg, params, mesh=m)
    arrays = dict(seeded=gen.generate(key(5), n_steps=6, seed=seed),
                  unseeded=gen.generate(key(7), n_steps=6, batch=16),
                  odd=gen.generate(key(7), n_steps=6, batch=3))
    shard = mesh_mod.shard_of(m, 8, False)
    with torch.no_grad():
        state = multinn.init_state(params, 8 // m.size("data"))
        _, roll = multinn.generate(params, key(9), state, 6, fused=False,
                                   shard=shard)
    arrays["scan"] = comm.gather_cat(roll, 0, shard.data).numpy()
    if rank == 0:
        one = Generator(cfg, params)
        arrays.update(
            ref_seeded=one.generate(key(5), n_steps=6, seed=seed),
            ref_unseeded=one.generate(key(7), n_steps=6, batch=16),
            ref_odd=one.generate(key(7), n_steps=6, batch=3))
        with torch.no_grad():
            _, roll = multinn.generate(params, key(9),
                                       multinn.init_state(params, 8), 6,
                                       fused=False)
        arrays["ref_scan"] = roll.numpy()
    _save(out, case, rank, every_rank=True, **arrays)


def service_case(out, rank, mesh):
    """A service on ``mesh`` (batch 4, 6 steps, seeded requests enabled)
    answers two seeded and two plain batches; rank 0 runs the same
    requests through a single-device service."""
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.serving.service import GenerationService, ServeConfig
    params, cfg, seed = _params_and_seed(out, "serve")
    scfg = ServeConfig(batch=4, n_steps=6, seed=3, seed_steps=4,
                       max_wait_ms=1000.0)
    m = mesh_mod.make_mesh(mesh)
    svc = GenerationService(cfg, params, scfg, mesh=m)
    if rank != 0:
        svc.follow()
        return

    def drive(service):
        rolls = []
        for i in range(4):
            futs = service.submit_many(4, seed=(seed[i] if i % 2 else None))
            rolls += [(f.result(60).batch_index, f.result(60).row,
                       f.result(60).roll) for f in futs]
        service.close()
        return rolls

    got = drive(svc)
    want = drive(GenerationService(cfg, params, scfg))
    _save(out, "serve", rank,
          meta=np.array([(b, r) for b, r, _ in got]),
          ref_meta=np.array([(b, r) for b, r, _ in want]),
          rolls=np.stack([x for _, _, x in got]),
          ref_rolls=np.stack([x for _, _, x in want]))


def track_gen_case(out, rank, mesh, mode, case=None):
    """Track-sharded generation (seeded, B=8, 6 steps) through the
    Generator on ``mesh`` against the single-device scan path."""
    case = case or f"tgen_{mode}"
    from multinn_torch.models import multinn
    from multinn_torch.ops import sampling
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.training.generator import Generator
    params, cfg, seed = _params_and_seed(out, case, mode=mode)
    cfg = dataclasses.replace(cfg, mesh=mesh).validate()
    gen = Generator(cfg, params, mesh=mesh_mod.make_mesh(mesh))
    key = sampling.PRNGKey(5, device="cpu")
    arrays = dict(roll=gen.generate(key, n_steps=6, seed=seed),
                  dec_w_shape=np.array(gen.params.decoder.w.shape))
    if rank == 0:
        with torch.no_grad():
            state = multinn.prime(params, multinn.init_state(params, 8),
                                  torch.from_numpy(seed).float())
            _, roll = multinn.generate(params, key, state, 6, fused=False)
        arrays["ref_roll"] = roll.to(torch.uint8).numpy()
    _save(out, case, rank, every_rank=True, **arrays)


def ckpt_case(out, rank, mesh_a, mesh_b, mode="feedback"):
    """A run trained on ``mesh_a`` (one epoch) restores bit for bit on
    ``mesh_b`` and, in rank 0, on one device (then evaluates)."""
    from multinn_torch.training.trainer import Trainer
    run = os.path.join(out, "ckpt_run")
    t = Trainer(exp_cfg(run, mesh_a, mode=mode), device="cpu")
    t.train()
    trained = leaves(t.full_params())
    t.close()
    t2 = Trainer(exp_cfg(run, mesh_b, mode=mode), device="cpu")
    resumed_b = t2.maybe_resume()
    on_b = leaves(t2.full_params())
    t2.close()
    arrays = dict(resumed_b=np.float64(resumed_b))
    arrays.update({f"p{i}": a for i, a in enumerate(trained)})
    arrays.update({f"b_p{i}": a for i, a in enumerate(on_b)})
    if rank == 0:
        t3 = Trainer(exp_cfg(run, None, mode=mode), device="cpu")
        arrays["resumed_one"] = np.float64(t3.maybe_resume())
        arrays.update({f"one_p{i}": a for i, a in
                       enumerate(leaves(t3.params))})
        arrays["one_loss"] = np.float64(t3.evaluate("valid")["loss"])
        t3.close()
    _save(out, "ckpt", rank, every_rank=True, **arrays)


def dbn_case(out, rank, mesh):
    """A DBN config (frozen encoder, adamw) on a dp x track mesh in
    feedback mode: the step against one device, the encoder unchanged."""
    kw = dict(mode="feedback", model_kw=dict(encoder_hidden=(6,)),
              weight_decay=0.01)
    step_case(out, rank, "dbn_dp_track", mesh, **kw)


def pretrain_case(out, rank, mesh):
    """pretrain_encoders on a dp x track mesh in per-track mode (each
    track's encoder on its track's ranks): the global view on every rank,
    so the whole encoder equals one device's pre-trained encoder."""
    kw = dict(mode="per-track", model_kw=dict(encoder_hidden=(6,)),
              pretrain_encoder_epochs=1)
    t = trainer(out, "pretrain", mesh, **kw)
    t.pretrain_encoders()
    got = leaves(t.full_params().encoder)
    local_k = multinn_tree_first(t.params.encoder).shape[0]
    t.close()
    arrays = {f"p{i}": a for i, a in enumerate(got)}
    arrays["local_k"] = np.float64(local_k)
    if rank == 0:
        ref = trainer(out, "pretrain_ref", **kw)
        ref.pretrain_encoders()
        arrays.update({f"ref_p{i}": a for i, a in
                       enumerate(leaves(ref.params.encoder))})
        ref.close()
    _save(out, "pretrain", rank, **arrays)


def multinn_tree_first(tree):
    from multinn_torch.models import multinn
    return multinn.tree_leaves(tree)[0]


def jax_case(out, rank):
    """The NADE per-track loss and gradients on data=2 and on model=2 from
    the parameters the test process converted from the JAX Trainer's
    (``jax_params.pt``), on its batch (``jax_batch.npy``)."""
    from multinn_torch.models import multinn
    from multinn_torch.ops import sampling
    from multinn_torch.parallel import mesh as mesh_mod
    base = trainer(out, "jax_base")
    with torch.no_grad():
        for t, v in zip(multinn.tree_leaves(base.params),
                        torch.load(os.path.join(out, "jax_params.pt"))):
            t.copy_(v)
    batch = np.load(os.path.join(out, "jax_batch.npy"))
    for name, mesh in (("data2", mesh_cfg()), ("model2", mesh_cfg(model=2))):
        t = Trainer_on(out, f"jax_{name}", mesh, base.params)
        x = t._put_batch(batch)
        loss, _ = multinn.loss(t.params, sampling.PRNGKey(0, device="cpu"),
                               x, detailed=False, shard=t._shard(x))
        grads = t._red.mean(list(torch.autograd.grad(loss, t._leaves)))
        full = [mesh_mod.gather_tensor(g, sp, t.mesh).numpy()
                for g, sp in zip(grads, t._dec_specs)]
        arrays = {f"g{i}": a for i, a in enumerate(full)}
        arrays["loss"] = np.float64(float(t._red.loss(loss)))
        _save(out, f"jax_{name}", rank, **arrays)
        t.close()
    base.close()


def Trainer_on(out, name, mesh, params):
    from multinn_torch.training.trainer import Trainer
    return Trainer(exp_cfg(os.path.join(out, name), mesh), params=params)


def mesh_shapes_case(out, rank):
    """make_mesh on a world of 8: each config's axis sizes, this rank's
    coordinates, and per axis the sum of the ranks of its group."""
    from multinn_torch.parallel import comm, mesh as mesh_mod
    from multinn_torch.utils.config import MeshConfig
    arrays = {}
    for name, kw in (("track2", dict(track=2)), ("all", {}),
                     ("3d", dict(track=2, model=2)), ("seq4", dict(seq=4))):
        m = mesh_mod.make_mesh(MeshConfig(use_mesh=True, **kw))
        arrays[f"{name}_names"] = np.array(m.axis_names)
        arrays[f"{name}_sizes"] = np.array([m.shape[a]
                                            for a in m.axis_names])
        arrays[f"{name}_coords"] = np.array([m.index(a)
                                             for a in m.axis_names])
        arrays[f"{name}_sums"] = np.array([float(comm.all_reduce_sum(
            torch.tensor(float(rank)), m.group(a))) for a in m.axis_names])
    arrays["off"] = np.float64(mesh_mod.make_mesh(MeshConfig()) is None)
    try:
        mesh_mod.make_mesh(MeshConfig(use_mesh=True, data=3, track=2))
        arrays["refused"] = np.float64(0)
    except ValueError:
        arrays["refused"] = np.float64(1)
    _save(out, "mesh_shapes", rank, every_rank=True, **arrays)


def cli_case(out, rank):
    """``multinn_torch.train.main`` with ``--mesh.use_mesh=true`` on every
    rank of the world: one epoch; rank 0 alone writes the run's files."""
    from multinn_torch import train as train_cli
    run = os.path.join(out, "cli_run")
    rc = train_cli.main([
        "--preset", "synthetic", "--device", "cpu", "--mesh.use_mesh=true",
        "--data.n_tracks=2", "--data.pitch_min=40", "--data.pitch_max=63",
        "--data.window=8", "--data.batch_size=8", "--data.synthetic_songs=8",
        "--data.synthetic_steps=32", "--model.n_tracks=2",
        "--model.n_hidden=12", "--model.n_rnn=8",
        "--model.decoder_type=rnn-nade", "--train.epochs=1",
        f"--train.run_dir={run}"])
    dist.barrier()
    _save(out, "cli", rank, every_rank=True, rc=np.float64(rc),
          files=np.array(sorted(os.listdir(run))))


def comm_case(out, rank):
    """The collectives' values and derivatives on a world of 2: rank r
    sends (r + 1) * ones(3) and weighs what it receives by r + 1."""
    from multinn_torch.parallel import comm
    group, w = dist.group.WORLD, float(rank + 1)
    arrays = {}
    for name, fn in (("all_reduce", lambda x: comm.all_reduce(x, group)),
                     ("all_gather", lambda x: comm.all_gather(x, 0, group)),
                     ("ppermute", lambda x: comm.ppermute(x, group)),
                     ("reduce_from_model",
                      lambda x: comm.reduce_from_model(x, group)),
                     ("copy_to_model",
                      lambda x: comm.copy_to_model(x, group)),
                     ("gather_from_model",
                      lambda x: comm.gather_from_model(x, 0, group))):
        x = torch.full((3,), w, requires_grad=True)
        y = fn(x)
        (g,) = torch.autograd.grad((y * w).sum(), x)
        _, jv = torch.func.jvp(fn, (x.detach(),), (torch.ones(3) * w,))
        arrays[f"{name}_y"] = y.detach().numpy()
        arrays[f"{name}_grad"] = g.numpy()
        arrays[f"{name}_jvp"] = jv.numpy()
    _save(out, "comm", rank, every_rank=True, **arrays)


# -- accompaniment on a mesh (tests/test_torch_parallel.py) -------------------

ACCOMP_T = 6
# sub-case -> (mode, given tracks, model keywords, seeded: B=8 and B=3)
ACCOMP = {"feedback": ("feedback", (0,), {}, False),
          "pertrack": ("per-track", (1,), {}, False),
          "dbn": ("per-track", (0, 2), dict(encoder_hidden=(6,)), False),
          "seeded": ("feedback", (0,), {}, True)}
# the meshes of the accompaniment cases, by world
ACCOMP_MESHES = {2: {"data2": dict(), "track2": dict(data=1, track=2)},
                 4: {"data2_track2": dict(data=2, track=2)}}
JAXA_KEY = 47


@contextlib.contextmanager
def recording_work(dec):
    """What this rank hands the samplers meanwhile: each whole-generation
    launch's row map and given rows (b0, B_global, rows; -1 for no row
    map), and each scan-path ``sample_frame`` call's key words, state rows
    and row map."""
    from multinn_torch.models.base import get_decoder
    from multinn_torch.ops import gen_fused
    mod = get_decoder(dec)
    name = "generate_nade" if dec == "rnn-nade" else "generate_rbm"
    real_fused, real_frame = getattr(gen_fused, name), mod.sample_frame
    work = dict(fused=[], frames=[])

    def fused(*a, **kw):
        rows = kw.get("rows") or (-1, -1)
        work["fused"].append([*rows, kw["given"].shape[0]])
        return real_fused(*a, **kw)

    def frame(params, key, state, k=None, rows=None):
        from multinn_torch.ops import sampling
        work["frames"].append([*sampling.key_to_seeds(key).tolist(),
                               state.v_prev.shape[0], *(rows or (-1, -1))])
        return real_frame(params, key, state, k=k, rows=rows)
    setattr(gen_fused, name, fused)
    mod.sample_frame = frame
    try:
        yield work
    finally:
        setattr(gen_fused, name, real_fused)
        mod.sample_frame = real_frame


def accomp_ref(params, key, given, tracks, seed=None, fused=None):
    """One device's accompaniment of the whole batch (uint8 roll)."""
    from multinn_torch.models import multinn
    with torch.inference_mode():
        state = multinn.init_state(params, len(given))
        if seed is not None:
            state = multinn.prime(params, state, torch.from_numpy(seed))
        _, roll = multinn.generate_accompaniment(
            params, key, state, torch.from_numpy(given), tracks, fused=fused)
    return roll.to(torch.uint8).numpy()


def accomp_case(out, rank, mesh_name, mesh, dec, sub):
    """``Generator.accompany`` on ``mesh`` (K=4 at the tiny widths, T=6)
    in sub-case ``sub`` of ACCOMP, against one device's accompaniment of
    the whole batch on the same path (the fused kernel on a data-only
    mesh, the scan path where the tracks are split); with what this rank
    handed the samplers."""
    from multinn_torch.models import multinn
    from multinn_torch.ops import sampling
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.training.generator import Generator
    case = f"accomp_{mesh_name}_{dec}_{sub}"
    mode, tracks, model_kw, seeded = ACCOMP[sub]
    cfg = exp_cfg(os.path.join(out, case), mesh_cfg(**mesh), mode=mode,
                  dec=dec, n_tracks=4, model_kw=model_kw)
    params = multinn.init(cfg.model, torch.Generator().manual_seed(41),
                          device="cpu")
    m = mesh_mod.make_mesh(cfg.mesh)
    gen = Generator(cfg, params, mesh=m)
    fused = False if m.size("track") > 1 else None
    rng = np.random.default_rng(43)
    key = sampling.PRNGKey(45, device="cpu")
    arrays = dict(tracks=np.array(tracks),
                  local_k=np.float64(gen.params.decoder.w.shape[0]))
    for b in ((8, 3) if seeded else (8,)):
        given = (rng.random((b, ACCOMP_T, 4, 24)) < 0.3).astype(np.float32)
        seed = ((rng.random((b, 4, 4, 24)) < 0.3).astype(np.float32)
                if seeded else None)
        with recording_work(dec) as work:
            arrays[f"b{b}_got"] = gen.accompany(key, given, tracks,
                                                seed=seed)
        arrays[f"b{b}_given"] = given
        arrays[f"b{b}_fused"] = np.array(work["fused"]).reshape(-1, 3)
        arrays[f"b{b}_frames"] = np.array(work["frames"]).reshape(-1, 5)
        if rank == 0:
            arrays[f"b{b}_want"] = accomp_ref(params, key, given, tracks,
                                              seed, fused)
    _save(out, case, rank, every_rank=True, **arrays)


def accomp_cases(out, rank, world):
    """Every ACCOMP sub-case of both families on the meshes of ``world``
    ranks (ACCOMP_MESHES)."""
    for name, mesh in ACCOMP_MESHES[world].items():
        for dec in ("rnn-nade", "rnn-rbm"):
            for sub in ACCOMP:
                accomp_case(out, rank, name, mesh, dec, sub)


def jax_accomp_case(out, rank):
    """Accompaniment (K=4 feedback NADE, track 0 given) on data=1 x
    track=2 from the params the test process converted from the JAX
    package's (``jaxa_params.pt``), on its given roll
    (``jaxa_given.npy``), under PRNGKey(JAXA_KEY)."""
    from multinn_torch.models import multinn
    from multinn_torch.ops import sampling
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.training.generator import Generator
    cfg = exp_cfg(os.path.join(out, "jaxa"), mesh_cfg(data=1, track=2),
                  **TRACK4)
    params = multinn.init(cfg.model, torch.Generator().manual_seed(0),
                          device="cpu")
    with torch.no_grad():
        for t, v in zip(multinn.tree_leaves(params),
                        torch.load(os.path.join(out, "jaxa_params.pt"))):
            t.copy_(v)
    gen = Generator(cfg, params, mesh=mesh_mod.make_mesh(cfg.mesh))
    roll = gen.accompany(sampling.PRNGKey(JAXA_KEY, device="cpu"),
                         np.load(os.path.join(out, "jaxa_given.npy")), (0,))
    _save(out, "jaxa", rank, every_rank=True, roll=roll)


def service_accomp_case(out, rank):
    """A service on data=2 (K=4 feedback NADE, batch 4, 6 steps, track 0
    of accompaniment requests given) answers two plain batches and two
    of accompaniment requests; rank 0 runs the same requests through a
    single-device service."""
    from multinn_torch.models import multinn
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.serving.service import GenerationService, ServeConfig
    cfg = exp_cfg(os.path.join(out, "serve_accomp"), mesh_cfg(), **TRACK4)
    params = multinn.init(cfg.model, torch.Generator().manual_seed(49),
                          device="cpu")
    scfg = ServeConfig(batch=4, n_steps=6, seed=5, accompany_tracks=(0,),
                       max_wait_ms=1000.0)
    svc = GenerationService(cfg, params, scfg,
                            mesh=mesh_mod.make_mesh(cfg.mesh))
    if rank != 0:
        svc.follow()
        return
    given = (np.random.default_rng(51).random((6, 4, 24))
             < 0.3).astype(np.uint8)

    def drive(service):
        rolls = []
        for i in range(4):
            futs = service.submit_many(4, given=(given if i % 2 else None))
            rolls += [f.result(60).roll for f in futs]
        service.close()
        return np.stack(rolls)

    _save(out, "serve_accomp", rank, given=given, rolls=drive(svc),
          ref_rolls=drive(GenerationService(cfg, params, scfg)))


# -- jobs ---------------------------------------------------------------------

def job_w2(rank, world, out):
    """A world of 2: the collectives; DP (gspmd both families, shard_map)
    and TP model=2 steps; evaluation, HF, generation, a service, the
    accompaniment cases on data=2 and data=1 x track=2 and a service
    with accompaniment requests, and the steps and the accompaniment
    from the JAX package's params."""
    comm_case(out, rank)
    cli_case(out, rank)
    step_case(out, rank, "dp2_gspmd_nade", mesh_cfg())
    step_case(out, rank, "dp2_gspmd_rbm", mesh_cfg(), dec="rnn-rbm")
    step_case(out, rank, "dp2_shard_map_nade", mesh_cfg(style="shard_map"))
    rbm_shard_map_case(out, rank, "dp2_shard_map_rbm", 2)
    step_case(out, rank, "tp2_nade", mesh_cfg(model=2))
    step_case(out, rank, "tp2_rbm", mesh_cfg(model=2), dec="rnn-rbm")
    eval_case(out, rank, "eval_gspmd", mesh_cfg())
    eval_case(out, rank, "eval_gspmd_rbm", mesh_cfg(), dec="rnn-rbm")
    for dec in ("rnn-nade", "rnn-rbm"):
        detailed_step_case(out, rank, f"detailed_gspmd_{dec}", mesh_cfg(),
                           dec=dec)
    eval_case(out, rank, "eval_shard_map", mesh_cfg(style="shard_map"))
    hf_case(out, rank, "hf_gspmd", mesh_cfg())
    hf_case(out, rank, "hf_shard_map", mesh_cfg(style="shard_map"))
    gen_case(out, rank, mesh_cfg(), "rnn-nade")
    gen_case(out, rank, mesh_cfg(), "rnn-rbm")
    gen_case(out, rank, mesh_cfg(), "rnn-nade", "gen_dbn", mode="per-track",
             model_kw=dict(encoder_hidden=(6,)))
    service_case(out, rank, mesh_cfg())
    accomp_cases(out, rank, world)
    service_accomp_case(out, rank)
    if os.path.exists(os.path.join(out, "jax_params.pt")):
        jax_case(out, rank)
    if os.path.exists(os.path.join(out, "jaxa_params.pt")):
        jax_accomp_case(out, rank)


def job_w4(rank, world, out):
    """A world of 4: DP data=4, dp x track, TP model=4, track-sharded
    generation, a DBN config on dp x track, the accompaniment cases on
    data=2 x track=2."""
    step_case(out, rank, "dp4_gspmd_nade", mesh_cfg())
    step_case(out, rank, "dp4_gspmd_rbm", mesh_cfg(), dec="rnn-rbm")
    step_case(out, rank, "dp4_shard_map_nade", mesh_cfg(style="shard_map"))
    rbm_shard_map_case(out, rank, "dp4_shard_map_rbm", 4)
    for mode in ("per-track", "feedback"):
        step_case(out, rank, f"dp_track_{mode}", mesh_cfg(track=2),
                  mode=mode)
        track_gen_case(out, rank, mesh_cfg(track=2), mode)
    step_case(out, rank, "tp4_nade", mesh_cfg(model=4))
    step_case(out, rank, "tp4_rbm", mesh_cfg(model=4), dec="rnn-rbm")
    dbn_case(out, rank, mesh_cfg(track=2))
    pretrain_case(out, rank, mesh_cfg(track=2))
    for dec in ("rnn-nade", "rnn-rbm"):
        eval_case(out, rank, f"eval_dp_track_{dec}", mesh_cfg(track=2),
                  dec=dec, mode="feedback", n_tracks=4)
        detailed_step_case(out, rank, f"detailed_dp_track_{dec}",
                           mesh_cfg(track=2), dec=dec, mode="feedback",
                           n_tracks=4)
    accomp_cases(out, rank, world)


def job_w8(rank, world, out):
    """A world of 8: mesh construction, the full 2x2x2 mesh (feedback):
    the step, generation, and checkpoints across topologies."""
    mesh_shapes_case(out, rank)
    m3 = mesh_cfg(data=2, track=2, model=2)
    step_case(out, rank, "mesh3d", m3, mode="feedback")
    track_gen_case(out, rank, m3, "feedback", "tgen_3d")
    ckpt_case(out, rank, m3, mesh_cfg(data=4, track=2))


def rbm_seqpipe_case(out, rank, mesh):
    """The RBM (feedback) under seqpipe: the pseudo-likelihood per frame of
    the validation split before and after two epochs of training in
    groups of 2 steps, and every logged loss."""
    from multinn_torch.training.trainer import Trainer
    cfg = exp_cfg(os.path.join(out, "sp_rbm"), mesh, mode="feedback",
                  dec="rnn-rbm", epochs=2, lr=1e-2, steps_per_call=2,
                  log_every_steps=1)
    t = Trainer(cfg, device="cpu")
    before = t.evaluate("valid")
    after = t.train()
    losses = [m["loss"] for _, m in t.history]
    t.close()
    _save(out, "seqpipe_rbm", rank, every_rank=True,
          ll_before=np.float64(before["ll_per_frame"]),
          ll_after=np.float64(after["ll_per_frame"]),
          loss_after=np.float64(after["loss"]), losses=np.array(losses))


def job_w4s(rank, world, out):
    """A world of 4 as data=2 x seq=2 (seqpipe): NADE steps in both
    modes, the two-layer remat case, the RBM's training, evaluation with a
    short tail and a Hessian-free step."""
    sp = mesh_cfg(data=2, seq=2, style="seqpipe")
    for mode in ("per-track", "feedback"):
        step_case(out, rank, f"seqpipe_{mode}", sp, mode=mode)
    step_case(out, rank, "seqpipe_remat", sp, mode="feedback",
              model_kw=dict(rnn_layers=2, remat=True))
    rbm_seqpipe_case(out, rank, sp)
    eval_case(out, rank, "eval_seqpipe", sp)
    hf_case(out, rank, "hf_seqpipe", sp)


def job_w1(rank, world, out):
    """A world of 1: init_distributed and a mesh of one rank."""
    from multinn_torch.parallel import mesh as mesh_mod
    m = mesh_mod.make_mesh(mesh_cfg())
    _save(out, "w1", rank, world=np.float64(dist.get_world_size()),
          backend=np.array(dist.get_backend()),
          sizes=np.array([m.shape[a] for a in m.axis_names]))


# -- captured mesh groups (tests/test_torch_mesh_graphs.py) -------------------

class RecorderGraph:
    """The CudaGraph interface without a card (as in
    tests/test_torch_train_loop.py): capture runs the group once, as
    capture records it; replay runs it again with the launch counts held
    (a replay runs no wrapper's Python) and refreshes the outputs."""

    def warmup(self, fn):
        fn()

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        import collections
        from multinn_torch.ops import _build
        held = collections.Counter(_build.launches)
        new = self.fn()
        _build.launches.clear()
        _build.launches.update(held)
        with torch.no_grad():
            for k, v in new.items():
                self.out[k].copy_(v)


def _probe_loss():
    """A stand-in kernel launch in every loss call (the plain versions
    count nothing on the CPU)."""
    from multinn_torch.models import multinn
    from multinn_torch.ops import _build
    real = getattr(multinn.loss, "real", multinn.loss)

    def counted(*a, **kw):
        _build.launches["probe"] += 1
        return real(*a, **kw)
    counted.real = real
    multinn.loss = counted


def _state(t):
    return [v.detach().numpy().copy() for v in t._state_tensors()]


def graph_case(out, rank, case, mesh, n=4, params=None, stacked=None,
               key_seed=9, **kw):
    """A group of ``n`` steps on ``mesh`` captured (a RecorderGraph in
    place of the CUDA graph) against the same group run eagerly from the
    same params, optimizer state and key, twice in a row; this rank's
    block shape, its state around warm-up and capture, and the launches
    of one eager step and of each replay. ``params`` (full) and
    ``stacked`` replace the seeded ones."""
    from multinn_torch.ops import _build, sampling
    from multinn_torch.training.trainer import StepGroupGraph, Trainer
    _probe_loss()

    def make(name):
        cfg = exp_cfg(os.path.join(out, f"{case}_{name}"), mesh,
                      steps_per_call=n, **kw)
        return Trainer(cfg, params=params, device="cpu")
    eager, graph = make("eager"), make("graph")
    if stacked is None:
        batches = list(eager.dataset.batches("train", epoch=0))
        stacked = np.stack([batches[i % len(batches)]
                            for i in range(n + 1)])
    groups = [stacked[:n], stacked[1:n + 1]]
    key = sampling.PRNGKey(key_seed, device="cpu")
    state0 = [v.detach().clone() for v in eager._state_tensors()]
    _build.launches.clear()
    eager.train_step(eager._put_batch(groups[0][0]), key)
    one_step = _build.launches["probe"]
    eager._load_state_tensors(state0)
    before = _state(graph)
    block = graph._block(groups[0], lead=1)
    graph.capture_groups = True
    graph.group_graph = StepGroupGraph(graph, n, block.shape[1:],
                                       RecorderGraph())
    unchanged = all(np.array_equal(a, b) for a, b in
                    zip(before, _state(graph)))
    arrays = dict(one_step=np.float64(one_step),
                  unchanged=np.float64(unchanged),
                  block=np.array(graph.group_graph.x.shape),
                  backend=np.array(graph.mesh.backend))
    for g, (xs, k) in enumerate(zip(groups, (key, sampling.fold_in(key,
                                                                  1)))):
        _build.launches.clear()
        got = graph.run_group(xs, k)
        arrays[f"replay{g}"] = np.float64(_build.launches["probe"])
        want = eager.run_group(xs, k)
        for name in want:
            arrays[f"g{g}_got_{name}"] = got[name].numpy().copy()
            arrays[f"g{g}_want_{name}"] = want[name].numpy().copy()
        if g == 0:                 # the whole params after the first group
            arrays.update({f"first{i}": a for i, a in
                           enumerate(leaves(graph.full_params()))})
    arrays.update({f"got{i}": a for i, a in enumerate(_state(graph))})
    arrays.update({f"want{i}": a for i, a in enumerate(_state(eager))})
    eager.close()
    graph.close()
    _save(out, case, rank, every_rank=True, **arrays)


def jax_graph_case(out, rank, case="g_jax_nade", mesh=None, **kw):
    """The NADE captured group on ``mesh`` (data=2 when None) from the JAX
    Trainer's params (``jaxg_params.pt``) on its stacked batches
    (``jaxg_stack.npy``); the first group's key is the one the test
    process gave the JAX Trainer's multi-step. ``kw``: the config's
    (``exp_cfg``)."""
    from multinn_torch.models import multinn
    base = trainer(out, "jaxg_base", steps_per_call=4, **kw)
    with torch.no_grad():
        for t, v in zip(multinn.tree_leaves(base.params),
                        torch.load(os.path.join(out, "jaxg_params.pt"))):
            t.copy_(v)
    graph_case(out, rank, case, mesh or mesh_cfg(), params=base.params,
               stacked=np.load(os.path.join(out, "jaxg_stack.npy")),
               key_seed=JAX_GROUP_KEY, **kw)
    base.close()


JAX_GROUP_KEY = 11


def job_g2(rank, world, out):
    """A world of 2: captured groups against eager under gspmd data=2
    (both families), shard_map data=2, seqpipe seq=2, a Hessian-free
    gspmd data=2 group, and the NADE group from the JAX Trainer's
    params."""
    graph_case(out, rank, "g_gspmd_nade", mesh_cfg())
    graph_case(out, rank, "g_gspmd_rbm", mesh_cfg(), dec="rnn-rbm")
    graph_case(out, rank, "g_shard_map_nade", mesh_cfg(style="shard_map"))
    graph_case(out, rank, "g_shard_map_rbm", mesh_cfg(style="shard_map"),
               dec="rnn-rbm")
    graph_case(out, rank, "g_seqpipe_nade",
               mesh_cfg(data=1, seq=2, style="seqpipe"), mode="feedback")
    graph_case(out, rank, "g_hf_gspmd_nade", mesh_cfg(), optimizer="hf",
               hf_cg_iters=4)
    graph_case(out, rank, "g_hf_shard_map_nade", mesh_cfg(style="shard_map"),
               n=2, optimizer="hf", hf_cg_iters=4)
    if os.path.exists(os.path.join(out, "jaxg_params.pt")):
        jax_graph_case(out, rank)


# the JAX package's tiny multichip flagship: four tracks, feedback
TRACK4 = dict(n_tracks=4, mode="feedback")


def job_g4(rank, world, out):
    """A world of 4: captured groups against eager under gspmd data=2 x
    model=2 (both families), seqpipe data=2 x seq=2, and with four tracks
    under data=2 x track=2 (both families; the RBM also in per-track
    mode), data=1 x track=2 x model=2 (RBM), and the NADE group from the
    JAX Trainer's params on data=2 x track=2."""
    graph_case(out, rank, "g_dp_tp_nade", mesh_cfg(data=2, model=2))
    graph_case(out, rank, "g_dp_tp_rbm", mesh_cfg(data=2, model=2),
               dec="rnn-rbm")
    graph_case(out, rank, "g_seqpipe_dp_nade",
               mesh_cfg(data=2, seq=2, style="seqpipe"), mode="feedback")
    dp_track = mesh_cfg(data=2, track=2)
    graph_case(out, rank, "g_dp_track_nade", dp_track, **TRACK4)
    graph_case(out, rank, "g_dp_track_rbm", dp_track, dec="rnn-rbm",
               **TRACK4)
    graph_case(out, rank, "g_pertrack_dp_track_rbm", dp_track,
               dec="rnn-rbm", n_tracks=4, mode="per-track")
    graph_case(out, rank, "g_track_tp_rbm",
               mesh_cfg(data=1, track=2, model=2), dec="rnn-rbm", **TRACK4)
    if os.path.exists(os.path.join(out, "jaxg_params.pt")):
        jax_graph_case(out, rank, "g_jax_dp_track_nade", dp_track, **TRACK4)


def job_cards2(rank, world, out):
    """Two cards on NCCL (tests/test_torch_cuda.py): a gspmd data=2
    Trainer of each family at the flagship widths captures its group of
    4 steps, its NCCL collectives inside; the replayed group against the
    eager one from the same params, state and key, twice in a row."""
    from multinn_torch.models import multinn
    from multinn_torch.ops import _build, sampling
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.training.trainer import Trainer
    from multinn_torch.utils import config as cfg_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = mesh_mod.rank_device()
    data = cfg_mod.DataConfig.from_preset(
        "synthetic", window=16, batch_size=8, synthetic_songs=24,
        synthetic_steps=64)                  # 9 train batches of 8
    for dec, kernel in (("rnn-nade", "nade_ll_bwd"),
                        ("rnn-rbm", "gibbs_chain")):
        model = multinn.MultINNConfig(
            n_tracks=5, n_pitches=84, mode="feedback", decoder_type=dec,
            n_hidden=150, n_rnn=100, gen_k=10)
        params = multinn.init(model, torch.Generator().manual_seed(0),
                              device=dev)
        pair = [Trainer(cfg_mod.ExperimentConfig(
            data=data, model=model, mesh=mesh_cfg(),
            train=cfg_mod.TrainConfig(steps_per_call=4, run_dir=os.path.join(
                out, f"cards2_{dec}_{name}_{rank}"))), params=params)
            for name in ("graph", "eager")]
        graph, eager = pair
        captures = graph.capture_groups
        eager.capture_groups = False
        batches = np.stack(list(graph.dataset.batches("train", epoch=0)))
        diffs, replays = [], []
        for i in range(2):
            xs, key = batches[i * 4:(i + 1) * 4], sampling.PRNGKey(
                30 + i, device=dev)
            _build.launches.clear()
            graph.run_group(xs, key)
            torch.cuda.synchronize()
            replays.append(_build.launches[kernel])
            eager.run_group(xs, key)
            diffs.append(max(
                float((a - b).detach().abs().max()
                      / b.detach().abs().max().clamp(min=1e-30))
                for a, b in zip(graph._leaves, eager._leaves)))
        _build.launches.clear()
        eager.train_step(eager._put_batch(batches[0]), key)
        torch.cuda.synchronize()
        _save(out, f"cards2_{dec}", rank, every_rank=True,
              backend=np.array(graph.mesh.backend),
              device=np.array(str(dev)), captures=np.float64(captures),
              diffs=np.array(diffs), replays=np.array(replays),
              one_step=np.float64(_build.launches[kernel]),
              recorded=np.float64(graph.group_graph.launches[kernel]))
        graph.close()
        eager.close()


def job_cards2_track(rank, world, out):
    """Two cards on NCCL (tests/test_torch_cuda.py): a gspmd data=1 x
    track=2 Trainer of each family at the tiny widths (K=2, feedback: one
    track a card, the context all-gathered over ``track``) captures its
    group of 4 steps, the track group's collectives inside; the replayed
    group against the eager one from the same params, state and key,
    twice in a row."""
    from multinn_torch.models import multinn
    from multinn_torch.ops import _build, sampling
    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.training.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = mesh_mod.rank_device()
    for dec, kernel in (("rnn-nade", "nade_ll_bwd"),
                        ("rnn-rbm", "gibbs_chain")):
        cfgs = [exp_cfg(os.path.join(out, f"cards2t_{dec}_{name}_{rank}"),
                        mesh_cfg(data=1, track=2), mode="feedback", dec=dec,
                        steps_per_call=4) for name in ("graph", "eager")]
        params = multinn.init(cfgs[0].model, torch.Generator().manual_seed(0),
                              device=dev)
        graph, eager = [Trainer(c, params=params) for c in cfgs]
        captures = graph.capture_groups
        eager.capture_groups = False
        batches = list(graph.dataset.batches("train", epoch=0))
        batches = np.stack([batches[i % len(batches)] for i in range(8)])
        diffs, replays = [], []
        for i in range(2):
            xs, key = batches[i * 4:(i + 1) * 4], sampling.PRNGKey(
                30 + i, device=dev)
            _build.launches.clear()
            graph.run_group(xs, key)
            torch.cuda.synchronize()
            replays.append(_build.launches[kernel])
            eager.run_group(xs, key)
            diffs.append(max(
                float((a - b).detach().abs().max()
                      / b.detach().abs().max().clamp(min=1e-30))
                for a, b in zip(graph._leaves, eager._leaves)))
        _build.launches.clear()
        eager.train_step(eager._put_batch(batches[0]), key)
        torch.cuda.synchronize()
        _save(out, f"cards2t_{dec}", rank, every_rank=True,
              backend=np.array(graph.mesh.backend),
              device=np.array(str(dev)), captures=np.float64(captures),
              local_k=np.float64(graph.params.decoder.w.shape[0]),
              diffs=np.array(diffs), replays=np.array(replays),
              one_step=np.float64(_build.launches[kernel]),
              recorded=np.float64(graph.group_graph.launches[kernel]))
        graph.close()
        eager.close()


def failing_cards_rank(rank, world, out, sizes, only=None):
    """A stand-in for ``mesh_cards._rank``: rank 1 finishes one case,
    then fails as a rank that raised inside a capture does (its result
    and traceback written, then an immediate exit); the others hang, as
    ranks left waiting in a collective do."""
    import json
    if rank != 1:
        time.sleep(600)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(dict(backend="nccl", device=f"cuda:{rank}",
                       cases=[dict(case="first", ok=True)],
                       error="RuntimeError: capture failed"), f)
    os._exit(1)


JOBS = {"w1": job_w1, "w2": job_w2, "w4": job_w4, "w8": job_w8,
        "w4s": job_w4s, "g2": job_g2, "g4": job_g4, "cards2": job_cards2,
        "cards2_track": job_cards2_track}
