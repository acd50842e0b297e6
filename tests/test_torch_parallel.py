"""multinn_torch on a process mesh (multinn_torch/parallel) against one
device, case by case as tests/test_parallel.py holds the JAX package:
gloo worlds of 1, 2, 4 and 8 CPU ranks (spawned by torch_mesh_ranks,
rendezvous through a file in the test's directory, each world under a
deadline) run the mesh side, rank 0 runs the single-device side on the
same seeded data and params, and the tests here compare their files.

The reference's small config (K=2, 24 pitches, H=12, U=8, window 8, B=8)
and tolerances: loss rtol 1e-5, parameters after one step rtol 1e-4 /
atol 1e-6, Hessian-free steps rtol 1e-3 / atol 1e-5; generation and
checkpoints bit for bit. The NADE per-track step on data=2 and model=2 is
also held against ``jax.value_and_grad`` of the JAX Trainer's loss (JAX
runs here, in the test process only). Sampled results are compared within
the port: its samplers draw the kernel stream, the JAX scan path
``jax.random``. The seqpipe cases are in test_torch_seqpipe.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from multinn_tpu.utils import config as jax_config  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import (gen_fused_nade, gen_fused_rbm,  # noqa: E402
                               gibbs_cuda, nade_cuda, sampling)
from multinn_torch.parallel import mesh as mesh_mod  # noqa: E402
from multinn_torch.utils import config  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

STEP_TOL = dict(rtol=1e-4, atol=1e-6)
HF_TOL = dict(rtol=1e-3, atol=1e-5)


def _jax_reference(out):
    """The JAX Trainer's NADE per-track loss and gradients on its first
    train batch; its params converted for the ranks."""
    cfg = ranks.exp_cfg(out / "jax", None)
    jcfg = jax_config.ExperimentConfig(
        name="par", data=jax_config.DataConfig(**dataclasses.asdict(
            cfg.data)), model=jax_multinn.MultINNConfig(
                **dataclasses.asdict(cfg.model)),
        train=jax_config.TrainConfig(**dataclasses.asdict(cfg.train)))
    jt = JaxTrainer(jcfg)
    batch = next(iter(jt.dataset.batches("train", epoch=0)))
    (loss, _), grads = jax.value_and_grad(
        lambda p: jt._loss_fn(p, batch, jax.random.PRNGKey(0), False),
        has_aux=True)(jt.params)
    torch.save([t.clone() for t in multinn.tree_leaves(
        from_jax(jt.params, device="cpu"))], out / "jax_params.pt")
    np.save(out / "jax_batch.npy", batch)
    g = multinn.tree_leaves(from_jax(grads, device="cpu").decoder)
    np.savez(out / "jax_ref.npz", loss=float(loss),
             **{f"g{i}": t.numpy() for i, t in enumerate(g)})
    jt.close()


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    out = tmp_path_factory.mktemp("w2")
    _jax_reference(out)
    ranks.run_world(out, 2, "w2")
    return out


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    out = tmp_path_factory.mktemp("w4")
    ranks.run_world(out, 4, "w4")
    return out


@pytest.fixture(scope="module")
def w8(tmp_path_factory):
    out = tmp_path_factory.mktemp("w8")
    ranks.run_world(out, 8, "w8")
    return out


def _n(a, prefix):
    return len([k for k in a if k.startswith(prefix)
                and k[len(prefix):].isdigit()])


def _check_step(out, case, world=None, tol=STEP_TOL):
    a = ranks.load(out, case)
    np.testing.assert_allclose(a["loss"], a["ref_loss"], rtol=1e-5)
    n = _n(a, "ref_p")
    assert n == _n(a, "p") > 0
    for i in range(n):
        np.testing.assert_allclose(a[f"p{i}"], a[f"ref_p{i}"], **tol,
                                   err_msg=f"{case} leaf {i}")
    for r in range(1, world or 1):      # every rank ends on the same params
        b = ranks.load(out, case, r)
        for i in range(n):
            np.testing.assert_array_equal(b[f"p{i}"], a[f"p{i}"])
    return a


# -- the mesh itself ----------------------------------------------------------

def test_mesh_construction(w8):
    want = {"track2": (["data", "track"], [4, 2]),
            "all": (["data", "track"], [8, 1]),
            "3d": (["data", "track", "model"], [2, 2, 2]),
            "seq4": (["data", "track", "seq"], [2, 1, 4])}
    for r in range(8):
        a = ranks.load(w8, "mesh_shapes", r)
        for name, (names, sizes) in want.items():
            assert a[f"{name}_names"].tolist() == names
            assert a[f"{name}_sizes"].tolist() == sizes
            coords = np.unravel_index(r, sizes)
            assert a[f"{name}_coords"].tolist() == list(coords)
            layout = np.arange(8).reshape(sizes)
            for ax, got in enumerate(a[f"{name}_sums"]):
                line = [int(c) for c in coords]
                line[ax] = slice(None)
                assert got == layout[tuple(line)].sum(), (name, ax)
        assert a["off"] == 1 and a["refused"] == 1


def test_collectives_and_their_derivatives(w2):
    """parallel/comm.py on a world of 2: rank r sends (r + 1) * ones(3)
    and weighs what it receives by r + 1 (r + 1 is also each jvp's
    tangent); the derivatives follow the mesh's semantics (module
    docstring of comm.py)."""
    for r in range(2):
        a = ranks.load(w2, "comm", r)
        np.testing.assert_array_equal(a["all_reduce_y"], [3.0] * 3)
        np.testing.assert_array_equal(a["all_reduce_grad"], [3.0] * 3)
        np.testing.assert_array_equal(a["all_reduce_jvp"], [3.0] * 3)
        for name in ("all_gather", "gather_from_model"):
            np.testing.assert_array_equal(a[f"{name}_y"], [1.0] * 3 +
                                          [2.0] * 3)
            np.testing.assert_array_equal(a[f"{name}_jvp"], [1.0] * 3 +
                                          [2.0] * 3)
        # all_gather sums the cotangents of every rank's copy of its slice
        np.testing.assert_array_equal(a["all_gather_grad"], [3.0] * 3)
        np.testing.assert_array_equal(a["gather_from_model_grad"],
                                      [r + 1.0] * 3)
        np.testing.assert_array_equal(a["ppermute_y"], [float(r)] * 3)
        np.testing.assert_array_equal(a["ppermute_jvp"], [float(r)] * 3)
        np.testing.assert_array_equal(a["ppermute_grad"],
                                      [2.0 if r == 0 else 0.0] * 3)
        np.testing.assert_array_equal(a["reduce_from_model_y"], [3.0] * 3)
        np.testing.assert_array_equal(a["reduce_from_model_grad"],
                                      [r + 1.0] * 3)
        np.testing.assert_array_equal(a["copy_to_model_y"], [r + 1.0] * 3)
        np.testing.assert_array_equal(a["copy_to_model_grad"], [3.0] * 3)


def test_train_entry_point_on_a_mesh(w2):
    """``python -m multinn_torch.train --mesh.use_mesh=true`` run by every
    rank: an epoch on data=2, and the run's files (the config, the log,
    the metrics, TensorBoard, the checkpoints) written by rank 0 alone."""
    a = ranks.load(w2, "cli")
    assert a["rc"] == 0
    assert {"ckpt", "config.json", "metrics.jsonl", "tb",
            "train.log"} <= set(a["files"].tolist())
    import json
    rows = [json.loads(line) for line in
            open(w2 / "cli_run" / "metrics.jsonl")]
    assert [r["split"] for r in rows].count("valid") == 1
    # the run evaluates from the command line in one process, on one
    # device (its checkpoint holds the whole params)
    from multinn_torch import evaluate as evaluate_cli
    assert evaluate_cli.main(["--run", str(w2 / "cli_run"), "--split",
                              "valid", "--device", "cpu",
                              "--no-musical"]) == 0
    assert (w2 / "cli_run" / "eval_valid.json").exists()


def test_invalid_mesh_configs(tmp_path):
    mesh = lambda **kw: config.MeshConfig(use_mesh=True, **kw)
    base = ranks.exp_cfg(tmp_path)
    with pytest.raises(ValueError, match="not divisible"):
        dataclasses.replace(
            base, mesh=mesh(track=2),
            model=dataclasses.replace(base.model, n_tracks=3),
            data=dataclasses.replace(base.data, n_tracks=3)).validate()
    with pytest.raises(ValueError, match="gspmd"):
        ranks.exp_cfg(tmp_path, mesh(track=2, style="shard_map"))
    with pytest.raises(ValueError, match="joint"):
        ranks.exp_cfg(tmp_path, mesh(track=2), mode="joint")
    with pytest.raises(ValueError, match="n_hidden"):   # H=12, model=5
        ranks.exp_cfg(tmp_path, mesh(model=5))
    with pytest.raises(ValueError, match="gspmd"):
        ranks.exp_cfg(tmp_path, mesh(model=2, style="shard_map"))
    with pytest.raises(ValueError, match="seqpipe"):
        ranks.exp_cfg(tmp_path, mesh(seq=2, style="gspmd"))
    with pytest.raises(ValueError, match="does not divide"):
        mesh(track=3).resolved_data(8)
    assert mesh(track=2).resolved_data(8) == 4
    assert mesh(data=3).resolved_data(8) == 3


def test_mesh_style_validated():
    with pytest.raises(ValueError, match="unknown mesh.style"):
        config.MeshConfig(use_mesh=True, style="spmd")
    with pytest.raises(ValueError, match="unknown mesh.style"):
        config.MeshConfig(style="GSPMD")
    assert mesh_mod.MeshConfig is config.MeshConfig


def _fake_mesh(**sizes):
    """A Mesh of one rank's view with no process groups (placement only)."""
    names = tuple(sizes)
    return mesh_mod.Mesh(names, dict(sizes), {n: 0 for n in names},
                         {n: None for n in names}, "gloo")


def test_tp_sharding_placement(tmp_path):
    """Hidden-dim fields split their last axis over ``model``; visible-dim
    and RNN-cell tensors stay whole (the TP layout contract)."""
    for dec in ("rnn-nade", "rnn-rbm"):
        cfg = ranks.exp_cfg(tmp_path, dec=dec)
        params = multinn.init(cfg.model, torch.Generator().manual_seed(0),
                              device="cpu")
        mesh = _fake_mesh(data=2, track=1, model=2)
        specs = mesh_mod.field_specs(params, mesh, False)
        hidden = {"w", "bh", "wuh"} | ({"v"} if dec == "rnn-nade" else set())
        for name, spec in specs.items():
            assert (spec[-1] == mesh_mod.MODEL_AXIS) == (name in hidden), \
                (name, spec)
        _, dec_specs = mesh_mod.leaf_specs(params, mesh, False)
        cell = multinn.tree_leaves(params.decoder.cell)
        assert all(sp == (None,) * t.dim() for sp, t in
                   zip(dec_specs[:len(cell)], cell))
        local = mesh_mod.shard_params(params, mesh)
        assert local.decoder.w.shape == (2, 24, 6)
        assert local.decoder.wuh.shape == (2, 8, 6)
        assert local.decoder.bv.shape == (2, 24)
        torch.testing.assert_close(local.decoder.w,
                                   params.decoder.w[..., :6], rtol=0, atol=0)


def test_track_sharding_placement(tmp_path):
    """The decoders' stacked K axis goes over ``track``; the encoder's only
    in per-track mode."""
    for mode, enc_split in (("per-track", True), ("feedback", False)):
        cfg = ranks.exp_cfg(tmp_path, mode=mode,
                            model_kw=dict(encoder_hidden=(6,)))
        params = multinn.init(cfg.model, torch.Generator().manual_seed(0),
                              device="cpu")
        mesh = _fake_mesh(data=2, track=2)
        enc, dec = mesh_mod.leaf_specs(params, mesh, True)
        assert all(sp[0] == mesh_mod.TRACK_AXIS for sp in dec)
        assert all((sp[0] == mesh_mod.TRACK_AXIS) == enc_split for sp in enc)
        local = mesh_mod.shard_params(params, mesh, True)
        assert local.decoder.w.shape[0] == 1
        enc_full = multinn.tree_leaves(params.encoder)[0]
        enc_local = multinn.tree_leaves(local.encoder)[0]
        assert enc_local.shape == ((1, *enc_full.shape[1:]) if enc_split
                                   else enc_full.shape)
        # and nothing is split without track sharding
        _, dec = mesh_mod.leaf_specs(params, mesh, False)
        assert all(set(sp) == {None} for sp in dec)


# -- training steps -----------------------------------------------------------

@pytest.mark.parametrize("n_data", [2, 4])
@pytest.mark.parametrize("style,dec", [("gspmd", "rnn-nade"),
                                       ("gspmd", "rnn-rbm"),
                                       ("shard_map", "rnn-nade")])
def test_dp_step_matches_single_device(request, n_data, style, dec):
    """One train step on data=2 and data=4. gspmd is the global view (the
    RBM's chain on each row's stream of the whole batch); the NADE loss is
    key-independent, so shard_map equals one device too."""
    out = request.getfixturevalue(f"w{n_data}")
    fam = "nade" if dec == "rnn-nade" else "rbm"
    _check_step(out, f"dp{n_data}_{style}_{fam}", n_data)


@pytest.mark.parametrize("n_data", [2, 4])
def test_rbm_shard_map_step_is_the_mean_of_shard_steps(request, n_data):
    """shard_map's RBM step folds the key by shard: it equals one step on
    the mean of one device's gradients of each shard's rows under
    ``fold_in(key, shard)``."""
    a = ranks.load(request.getfixturevalue(f"w{n_data}"),
                   f"dp{n_data}_shard_map_rbm")
    np.testing.assert_allclose(a["loss"], a["ref_loss"], rtol=1e-5)
    for i in range(_n(a, "ref_p")):
        np.testing.assert_allclose(a[f"p{i}"], a[f"ref_p{i}"], **STEP_TOL)


@pytest.mark.parametrize("mode", ["per-track", "feedback"])
def test_dp_track_gspmd_matches_single_device(w4, mode):
    """data=2 x track=2, NADE decoders; feedback gathers the per-frame
    latents over the track axis."""
    _check_step(w4, f"dp_track_{mode}", 4)


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("dec", ["rnn-nade", "rnn-rbm"])
def test_tp_step_matches_single_device(request, n_model, dec):
    """H over the model axis: the NADE logits are partial sums all-reduced,
    the RBM's free energy sums the gathered softplus columns and its chain
    runs on the gathered W, so its stream is the unsharded one."""
    out = request.getfixturevalue(f"w{n_model}")
    fam = "nade" if dec == "rnn-nade" else "rbm"
    _check_step(out, f"tp{n_model}_{fam}", n_model)


def test_dp_track_model_gspmd_matches_single_device(w8):
    """data=2 x track=2 x model=2, feedback: the latent gather and the TP
    reductions in one step."""
    _check_step(w8, "mesh3d", 8)


def test_dbn_masked_optimizer_gspmd_matches_single_device(w4):
    """A DBN config (frozen encoder, adamw) on data=2 x track=2: the step
    equals one device's and the encoder is untouched (bit-equal to the
    single-device run's, whose encoder the optimizer never holds)."""
    a = _check_step(w4, "dbn_dp_track", 4)
    for i in range(3):                       # the encoder's w, bv, bh
        np.testing.assert_array_equal(a[f"p{i}"], a[f"ref_p{i}"])


def test_pretrain_encoders_on_a_mesh_is_the_global_view(w4):
    """pretrain_encoders on data=2 x track=2 in per-track mode (the
    encoders split over the track axis, one per rank) runs the global view
    on every rank: the gathered encoder equals one device's."""
    a = ranks.load(w4, "pretrain")
    assert a["local_k"] == 1
    n = _n(a, "ref_p")
    assert n == _n(a, "p") == 3
    for i in range(n):
        np.testing.assert_array_equal(a[f"p{i}"], a[f"ref_p{i}"])


@pytest.mark.parametrize("name", ["data2", "model2"])
def test_nade_step_on_mesh_matches_jax(w2, name):
    """The NADE per-track loss and gradients on data=2 and on model=2 from
    the JAX Trainer's params equal ``jax.value_and_grad`` of its loss."""
    got = ranks.load(w2, f"jax_{name}")
    want = np.load(w2 / "jax_ref.npz")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    n = _n(want, "g")
    assert n == _n(got, "g") > 0
    for i in range(n):
        np.testing.assert_allclose(got[f"g{i}"], want[f"g{i}"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"{name} grad {i}")


# -- evaluation, Hessian-free, checkpoints ------------------------------------

@pytest.mark.parametrize("style", ["gspmd", "shard_map"])
def test_eval_matches_single_device_with_short_tail(w2, style):
    """evaluate() pads the short tail batch with zero-mask windows and sums
    the frame-weighted sums: exact for metrics linear in frames."""
    a = ranks.load(w2, f"eval_{style}")
    assert "loss_per_track_0" in a
    for name in ("loss", "ll_per_frame", "loss_per_track_0",
                 "loss_per_track_1"):
        np.testing.assert_allclose(a[name], a[f"ref_{name}"], rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(a["f1"], a["ref_f1"], rtol=2e-2)


@pytest.mark.parametrize("world,case", [
    (2, "eval_gspmd"), (2, "eval_gspmd_rbm"), (4, "eval_dp_track_rnn-nade"),
    (4, "eval_dp_track_rnn-rbm")])
def test_gspmd_eval_metrics_equal_single_device(request, world, case):
    """A gspmd evaluation is the global view: every metric equals one
    device's, the ratios (precision, recall, f1, the transduction
    accuracy) of the whole batch's counts and the RBM's sampled monitors
    (reconstruction, pseudo-LL) on the rows' draws of the whole batch —
    on data=2 and on data=2 x track=2 (K=4, feedback)."""
    a = ranks.load(request.getfixturevalue(f"w{world}"), case)
    names = [k[len("ref_"):] for k in a if k.startswith("ref_")]
    assert {"loss", "ll_per_frame", "f1", "precision", "recall",
            "acc_transduction"} <= set(names)
    if "rbm" in case:
        assert {"pll", "bce_recon"} <= set(names)
    for name in names:
        np.testing.assert_allclose(a[name], a[f"ref_{name}"], rtol=1e-5,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("world,case", [
    (2, "detailed_gspmd_rnn-nade"), (2, "detailed_gspmd_rnn-rbm"),
    (4, "detailed_dp_track_rnn-nade"), (4, "detailed_dp_track_rnn-rbm")])
def test_gspmd_detailed_step_metrics_equal_single_device(request, world,
                                                         case):
    """A gspmd step's detailed metrics (a group's last step) are the
    global view: the frame ratios from the data ranks' counts, summed in
    the metrics' one all-reduce, equal one device's, as do the loss, the
    monitors and the gradient norm — on data=2 and on data=2 x track=2
    (K=4, feedback)."""
    a = ranks.load(request.getfixturevalue(f"w{world}"), case)
    names = [k[len("ref_"):] for k in a if k.startswith("ref_")]
    assert set(names) == {k for k in a if not k.startswith("ref_")}
    assert {"loss", "f1", "precision", "recall", "acc_transduction",
            "acc_elementwise", "grad_norm"} <= set(names)
    assert "frame_counts" not in names
    for name in names:
        np.testing.assert_allclose(a[name], a[f"ref_{name}"], rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def _check_hf(out, case):
    a = ranks.load(out, case)
    np.testing.assert_allclose(a["loss"], a["ref_loss"], rtol=1e-5)
    assert a["accepted"] == a["ref_accepted"]
    for i in range(_n(a, "ref_p")):
        np.testing.assert_allclose(a[f"p{i}"], a[f"ref_p{i}"], **HF_TOL)


def test_hf_gspmd_step_matches_single_device(w2):
    _check_hf(w2, "hf_gspmd")


def test_hf_explicit_style_matches_single_device(w2):
    """shard_map: the loss, gradient and every Gauss-Newton product
    averaged over data, so every rank solves one global CG system."""
    _check_hf(w2, "hf_shard_map")


def test_checkpoint_roundtrip_across_topologies(w8):
    """A run trained on data=2 x track=2 x model=2 restores bit for bit on
    data=4 x track=2 and on one device (which then evaluates)."""
    a = ranks.load(w8, "ckpt")
    assert a["resumed_b"] == 1 and a["resumed_one"] == 1
    n = _n(a, "p")
    assert n == _n(a, "b_p") == _n(a, "one_p") > 0
    for i in range(n):
        np.testing.assert_array_equal(a[f"b_p{i}"], a[f"p{i}"])
        np.testing.assert_array_equal(a[f"one_p{i}"], a[f"p{i}"])
    assert np.isfinite(a["one_loss"])


# -- generation and serving ---------------------------------------------------

@pytest.mark.parametrize("dec", ["rnn-nade", "rnn-rbm"])
def test_mesh_sharded_generation_matches_single_device(w2, dec):
    """Seeded generation batch-sharded over data (the whole-generation
    kernel's plain version with the row map): bit-equal to one device, on
    every rank."""
    a = ranks.load(w2, f"gen_{dec}")
    np.testing.assert_array_equal(a["seeded"], a["ref_seeded"])
    np.testing.assert_array_equal(ranks.load(w2, f"gen_{dec}", 1)["seeded"],
                                  a["seeded"])


@pytest.mark.parametrize("dec", ["rnn-nade", "rnn-rbm"])
def test_unseeded_mesh_generation_matches_single_device(w2, dec):
    """Unseeded B=16 bit-equal to one device; B=3, which the data axis does
    not divide, runs whole on every rank and stays equal."""
    a = ranks.load(w2, f"gen_{dec}")
    np.testing.assert_array_equal(a["unseeded"], a["ref_unseeded"])
    assert a["odd"].shape == (3, 6, 2, 24)
    np.testing.assert_array_equal(a["odd"], a["ref_odd"])


@pytest.mark.parametrize("dec", ["rnn-nade", "rnn-rbm"])
def test_scan_path_generation_row_map(w2, dec):
    """The scan path (the Gibbs chain or the NADE sampler per step) on each
    rank's rows with the row map, gathered, equals one device's."""
    a = ranks.load(w2, f"gen_{dec}")
    np.testing.assert_array_equal(a["scan"], a["ref_scan"])


def test_dbn_generation_on_a_data_mesh_decodes_the_whole_batch(w2):
    """A DBN (per-track encoders) generates in latent space; on a data mesh
    the decode draws over the whole batch, gathered first, so the rolls
    (fused and scan path, seeded and not) equal one device's bit for
    bit."""
    a = ranks.load(w2, "gen_dbn")
    for name in ("seeded", "unseeded", "odd", "scan"):
        np.testing.assert_array_equal(a[name], a[f"ref_{name}"],
                                      err_msg=name)


@pytest.mark.parametrize("mode", ["feedback", "per-track"])
def test_track_sharded_generation_matches_single_device(w4, mode):
    """data=2 x track=2: each rank samples its track under split(key1, K)
    and the frames are gathered every step; bit-equal to one device's scan
    path."""
    a = ranks.load(w4, f"tgen_{mode}")
    assert a["dec_w_shape"].tolist() == [1, 24, 12]
    np.testing.assert_array_equal(a["roll"], a["ref_roll"])
    for r in range(1, 4):
        np.testing.assert_array_equal(
            ranks.load(w4, f"tgen_{mode}", r)["roll"], a["roll"])


def test_3d_mesh_generation_matches_single_device(w8):
    """data=2 x track=2 x model=2, feedback: the Generator gathers the H
    shards at construction; bit-equal to one device's scan path."""
    a = ranks.load(w8, "tgen_3d")
    np.testing.assert_array_equal(a["roll"], a["ref_roll"])


def test_mesh_service_matches_single_device(w2):
    """A service on data=2 (rank 0 takes the requests, rank 1 follows its
    broadcast calls) answers seeded and plain requests with the rolls of a
    single-device service, batch for batch and row for row."""
    a = ranks.load(w2, "serve")
    np.testing.assert_array_equal(a["meta"], a["ref_meta"])
    assert a["rolls"].shape == (16, 6, 2, 24)
    np.testing.assert_array_equal(a["rolls"], a["ref_rolls"])


# -- bring-up -----------------------------------------------------------------

def test_init_distributed_arg_plumbing(monkeypatch):
    """The coordinator, world size and rank reach init_process_group as
    given, the backend is chosen (gloo without a card of each rank's own)
    and the store's timeout is 120 s; without a coordinator the env://
    variables are read."""
    calls = []
    monkeypatch.setattr(mesh_mod.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    assert mesh_mod.init_distributed("tcp://localhost:29400", 4, 2) == "gloo"
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "1")
    mesh_mod.init_distributed(backend="gloo")
    (b0, kw0), (b1, kw1) = calls
    assert b0 == "gloo" and kw0["init_method"] == "tcp://localhost:29400"
    assert (kw0["world_size"], kw0["rank"]) == (4, 2)
    assert (kw1["init_method"], kw1["world_size"], kw1["rank"]) == (
        "env://", 3, 1)
    assert kw0["timeout"].total_seconds() == 120
    assert kw1["timeout"].total_seconds() == 120
    assert mesh_mod.choose_backend(1) == ("nccl" if torch.cuda.is_available()
                                          else "gloo")


def test_init_distributed_single_process_smoke(tmp_path):
    """A world of one rank joins through a file store and lays out a mesh
    of one rank."""
    ranks.run_world(tmp_path, 1, "w1", timeout=120)
    a = ranks.load(tmp_path, "w1")
    assert a["world"] == 1 and str(a["backend"]) == "gloo"
    assert a["sizes"].tolist() == [1, 1]


# -- the kernels' row map (plain versions) ------------------------------------

def _rand(shape, gen, scale=1.0, p=None):
    x = torch.rand(shape, generator=gen) if p is not None else \
        scale * torch.randn(shape, generator=gen)
    return (x < p).float() if p is not None else x


@pytest.mark.parametrize("lead", [(), (5,)])
def test_row_map_gibbs_chain(lead):
    """A data shard's rows (b0, B_global) draw what the whole launch draws
    for them: time-major (T, B) rows and plain (B,) rows; the default row
    map is the launch itself."""
    g = torch.Generator().manual_seed(0)
    b, d, h = 12, 10, 7
    v0 = _rand((*lead, b, d), g, p=0.3)
    w = _rand((d, h), g, 0.5)
    bv = _rand((*lead, b, d), g, 0.5)
    bh = _rand((*lead, b, h), g, 0.5)
    key = sampling.PRNGKey(3)
    full = gibbs_cuda.gibbs_chain_plain(key, v0, w, bv, bh, 4)
    assert torch.equal(full, gibbs_cuda.gibbs_chain_plain(
        key, v0, w, bv, bh, 4, rows=(0, b)))
    for b0, n in ((0, 4), (4, 4), (8, 4), (3, 6)):
        part = gibbs_cuda.gibbs_chain_plain(
            key, v0[..., b0:b0 + n, :], w, bv[..., b0:b0 + n, :],
            bh[..., b0:b0 + n, :], 4, rows=(b0, b))
        assert torch.equal(part, full[..., b0:b0 + n, :]), (b0, n)
    with pytest.raises(ValueError, match="do not lie"):
        gibbs_cuda.gibbs_chain_plain(key, v0, w, bv, bh, 4, rows=(1, b))


def test_row_map_nade_sample():
    g = torch.Generator().manual_seed(1)
    b, d, h = 10, 9, 6
    w, v = _rand((d, h), g, 0.5), _rand((d, h), g, 0.5)
    bv, bh = _rand((b, d), g, 0.5), _rand((b, h), g, 0.5)
    key = sampling.PRNGKey(4)
    full = nade_cuda.nade_sample_plain(key, w, v, bv, bh, (b,))
    assert torch.equal(full, nade_cuda.nade_sample_plain(
        key, w, v, bv, bh, (b,), rows=(0, b)))
    for b0, n in ((0, 5), (5, 5), (2, 3)):
        part = nade_cuda.nade_sample_plain(key, w, v, bv[b0:b0 + n],
                                           bh[b0:b0 + n], (n,),
                                           rows=(b0, b))
        assert torch.equal(part, full[b0:b0 + n]), (b0, n)


@pytest.mark.parametrize("dec", ["rnn-rbm", "rnn-nade"])
def test_row_map_whole_generation_kernels(dec):
    """The whole-generation kernels' plain versions on a slice of samples
    with the row map equal that slice of the whole batch's roll and final
    state; the default row map is the batch itself."""
    cfg = multinn.MultINNConfig(**dict(ranks.TINY, mode="feedback",
                                       decoder_type=dec, w_std=0.3))
    params = multinn.init(cfg, torch.Generator().manual_seed(2),
                          device="cpu")
    b, t = 6, 5
    state = multinn.init_state(params, b)
    g = torch.Generator().manual_seed(5)
    h0 = torch.stack([s.h for s in state.decoder.cell]) + _rand(
        (1, 2, b, 8), g, 0.3)
    c0 = torch.stack([s.c for s in state.decoder.cell]) + _rand(
        (1, 2, b, 8), g, 0.3)
    v0 = _rand((2, b, 24), g, p=0.3)
    key = sampling.PRNGKey(6)

    def run(sl, rows):
        args = (key, params.decoder, h0[:, :, sl], c0[:, :, sl], v0[:, sl],
                t)
        if dec == "rnn-rbm":
            return gen_fused_rbm.generate_rbm(*args, 2, impl="plain",
                                              rows=rows)
        return gen_fused_nade.generate_nade(*args, impl="plain", rows=rows)

    full = run(slice(None), None)
    for x, y in zip(full, run(slice(None), (0, b))):
        assert torch.equal(x, y)
    for b0, n in ((0, 3), (3, 3), (2, 2)):
        roll, h, c = run(slice(b0, b0 + n), (b0, b))
        assert torch.equal(roll, full[0][b0:b0 + n]), (b0, n)
        assert torch.equal(h, full[1][:, :, b0:b0 + n])
        assert torch.equal(c, full[2][:, :, b0:b0 + n])
