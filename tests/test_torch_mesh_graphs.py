"""Captured step groups on a process mesh: the Trainer's graph path under a
mesh against the eager mesh group, and against the JAX Trainer's fused
multi-step.

Gloo worlds of 2 and 4 CPU ranks (tests/torch_mesh_ranks.py) run each
case with a recorder in place of the CUDA graph (its capture runs the
group once, its replay runs it again with the launch counts held), so
the graph path's bookkeeping runs here: this rank's block of the stacked
batch in the graph's static buffer, the warm-up and capture that leave
the trainer's state as it was, the launch counts a replay adds, and two
groups in a row bit-equal to the eager mesh groups in params, optimizer
state and metrics on every rank. The layouts: gspmd data=2 (both
families), shard_map data=2 (both), seqpipe seq=2, Hessian-free gspmd
data=2 and gspmd data=2 x model=2 (both families); with four tracks
(feedback, the JAX package's tiny multichip flagship) gspmd data=2 x
track=2 (both families; the RBM also in per-track mode) and data=1 x
track=2 x model=2 (RBM). On the card the same path captures the NCCL
collectives (``multinn_torch.scripts.mesh_cards``,
tests/test_torch_cuda.py).

The NADE captured group of 4 steps from the JAX Trainer's params is held
against the JAX Trainer's ``_train_multi`` (its ``_build_multi_step``)
on a CPU mesh of the same layout: data=2 on 2 devices, and data=2 x
track=2 with four tracks on 4 devices; params within rtol 1e-5 / atol
1e-6 (the NADE loss is exact). The capture rule (the card with no
mesh or an NCCL mesh captures; gloo runs eagerly and logs it) is checked
with the device and backend set by hand.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.parallel import mesh as jax_mesh  # noqa: E402
from multinn_tpu.training import trainer as jax_trainer  # noqa: E402
from multinn_tpu.utils import config as jax_config  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.parallel import mesh as mesh_mod  # noqa: E402
from multinn_torch.training import trainer  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

N = 4                                   # steps a group
# case -> (world, this rank's block of the (N, B=8, T=8, K=2, D=24) batch)
# (K=4 cases: the batch is (N, 8, 8, 4, 24), K split over track)
CASES = {"g_gspmd_nade": (2, [N, 4, 8, 2, 24]),
         "g_gspmd_rbm": (2, [N, 4, 8, 2, 24]),
         "g_shard_map_nade": (2, [N, 4, 8, 2, 24]),
         "g_shard_map_rbm": (2, [N, 4, 8, 2, 24]),
         "g_seqpipe_nade": (2, [N, 8, 4, 2, 24]),
         "g_hf_gspmd_nade": (2, [N, 4, 8, 2, 24]),
         "g_jax_nade": (2, [N, 4, 8, 2, 24]),
         "g_dp_tp_nade": (4, [N, 4, 8, 2, 24]),
         "g_dp_tp_rbm": (4, [N, 4, 8, 2, 24]),
         "g_dp_track_nade": (4, [N, 4, 8, 2, 24]),
         "g_dp_track_rbm": (4, [N, 4, 8, 2, 24]),
         "g_pertrack_dp_track_rbm": (4, [N, 4, 8, 2, 24]),
         "g_track_tp_rbm": (4, [N, 8, 8, 2, 24]),
         "g_jax_dp_track_nade": (4, [N, 4, 8, 2, 24])}


def _jax_group(out, monkeypatch, n_devices=2, mesh=None, **kw):
    """The JAX Trainer's NADE multi-step of N steps on a CPU mesh of
    ``n_devices`` (``mesh``; data=2 when None; ``kw`` the config's) from
    its own params, on N seeded train batches (and one more for the ranks'
    second group), under PRNGKey(JAX_GROUP_KEY); its params converted for
    the ranks and the params after the group."""
    real = jax_mesh.make_mesh
    monkeypatch.setattr(jax_trainer.mesh_mod, "make_mesh",
                        lambda cfg: real(cfg, jax.devices()[:n_devices]))
    mesh = mesh or ranks.mesh_cfg()
    cfg = ranks.exp_cfg(out / "jaxg", mesh, steps_per_call=N, **kw)
    jcfg = jax_config.ExperimentConfig(
        name="par", data=jax_config.DataConfig(**dataclasses.asdict(
            cfg.data)), model=jax_multinn.MultINNConfig(
                **dataclasses.asdict(cfg.model)),
        train=jax_config.TrainConfig(**dataclasses.asdict(cfg.train)),
        mesh=jax_config.MeshConfig(**dataclasses.asdict(cfg.mesh)))
    jt = jax_trainer.Trainer(jcfg)
    assert dict(jt.mesh.shape) == {"data": mesh.data or 2,
                                   "track": mesh.track}
    batches = list(jt.dataset.batches("train", epoch=0))
    stacked = np.stack([batches[i % len(batches)] for i in range(N + 1)])
    torch.save([t.clone() for t in multinn.tree_leaves(
        from_jax(jax.device_get(jt.params), device="cpu"))],
        out / "jaxg_params.pt")
    np.save(out / "jaxg_stack.npy", stacked)
    params, _, _ = jt._train_multi(jt.params, jt.opt_state,
                                   jt._put_batch(stacked[:N]),
                                   jax.random.PRNGKey(ranks.JAX_GROUP_KEY))
    want = multinn.tree_leaves(from_jax(jax.device_get(params),
                                        device="cpu"))
    np.savez(out / "jaxg_ref.npz",
             **{f"p{i}": t.numpy() for i, t in enumerate(want)})
    jt.close()


@pytest.fixture(scope="module")
def g2(tmp_path_factory):
    out = tmp_path_factory.mktemp("g2")
    with pytest.MonkeyPatch.context() as mp:
        _jax_group(out, mp)
    ranks.run_world(out, 2, "g2")
    return out


@pytest.fixture(scope="module")
def g4(tmp_path_factory):
    out = tmp_path_factory.mktemp("g4")
    with pytest.MonkeyPatch.context() as mp:
        _jax_group(out, mp, 4, ranks.mesh_cfg(data=2, track=2),
                   **ranks.TRACK4)
    ranks.run_world(out, 4, "g4")
    return out


def _world(request, case):
    world, _ = CASES[case]
    return world, request.getfixturevalue(f"g{world}")


def _n(a, prefix):
    return len([k for k in a if k.startswith(prefix)
                and k[len(prefix):].isdigit()])


@pytest.mark.parametrize("case", list(CASES))
def test_captured_mesh_group_equals_eager(request, case):
    """Two groups in a row, captured and eager, from the same state and
    keys: every state tensor and every metric bit-equal, on every rank;
    every rank ends on the same whole params."""
    world, out = _world(request, case)
    first = None
    for r in range(world):
        a = ranks.load(out, case, r)
        assert str(a["backend"]) == "gloo"
        n = _n(a, "got")
        assert n == _n(a, "want") > 0
        for i in range(n):
            np.testing.assert_array_equal(a[f"got{i}"], a[f"want{i}"],
                                          err_msg=f"{case} r{r} state {i}")
        names = [k[len("g0_want_"):] for k in a if k.startswith("g0_want_")]
        assert {"loss", "loss_mean"} <= set(names)
        for g in range(2):
            for name in names:
                np.testing.assert_array_equal(
                    a[f"g{g}_got_{name}"], a[f"g{g}_want_{name}"],
                    err_msg=f"{case} r{r} group {g} {name}")
        full = [a[f"first{i}"] for i in range(_n(a, "first"))]
        if first is None:
            first = full
        for x, y in zip(full, first):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", list(CASES))
def test_replay_launches_are_n_eager_steps(request, case):
    """Each replay adds N times one eager step's launches on every rank
    (the capture's own are taken back out)."""
    world, out = _world(request, case)
    for r in range(world):
        a = ranks.load(out, case, r)
        assert a["one_step"] >= 1
        assert a["replay0"] == a["replay1"] == N * a["one_step"], r


@pytest.mark.parametrize("case", list(CASES))
def test_warmup_and_capture_leave_the_state(request, case):
    world, out = _world(request, case)
    for r in range(world):
        assert ranks.load(out, case, r)["unchanged"] == 1.0, r


@pytest.mark.parametrize("case", list(CASES))
def test_graph_takes_this_ranks_block(request, case):
    """The graph's static batch buffer is this rank's block: B over
    data, T over seq (K and D whole here)."""
    world, out = _world(request, case)
    for r in range(world):
        assert ranks.load(out, case, r)["block"].tolist() == CASES[case][1]


def _check_jax_group(out, case, world):
    want = np.load(out / "jaxg_ref.npz")
    start = torch.load(out / "jaxg_params.pt")
    assert not all(np.allclose(t.numpy(), want[f"p{i}"], rtol=1e-4,
                               atol=1e-5) for i, t in enumerate(start))
    for r in range(world):
        a = ranks.load(out, case, r)
        n = _n(a, "first")
        assert n == len(want.files) > 0
        for i in range(n):
            np.testing.assert_allclose(a[f"first{i}"], want[f"p{i}"],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"r{r} leaf {i}")


def test_captured_nade_group_matches_jax_multi_step(g2):
    """The port's captured NADE group of N steps on data=2, from the JAX
    Trainer's params on its batches and key, against the JAX Trainer's
    fused multi-step on a 2-device mesh."""
    _check_jax_group(g2, "g_jax_nade", 2)


def test_captured_track_nade_group_matches_jax_multi_step(g4):
    """The same with four tracks (feedback) on data=2 x track=2, against
    the JAX Trainer's multi-step on a 4-device mesh of that layout (the
    JAX package's multichip layout): each rank's tracks, keys and rows,
    and the context gathered over ``track``."""
    _check_jax_group(g4, "g_jax_dp_track_nade", 4)


# -- the capture rule ---------------------------------------------------------

class _Log:
    def __init__(self):
        self.lines = []

    def info(self, msg, *args):
        self.lines.append(msg % args)


def _fake_mesh(backend):
    return mesh_mod.Mesh(("data", "track"), {"data": 2, "track": 1},
                         {"data": 0, "track": 0}, {}, backend)


@pytest.mark.parametrize("device,backend,captures", [
    ("cuda", None, True), ("cuda", "nccl", True), ("cuda", "gloo", False),
    ("cpu", None, False), ("cpu", "gloo", False)])
def test_capture_rule(tmp_path, device, backend, captures):
    """Groups are captured on the card without a mesh or on an NCCL mesh;
    on a gloo mesh they run eagerly and the log says so (once, at
    construction); on the CPU they run eagerly."""
    tr = trainer.Trainer(ranks.exp_cfg(tmp_path, None, steps_per_call=3),
                         device="cpu")
    assert tr.capture_groups is False
    tr.device = torch.device(device)
    tr.mesh = None if backend is None else _fake_mesh(backend)
    tr.log = _Log()
    assert tr._choose_capture() is captures
    eager_logged = [line for line in tr.log.lines if "run eagerly" in line]
    if device == "cuda" and backend == "gloo":
        assert eager_logged == [
            "mesh training on gloo: groups of 3 steps run eagerly "
            "(no CUDA graph)"]
    else:
        assert eager_logged == []
    tr.mesh = None
    tr.close()


@pytest.mark.parametrize("mesh", [None, "nccl"])
def test_graph_mode_on_a_mesh_is_thread_local(tmp_path, monkeypatch, mesh):
    """The trainer's CUDA graph captures in torch's ``thread_local`` error
    mode on a mesh (NCCL's watchdog thread queries events during the
    capture) and in the default ``global`` mode without one."""
    made = []

    class Graph:
        def __init__(self, device, capture_error_mode="global"):
            made.append(capture_error_mode)
    monkeypatch.setattr(trainer, "CudaGraph", Graph)
    tr = trainer.Trainer(ranks.exp_cfg(tmp_path, None), device="cpu")
    tr.mesh = None if mesh is None else _fake_mesh(mesh)
    tr._new_graph()
    assert made == ["global" if mesh is None else "thread_local"]
    tr.mesh = None
    tr.close()


def test_failed_capture_raises_and_never_runs_eagerly(tmp_path):
    """A capture that fails raises out of ``run_group``; the trainer keeps
    capturing (no fallback to eager) and its state is as it was."""
    class Broken(ranks.RecorderGraph):
        def capture(self, fn):
            raise RuntimeError("capture failed")

    tr = trainer.Trainer(ranks.exp_cfg(tmp_path, None, steps_per_call=2),
                         device="cpu")
    tr.capture_groups = True
    tr._new_graph = Broken
    before = [t.clone() for t in tr._state_tensors()]
    stacked = np.stack(list(tr.dataset.batches("train"))[:2])
    from multinn_torch.ops import sampling
    with pytest.raises(RuntimeError, match="capture failed"):
        tr.run_group(stacked, sampling.PRNGKey(0))
    assert tr.capture_groups is True and tr.group_graph is None
    for a, b in zip(tr._state_tensors(), before):
        assert torch.equal(a, b)
    tr.close()


# -- where a rank computes ----------------------------------------------------

@pytest.mark.parametrize("count,rank,want", [
    (1, 0, 0), (1, 3, 0), (4, 1, 1), (4, 3, 3), (4, 4, 0), (2, 3, 1)])
def test_rank_device_spreads_gloo_ranks_over_the_cards(monkeypatch, count,
                                                       rank, want):
    """Under gloo rank r computes on card r % count (a world of 5 on four
    cards: ranks 0 and 4 share card 0); on one card every rank shares
    it."""
    monkeypatch.setattr(mesh_mod.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mesh_mod.torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(mesh_mod.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh_mod.dist, "get_rank", lambda group=None: rank)
    assert mesh_mod.rank_device("gloo") == torch.device("cuda", want)


def test_rank_device_without_a_card_is_the_cpu(monkeypatch):
    monkeypatch.setattr(mesh_mod.torch.cuda, "is_available", lambda: False)
    assert mesh_mod.rank_device("gloo") == torch.device("cpu")


# -- the four-card sets of multinn_torch.scripts.mesh_cards --------------------

@pytest.mark.parametrize("k", [4, 5])
def test_mesh_cards_layouts_split_tracks_only_where_k_divides(k, tmp_path):
    """``layouts(4, k)``: K=4 gives the track set (data=4 as the baseline,
    data=2 x track=2, track=4, data=1 x track=2 x model=2 for both
    families, per-track data=2 x track=2 for the RBM, HF on data=2 x
    track=2), K=5 (the flagship's) the K=5 set with no track axis; every
    layout's config (and its one-device reference's) validates, its axes
    fill the four ranks and its track count divides K."""
    from multinn_torch.scripts import mesh_cards
    sizes = dict(mesh_cards.SIZES, k=k)
    got = mesh_cards.layouts(4, k, sizes)
    names = [case for case, *_ in got]
    assert len(set(names)) == len(names)
    tracks = {case: mesh.get("track", 1) for case, _, _, mesh, _ in got}
    if k == 4:
        assert mesh_cards.track_set(4, k)
        assert names == [
            "gspmd_data4_rbm", "gspmd_data2_track2_rbm", "gspmd_track4_rbm",
            "gspmd_data1_track2_model2_rbm", "gspmd_data4_nade",
            "gspmd_data2_track2_nade", "gspmd_track4_nade",
            "gspmd_data1_track2_model2_nade", "pertrack_data2_track2_rbm",
            "hf_gspmd_data2_track2_nade"]
    else:
        assert not mesh_cards.track_set(4, k)
        assert set(tracks.values()) == {1}
        assert len(names) == 8
    for case, dec, mode, mesh, train in got:
        assert k % tracks[case] == 0
        cfg = mesh_cards._cfg(sizes, dec, mesh, str(tmp_path), mode, **train)
        m = cfg.mesh
        assert (m.resolved_data(4) * m.track * m.model * m.seq) == 4, case
        assert (cfg.model.n_tracks, cfg.model.mode, cfg.data.n_tracks,
                cfg.data.frame_dim) == (k, mode, k, 84)
        one = mesh_cards._cfg(sizes, dec, None, str(tmp_path), mode, **train)
        assert not one.mesh.use_mesh
    assert not mesh_cards.track_set(4, 5) and not mesh_cards.track_set(3, 4)


@pytest.mark.parametrize("k", [4, 5])
def test_mesh_cards_plan_names_every_case(k):
    """``plan(4, sizes)``: the layouts first, in ``layouts``' order, then
    one card's steps, then the generation, evaluation (track set: with the
    short tail), checkpoint, accompaniment and service cases; every name
    is unique."""
    from multinn_torch.scripts import mesh_cards
    sizes = dict(mesh_cards.SIZES, k=k)
    names = [name for name, _ in mesh_cards.plan(4, sizes)]
    n_layouts = len(mesh_cards.layouts(4, k, sizes))
    assert names[:n_layouts] == [c for c, *_ in mesh_cards.layouts(4, k,
                                                                  sizes)]
    assert len(set(names)) == len(names)
    extra = names[n_layouts:]
    if k == 4:
        assert extra == ["one_card_rbm", "one_card_nade"] + [
            f"{case}_{fam}" for fam in ("rbm", "nade") for case in (
                "gen_data2_track2", "gen_data1_track4", "eval_data2_track2",
                "ckpt_data2_track2", "accompany_data2_track2",
                "service_data2_track2")]
    else:
        assert extra == ["one_card_rbm", "one_card_nade", "gen_rbm",
                         "service_rbm", "gen_nade", "service_nade"]


def test_mesh_cards_only_runs_the_cases_that_match(monkeypatch):
    """``run_cases`` with ``ctx["only"]`` runs the matching cases of the
    plan, in its order, each with its wall seconds; None runs them all."""
    from multinn_torch.scripts import mesh_cards
    ran = []

    def fake(world, sizes):
        return [(name, lambda ctx, name=name: ran.append(name) or
                 dict(case=name)) for name in ("gspmd_data4_rbm",
                                               "gspmd_data2_track2_nade",
                                               "eval_data2_track2_rbm")]
    monkeypatch.setattr(mesh_cards, "plan", fake)
    ctx = dict(world=4, sizes=mesh_cards.SIZES, only="data4_|eval_")
    got = list(mesh_cards.run_cases(ctx))
    assert ran == [c["case"] for c in got] == ["gspmd_data4_rbm",
                                               "eval_data2_track2_rbm"]
    assert all(c["wall_s"] >= 0 for c in got)
    ran.clear()
    assert len(list(mesh_cards.run_cases(dict(ctx, only=None)))) == 3


def test_mesh_cards_eval_source_has_a_short_tail():
    """The evaluation's source: the seeded batches, then a short tail
    batch only where the remainder is kept (so an evaluation runs the
    gspmd short-tail path), the same on every construction."""
    from multinn_torch.scripts import mesh_cards
    sizes = dict(mesh_cards.SIZES, k=4, t=8, d=6)
    src = mesh_cards._Rolls(sizes, 8, 2, seed=17, tail=3)
    kept = list(src.batches("valid", drop_remainder=False, with_masks=True))
    assert [len(x) for x, _ in kept] == [8, 8, 3]
    assert all(m.shape == x.shape[:2] and m.all() for x, m in kept)
    assert [len(x) for x in src.batches("train")] == [8, 8]
    again = mesh_cards._Rolls(sizes, 8, 2, seed=17, tail=3)
    np.testing.assert_array_equal(again.tail, src.tail)
    assert [len(x) for x in mesh_cards._Rolls(sizes, 8, 2, 17).batches(
        drop_remainder=False)] == [8, 8]


def test_mesh_cards_world_fails_fast_and_keeps_what_ended(tmp_path):
    """A rank that fails ends the world at once, not at its deadline (a
    failed capture used to hang the other ranks, and NCCL's teardown, for
    the whole 1500 s), and the cases each rank finished still print."""
    import time

    from multinn_torch.scripts import mesh_cards
    t0 = time.time()
    ranks_out, error = mesh_cards.run_world(
        str(tmp_path), 3, timeout=300, target=ranks.failing_cards_rank)
    assert time.time() - t0 < 120
    assert error is not None and "exit" in error.lower()
    assert ranks_out[1]["error"] == "RuntimeError: capture failed"
    assert [r["cases"] for r in ranks_out] == [[], [{"case": "first",
                                                     "ok": True}], []]
    assert ranks_out[0]["error"] == ranks_out[2]["error"] == \
        "wrote no result"
    assert mesh_cards.summarise(ranks_out) == []
