"""MultINN's per-track model with DBN encoders in multinn_torch, and the
benchmark's parts for it and for RNN-NADE training, on the CPU:

* the benchmark's plain reference (portbench/reference/per_track_dbn.py)
  replays the port's generation, latent chain and decode, to the bit,
  and catches a flipped latent and a flipped decoded cell;
* ``generate(latent=True)`` and the service's ``latent_rows``: the
  model-space roll of the rows asked for, the pianoroll the same bits
  with or without it;
* the decode's span ``gen.dbn_decode``, kept only while the recorder
  times the service's card (stand-ins for the card's stream and events,
  as tests/test_torch_spans.py);
* the new per-layer readers on hand-built records and the frozen count
  against the program's;
* the RNN-NADE training reference (portbench/reference/nade_train.py)
  against the port's Trainer, and tiny copies of the two new cells run
  through the harness, sound and with planted faults.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import sampling  # noqa: E402
from multinn_torch.serving import service  # noqa: E402
from multinn_torch.training.generator import Generator  # noqa: E402
from multinn_torch.utils import config, profiling  # noqa: E402
from portbench import control, run, spec, weights_dbn  # noqa: E402
from portbench import weights as weights_mod  # noqa: E402
from portbench import yardstick_per_track  # noqa: E402
from portbench.reference import nade_train, per_track_dbn  # noqa: E402
from portbench.reference import threefry  # noqa: E402
from portbench.tests.conftest import REPO, _tiny_copy  # noqa: E402
from test_torch_spans import _Event, _Stream  # noqa: E402

torch.set_num_threads(1)
MODEL = dict(n_tracks=5, n_pitches=12, mode="per-track", encoder_hidden=(6,),
             n_hidden=8, n_rnn=8, gen_k=3, w_std=0.5)
T, SEED, BATCH_INDEX = 16, 99, 3
SEED_BIG = 2 ** 31 + 11          # past 32 signed bits, as a run's seed may be


@pytest.fixture
def spans_off():
    """The recorder left off, and emptied, after the test."""
    yield
    profiling.collect()


def _model(**kw):
    return multinn.MultINNConfig(**dict(MODEL, **kw))


def _generated(batch=8, fused=True):
    cfg = _model()
    wts = weights_dbn.draw(cfg, 7, 1.0, "cpu")
    params = weights_dbn.port_params(cfg, wts)
    key = sampling.fold_in(sampling.PRNGKey(SEED, device="cpu"),
                           BATCH_INDEX)
    _, roll, lat = multinn.generate(params, key,
                                    multinn.init_state(params, batch), T,
                                    fused=fused, latent=True)
    return cfg, wts, params, key, roll, lat


def _replay(wts, lat, roll, rows, gen_k):
    keys = [threefry.fold_in(threefry.prng_key(SEED), BATCH_INDEX)] * len(
        rows)
    return (per_track_dbn.latent_replay(wts, lat, keys, rows, gen_k),
            per_track_dbn.decode_replay(wts, lat, roll, keys, rows))


def test_reference_replays_the_ports_generation():
    cfg, wts, _, _, roll, lat = _generated()
    assert 0.1 < float(roll.mean()) < 0.5 and 0.3 < float(lat.mean()) < 0.7
    rows = [1, 4, 6]
    chain, dec = _replay(wts, lat[rows].float(), roll[rows].float(), rows,
                         cfg.gen_k)
    assert chain["frames"].sum() == 0 and chain["margin"].max() == 0
    assert chain["cells"] == T * 5
    assert dec["cells"].sum() == 0 and dec["margin"].max() == 0
    assert dec["cells_per_song"] == T * 5 * 12


@pytest.mark.parametrize("what", ["latent", "decoded"])
def test_a_flipped_bit_is_caught(what):
    cfg, wts, _, _, roll, lat = _generated()
    rows = [2, 5]
    lat, roll = lat[rows].float(), roll[rows].float()
    target = lat if what == "latent" else roll
    target[1, 9, 3, 4] = 1 - target[1, 9, 3, 4]
    chain, dec = _replay(wts, lat, roll, rows, cfg.gen_k)
    if what == "latent":
        # the flipped frame differs, and the next step's chain starts from
        # it; the decode of that frame no longer matches the served cells
        assert chain["frames"][1] >= 1 and chain["margin"][1] > 0
        assert chain["frames"][0] == 0
    else:
        assert dec["cells"].tolist() == [0, 1] and dec["margin"][1] > 0
        assert chain["frames"].sum() == 0


@pytest.mark.parametrize("fused", [True, False])
def test_latents_leave_the_pianoroll_as_it_is(fused):
    """The same bits with and without the latent roll, on the kernel's
    plain version and on the scan path (whose decode then runs after the
    loop); without a DBN the latent roll is the roll."""
    cfg, _, params, key, roll, lat = _generated(fused=fused)
    state = multinn.init_state(params, 8)
    _, plain = multinn.generate(params, key, state, T, fused=fused)
    assert torch.equal(plain, roll)
    assert lat.shape == (8, T, 5, 6) and set(lat.unique().tolist()) <= {0, 1}
    bare = multinn.init(_model(encoder_hidden=()),
                        torch.Generator().manual_seed(1), device="cpu")
    _, r, z = multinn.generate(bare, key, multinn.init_state(bare, 4), T,
                               fused=fused, latent=True)
    assert torch.equal(r, z)


def _exp(model):
    return config.ExperimentConfig(
        model=model, data=config.DataConfig(n_tracks=5, pitch_min=48,
                                            pitch_max=59),
        generate=config.GenerateConfig(n_steps=T))


def _service(latent_rows=(), batch=4, **kw):
    cfg = _model()
    params = weights_dbn.port_params(cfg, weights_dbn.draw(cfg, 7, 1.0,
                                                           "cpu"))
    return service.GenerationService(_exp(cfg), params, service.ServeConfig(
        batch=batch, n_steps=T, max_wait_ms=1.0, seed=SEED, **kw),
        latent_rows=latent_rows), params


@pytest.mark.parametrize("transport", ["packed", "sparse"])
def test_service_returns_the_asked_rows_latents(transport):
    """Every batch's rows 3 and 0 carry their latent roll, the generator's
    for that batch and row; the other rows none; every pianoroll the bits
    of a service that was asked for nothing. Either transport copies the
    latent rows with the roll."""
    svc, params = _service(latent_rows=(3, 0), transport=transport)
    bare, _ = _service(transport=transport)
    try:
        res = [f.result(timeout=120) for f in svc.submit_many(8)]
        plain = [f.result(timeout=120) for f in bare.submit_many(8)]
    finally:
        svc.close()
        bare.close()
    gen = Generator(_exp(params.cfg), params)
    by = {(r.batch_index, r.row): r for r in plain}
    for r in res:
        assert np.array_equal(r.roll, by[(r.batch_index, r.row)].roll)
        if r.row not in (3, 0):
            assert r.latent is None
            continue
        key = sampling.fold_in(sampling.PRNGKey(SEED), r.batch_index)
        _, lat = gen.fetch_with_latents(gen.generate_async(
            key, T, 4, latent_rows=(r.row,)))
        assert r.latent.dtype == np.uint8 and r.latent.shape == (T, 5, 6)
        assert np.array_equal(r.latent, lat[0])
    assert {r.row for r in res if r.latent is not None} == {0, 3}


@pytest.mark.parametrize("rows,kw", [((4,), {}), ((1, 1), {}),
                                     ((0,), {"accompany_tracks": (0,)})])
def test_service_refuses_latent_rows_it_cannot_serve(rows, kw):
    with pytest.raises(ValueError, match="latent_rows"):
        _service(latent_rows=rows, **kw)


@pytest.mark.parametrize("recorder", [True, False])
def test_decode_span_and_counters_only_while_the_card_is_timed(
        monkeypatch, spans_off, recorder):
    """A DBN service whose stream is a stand-in on cuda:0, anchored as
    enable() would anchor it: each batch gives one ``gen.dbn_decode``
    inside its ``serve.card``, with its index. With the recorder off,
    nothing."""
    svc, _ = _service(latent_rows=(1,))
    svc._stream = _Stream("cuda:0")
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    try:
        if recorder:
            profiling.enable(device="cpu")
            first = _Event()
            first.record()
            profiling.recorder._device = torch.device("cuda:0")
            profiling.recorder._anchors = [(first, time.time_ns())]
        res = [f.result(timeout=120) for f in svc.submit_many(6)]
    finally:
        svc.close()
    spans = profiling.collect()
    assert svc.stats()["errors"] == 0
    if not recorder:
        assert spans == []
        return
    batches = {r.batch_index for r in res}
    dec = {s.ident: s for s in spans if s.name == "gen.dbn_decode"}
    card = {s.ident: s for s in spans if s.name == "serve.card"}
    assert set(dec) == set(card) == batches
    assert len([s for s in spans if s.name == "gen.dbn_decode"]) == len(dec)
    for i in batches:
        assert card[i].start_ns <= dec[i].start_ns <= dec[i].end_ns \
            <= card[i].end_ns


# -- the benchmark's parts ----------------------------------------------------

def _dims():
    return yardstick_per_track.dims_of(
        json.loads((REPO / "portbench/configs/lpd5_multinn_rnnrbm.json")
                   .read_text())["model"])


def test_frozen_count_equals_the_programs_plus_the_decode():
    from multinn_torch.utils import flops
    from multinn_torch.utils.config import load_json
    cfg = load_json(str(REPO / "configs/lpd5_multinn_rnnrbm.json")).model
    n = _dims()
    assert n == (5, 84, 64, 150, 100, 1)
    prog = flops.gen_step_flops_rbm(cfg, 1)["model"]
    assert yardstick_per_track.gen_frame_flops(n, 25) == \
        prog + 5 * 2 * 64 * 84
    with pytest.raises(ValueError):
        yardstick_per_track.dims_of(dict(cfg.__dict__, mode="feedback"))


@pytest.mark.parametrize("metric", ["lpd5_serve_mfu",
                                    "serve.dbn_decode_share"])
def test_readers_on_hand_built_records(metric):
    ms = 1_000_000
    spans = [("serve.take", 0, 5 * ms, 0), ("serve.card", 6 * ms, 106 * ms, 0),
             ("gen.dbn_decode", 100 * ms, 102 * ms, 0),
             ("serve.take", 90 * ms, 95 * ms, 1),
             ("serve.card", 106 * ms, 206 * ms, 1),
             ("gen.dbn_decode", 200 * ms, 203 * ms, 1),
             ("serve.take", 290 * ms, 310 * ms, 2),   # ends after the window
             ("serve.card", 310 * ms, 410 * ms, 2),
             ("gen.dbn_decode", 400 * ms, 450 * ms, 2)]
    rec = {"kind": "serve", "mode": "per-track", "dims": _dims(),
           "gen_k": 25, "n_steps": 1024, "songs": 600, "window_s": 30.0,
           "window_ns": [0, 300 * ms], "spans": spans}
    read = spec.metric_reader(metric).read
    if metric == "lpd5_serve_mfu":
        flops = yardstick_per_track.gen_frame_flops(_dims(), 25) * 1024 * 600
        assert math.isclose(read(rec), 100 * flops / (30 * 67e12))
        assert read(dict(rec, mode="feedback")) is None
    else:
        assert math.isclose(read(rec), 100 * 5 / 200)
        no_decode = [s for s in spans if s[0] != "gen.dbn_decode"]
        assert read(dict(rec, spans=no_decode)) is None
        assert read(dict(rec, spans=[])) is None
    assert read(dict(rec, kind="train")) is None


def test_nade_reference_follows_the_programs_group(tmp_path):
    """The reference's exact NLL, gradients and Adam steps against the
    program's Trainer on its CPU path, one group of three steps."""
    from multinn_torch.training.trainer import Trainer

    class Data:
        def n_batches(self, split="train"):
            return 1

    cfg = multinn.MultINNConfig(n_tracks=2, n_pitches=8, mode="feedback",
                                decoder_type="rnn-nade", n_hidden=6,
                                n_rnn=4)
    wts = weights_mod.draw(cfg, 8, 1.0, "cpu")
    x = (torch.rand((3, 4, 6, 2, 8), generator=torch.Generator()
                    .manual_seed(2)) < 0.2).to(torch.uint8)
    exp = config.ExperimentConfig(
        data=config.DataConfig(n_tracks=2, pitch_min=60, pitch_max=67),
        model=cfg, train=config.TrainConfig(steps_per_call=3, seed=4,
                                            log_every_steps=2 ** 30,
                                            ckpt_every_steps=0,
                                            run_dir=str(tmp_path)))
    tr = Trainer(exp, dataset=Data(),
                 params=weights_mod.port_params(cfg, wts), device="cpu")
    key = torch.tensor([12345, 678], dtype=torch.int32).view(torch.uint32)
    out = tr.run_group(x.numpy(), key)
    names = weights_mod.leaf_names(tr.params.decoder)
    prog = dict(zip(names, tr._leaves))
    after, _, losses, norms = nade_train.nade_train(wts, list(x.float()),
                                                    1e-3, 5.0)
    assert np.isclose(float(out["loss"]), losses[-1], rtol=1e-5)
    assert np.isclose(float(out["grad_norm"]), norms[-1], rtol=1e-5)
    for n in names:
        assert torch.allclose(prog[n], after[n], rtol=1e-5, atol=1e-7), n
    assert not torch.allclose(after["v"], wts["v"])


# -- the two new cells through the harness, tiny ------------------------------

TINY_DBN = dict(n_tracks=2, n_pitches=8, encoder_hidden=[4], n_hidden=6,
                n_rnn=4, gen_k=2, w_std=0.5)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """The benchmark's tiny copy (portbench/tests/conftest.py) with
    ``tiny_lpd5.serve`` and ``tiny_nade.train`` beside it."""
    root = _tiny_copy(tmp_path_factory.mktemp("tiny"))
    load = lambda p: json.loads((root / p).read_text())
    save = lambda p, obj: (root / p).write_text(json.dumps(obj, indent=1))
    c = load("configs/lpd5_multinn_rnnrbm.json")
    c.update(name="tiny_lpd5", pitches=[60, 67], bv_shift=1.0)
    c["model"].update(TINY_DBN)
    save("configs/tiny_lpd5.json", c)
    save("workloads/tiny_lpd5.serve.json",
         dict(load("workloads/lpd5_multinn_rnnrbm.serve.json"),
              config="tiny_lpd5", traffic="tiny_closed_dbn"))
    save("traffic/tiny_closed_dbn.json",
         dict(load("traffic/closed_64bar_dbn.json"), n_steps=16, batch=8,
              check_songs=4))
    save("workloads/tiny_nade.train.json",
         dict(load("workloads/nade_flagship.train.json"), config="tiny_nade",
              traffic="tiny_windows_nade"))
    save("traffic/tiny_windows_nade.json",
         dict(load("traffic/bernoulli_windows_nade.json"), pool_windows=64))
    bench_path = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lpd5_multinn_rnnrbm.serve" in m.get("workloads", ()):
            m["workloads"].append("tiny_lpd5.serve")
    bench_path.write_text(json.dumps(bench))
    return root


def _run(root, cell, trace=False, prepare=None):
    return run.run_cell(cell, SEED_BIG, 1.5, trace, device="cpu",
                        t0=time.perf_counter(), root=root, prepare=prepare)


@pytest.mark.parametrize("cell", ["tiny_lpd5.serve", "tiny_nade.train"])
def test_a_sound_run_is_correct(tiny_root, cell):
    line = _run(tiny_root, cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    if cell == "tiny_lpd5.serve":
        assert all(c["value"] == 0 for c in line["checks"].values())
    assert "setup_s" in line["metrics"]


def test_a_traced_serve_run_reads_its_per_layer_metrics(tiny_root):
    """With --trace 1 the recorder is on over the window (the profiler's
    summary stands in, on the CPU): no card is timed there, so the
    decode's share has nothing to read, and the rest report."""
    from portbench import trace

    def prepare(ctx):
        ctx.tracer = trace.Tracer(False, ctx.workdir)
        ctx.tracer.result = {"busy_s": 1.0, "window_s": 1.5, "op_whole": {},
                             "breakdown": {}}
    line = _run(tiny_root, "tiny_lpd5.serve", trace=True, prepare=prepare)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {
        "lpd5_serve_mfu", "serve.queue_wait_p50_ms", "serve.batch_fill",
        "device_idle.serve"}
    assert not profiling.recorder.on


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_planted_fault_is_not_correct(tiny_root, fault):
    out = control.run("tiny_nade.train", SEED_BIG, 1.5, fault, device="cpu",
                      root=tiny_root)
    assert not out["correct"], out["checks"]


def test_the_new_parts_load_no_jax():
    code = ("import sys, portbench.traffic.serve_closed_dbn, "
            "portbench.traffic.train_groups_nade, "
            "portbench.reference.per_track_dbn, "
            "portbench.reference.nade_train, portbench.weights_dbn, "
            "portbench.yardstick_per_track; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    names = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not names & {"jax", "jaxlib", "flax", "multinn_tpu"}
