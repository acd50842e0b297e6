"""multinn_torch's epoch loop against the JAX package's ``Trainer.train()``
on the CPU, and the parts of the loop that a CUDA graph changes.

* ``train()`` for two epochs with ``steps_per_call=2`` (groups, and a
  leftover single step an epoch) from the same params (``from_jax``) on the
  same synthetic data: the logged train losses and the per-epoch valid
  metrics agree within 1e-5, and the best checkpoint's step, the epoch
  reached, the checkpointed epoch and the evaluation key equal the
  reference's. The RBM side runs the Gibbs chain as the Pallas kernel in
  interpret mode on the JAX side, so both draw the same stream. With a zero
  learning rate and patience 1, both stop early at the same epoch.
* A run killed by ``FaultInjected`` and resumed from its checkpoint ends
  with the params of an uninterrupted run, exactly.
* The learning rate on the device (an int32 count tensor) matches optax's
  schedules over 40 steps (rtol 1e-6).
* The group path of the card, with the CUDA graph replaced by a recorder
  that captures by running the group once and replays by running it
  again with the launch counts held: the launch counts a replay adds equal
  N times one eager step's, capture leaves the counts and the trainer's
  state as they were, and the replayed groups equal the eager ones
  exactly.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops import gibbs_pallas  # noqa: E402
from multinn_tpu.training import trainer as jax_trainer  # noqa: E402
from multinn_tpu.utils import config as jax_config  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import _build, sampling  # noqa: E402
from multinn_torch.training import trainer  # noqa: E402
from multinn_torch.utils import config  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402
from torch_mesh_ranks import RecorderGraph  # noqa: E402

torch.set_num_threads(1)
K, D = 2, 24
MODEL = dict(n_tracks=K, n_pitches=D, mode="feedback", n_hidden=6, n_rnn=4,
             cd_k=1, gen_k=2, w_std=0.5)
DATA = dict(dataset="synthetic", n_tracks=K, pitch_min=48,
            pitch_max=48 + D - 1, window=6, batch_size=3, synthetic_songs=6,
            synthetic_steps=20, transpose_range=2)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def interpret_chain(monkeypatch):
    """The JAX dispatch runs the Pallas chain in interpret mode (the port
    draws the same stream)."""
    orig = gibbs_pallas.gibbs_chain
    monkeypatch.setenv("MULTINN_GIBBS_IMPL", "pallas")
    monkeypatch.setattr(
        gibbs_pallas, "gibbs_chain",
        lambda key, v0, w, bv, bh, k, interpret=True: orig(
            key, v0, w, bv, bh, k, True))


def _cfg(run_dir, decoder="rnn-nade", **train):
    return config.ExperimentConfig(
        name="loop", data=config.DataConfig(**DATA),
        model=multinn.MultINNConfig(**dict(MODEL, decoder_type=decoder)),
        train=config.TrainConfig(**dict(dict(
            epochs=2, lr=3e-3, seed=5, steps_per_call=2, log_every_steps=2,
            ckpt_every_steps=0, run_dir=str(run_dir)), **train))).validate()


def _records(run_dir, split):
    with open(run_dir / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in ("time", "steps_per_sec")}
            for r in rows if r["split"] == split]


def _same_records(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in w:
            if name not in ("step", "split"):
                np.testing.assert_allclose(g[name], w[name], **TOL,
                                           err_msg=name)


def _both(tmp_path, decoder, **train):
    cfg = _cfg(tmp_path / "torch", decoder, **train)
    jcfg = jax_config.from_dict(jax_config.ExperimentConfig,
                                dict(config.to_dict(cfg), train=dict(
                                    config.to_dict(cfg)["train"],
                                    run_dir=str(tmp_path / "jax"))))
    jp = jax_multinn.init(jax.random.PRNGKey(1), jcfg.model)
    jt = jax_trainer.Trainer(jcfg, params=jp)
    tt = trainer.Trainer(cfg, params=from_jax(jp, device="cpu"))
    return tt, jt


@pytest.mark.parametrize("decoder", ["rnn-nade", "rnn-rbm"])
def test_train_matches_the_jax_trainer(tmp_path, decoder, interpret_chain):
    tt, jt = _both(tmp_path, decoder)
    assert tt.dataset.n_batches("train") == jt.dataset.n_batches("train") == 5
    got, want = tt.train(), jt.train()
    jt.ckpt.wait()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **TOL,
                                   err_msg=name)
    train_rows = _records(tmp_path / "torch", "train")
    assert [r["step"] for r in train_rows] == [2, 4, 7, 9, 10]
    _same_records(train_rows, _records(tmp_path / "jax", "train"))
    _same_records(_records(tmp_path / "torch", "valid"),
                  _records(tmp_path / "jax", "valid"))
    assert (tt.step, tt.epoch, tt.epoch_step0) == (jt.step, jt.epoch,
                                                   jt.epoch_step0) == (10, 2,
                                                                       10)
    assert tt.ckpt.best_step() == jt.ckpt.best_step()
    assert tt.ckpt.latest_step() == jt.ckpt.latest_step() == 10
    # the checkpointed epoch, and the evaluation key it gives
    assert tt.ckpt.restore()[0]["epoch"] == 2
    jstate = jt.ckpt.restore(dict(jt._state_dict(), epoch_step0=-1))[0]
    assert int(jstate["epoch"]) == 2
    np.testing.assert_array_equal(
        sampling.PRNGKey(tt.cfg.train.seed + 1000 + tt.epoch).numpy(),
        np.asarray(jax.random.PRNGKey(jt.cfg.train.seed + 1000 + jt.epoch)))
    tt.close()
    jt.close()


def test_early_stop_epoch_matches_the_jax_trainer(tmp_path):
    """lr 0: the exact NADE likelihood never improves after epoch 1, so
    patience 1 stops both at epoch 2 of 5; of the two equal checkpoints the
    later is the best, as orbax picks."""
    tt, jt = _both(tmp_path, "rnn-nade", lr=0.0, epochs=5,
                   early_stop_patience=1, steps_per_call=1)
    tt.train(), jt.train()
    jt.ckpt.wait()
    assert tt.epoch == jt.epoch == 2
    assert tt.ckpt.best_step() == jt.ckpt.best_step() == 10
    _same_records(_records(tmp_path / "torch", "valid"),
                  _records(tmp_path / "jax", "valid"))
    tt.close()
    jt.close()


def test_fault_injected_run_resumes_to_the_uninterrupted_params(tmp_path):
    """ckpt_every_steps=2 and a fault at step 3: the resumed run continues
    epoch 0 from batch 2 (its cursor), so it takes every batch once."""
    whole = trainer.Trainer(_cfg(tmp_path / "whole", ckpt_every_steps=2),
                            device="cpu")
    whole.train()
    cfg = _cfg(tmp_path / "fault", ckpt_every_steps=2, fault_inject_step=3)
    first = trainer.Trainer(cfg, device="cpu")
    with pytest.raises(trainer.FaultInjected):
        first.train()
    assert first.ckpt.latest_step() == 2
    again = trainer.Trainer(_cfg(tmp_path / "fault", ckpt_every_steps=2),
                            device="cpu")
    assert again.maybe_resume()
    assert (again.step, again.epoch) == (2, 0)
    again.train()
    assert again.step == whole.step == 10 and again.epoch == 2
    for a, b in zip(again._state_tensors(), whole._state_tensors()):
        assert torch.equal(a, b)
    for t in (whole, first, again):
        t.close()


@pytest.mark.parametrize("kw,steps_per_epoch", [
    (dict(), 0),
    (dict(warmup_steps=4), 0),
    (dict(lr_schedule="cosine", lr_min=1e-4, epochs=3), 7),
    (dict(lr_schedule="cosine", warmup_steps=3, decay_steps=12,
          lr_min=2e-4), 0),
    (dict(lr_schedule="cosine", warmup_steps=30, decay_steps=12), 0)])
def test_device_schedule_matches_optax(kw, steps_per_epoch):
    cfg = config.TrainConfig(**kw)
    want = jax_trainer.make_schedule(cfg, steps_per_epoch)
    got = trainer.make_schedule(cfg, steps_per_epoch)
    for step in range(40):
        lr = got(torch.tensor(step, dtype=torch.int32))
        assert lr.dtype == torch.float32 and lr.dim() == 0
        w = want if isinstance(want, float) else float(want(step))
        np.testing.assert_allclose(float(lr), w, rtol=1e-6, atol=1e-12)


@pytest.fixture
def probe(monkeypatch):
    """A stand-in kernel launch in every loss call: the plain versions
    count nothing on the CPU."""
    real = multinn.loss

    def counted(*a, **kw):
        _build.launches["probe"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(multinn, "loss", counted)


def test_replayed_groups_count_and_equal_eager_groups(tmp_path, probe):
    n = 3
    eager = trainer.Trainer(_cfg(tmp_path / "e", steps_per_call=n),
                            device="cpu")
    graph = trainer.Trainer(_cfg(tmp_path / "g", steps_per_call=n),
                            params=eager.params)
    graph.capture_groups = True
    graph._new_graph = RecorderGraph
    batches = list(eager.dataset.batches("train", epoch=0))
    stacked = np.stack(batches[:n])
    key = sampling.PRNGKey(9)
    _build.launches.clear()
    eager.train_step(eager._to_device(batches[0]), key)
    one_step = _build.launches["probe"]
    assert one_step == 1
    state0 = [t.clone() for t in graph._state_tensors()]
    _build.launches.clear()
    graph.run_group(stacked, key)                  # warm-up, capture, replay
    g = graph.group_graph
    assert g.launches == {"probe": n * one_step}
    # the warm-up's two steps ran; the capture's n are not counted
    assert _build.launches["probe"] == 2 + n * one_step
    # restart both from the same state, then two groups each way
    eager._load_state_tensors(state0)
    graph._load_state_tensors(state0)
    for i in range(2):
        xs = np.stack(batches[i:i + n])
        k = sampling.PRNGKey(20 + i)
        _build.launches.clear()
        got = graph.run_group(xs, k)
        assert _build.launches == {"probe": n * one_step}
        want = eager.run_group(xs, k)
        for name in want:
            assert torch.equal(got[name], want[name]), name
        for a, b in zip(graph._state_tensors(), eager._state_tensors()):
            assert torch.equal(a, b)
    assert int(graph.opt_state["count"]) == 2 * n
    with pytest.raises(ValueError, match="captured group"):
        graph.run_group(stacked[:, :2], key)
    eager.close()
    graph.close()


def test_capture_leaves_the_trainer_state(tmp_path):
    tr = trainer.Trainer(_cfg(tmp_path, steps_per_call=2), device="cpu")
    tr.capture_groups = True
    tr._new_graph = RecorderGraph
    before = [t.clone() for t in tr._state_tensors()]
    stacked = np.stack(list(tr.dataset.batches("train"))[:2])
    graph = trainer.StepGroupGraph(tr, 2, stacked.shape[1:], RecorderGraph())
    for a, b in zip(tr._state_tensors(), before):
        assert torch.equal(a, b)
    assert set(graph.out) >= {"loss", "loss_mean", "grad_norm", "f1"}
    tr.close()
