"""multinn_torch's trainer with DBN encoders against the JAX package's on
the CPU, the JAX Gibbs chain and NADE sampler run as the Pallas kernels in
interpret mode (the port's stream).

* Three Adam steps under weight decay (adamw): the decoders within
  1e-4 of JAX's ``make_optimizer(freeze_encoder=True)``, the encoder
  bit-identical to its start in both.
* ``pretrain_encoders`` then ``train()`` against JAX ``Trainer.train()``
  for a shared (feedback RNN-NADE) and per-track (RNN-RBM) encoder: the
  pre-trained encoder within 1e-5, the key after pre-training equal, the
  logged and validation metrics within 1e-4; a fresh trainer restores
  the encoder from the checkpoint.
* ``python -m multinn_torch.train`` on ``configs/lpd5_feedback_rnnnade.json``
  with the synthetic source and narrow widths pre-trains and trains.
"""

import json
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops import gibbs_pallas, nade_pallas  # noqa: E402
from multinn_tpu.ops import nade_ops as jax_nade_ops  # noqa: E402
from multinn_tpu.training import trainer as jax_trainer  # noqa: E402
from multinn_tpu.utils import config as jax_config  # noqa: E402
from multinn_torch import train as train_cli  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import sampling  # noqa: E402
from multinn_torch.training import trainer  # noqa: E402
from multinn_torch.utils import config  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402
from multinn_torch.utils.logging import setup_logger  # noqa: E402

torch.set_num_threads(1)
K, D = 2, 24                 # the synthetic source needs 24 pitches
MODEL = dict(n_tracks=K, n_pitches=D, n_hidden=10, n_rnn=6, cd_k=1, gen_k=2,
             w_std=0.5, encoder_hidden=(6,))


@pytest.fixture
def interpret_samplers(monkeypatch):
    """The JAX dispatch runs the Pallas Gibbs chain and NADE sampler in
    interpret mode, so it draws the port's stream."""
    chain = gibbs_pallas.gibbs_chain
    monkeypatch.setenv("MULTINN_GIBBS_IMPL", "pallas")
    monkeypatch.setattr(
        gibbs_pallas, "gibbs_chain",
        lambda key, v0, w, bv, bh, k, interpret=True: chain(
            key, v0, w, bv, bh, k, True))
    monkeypatch.setattr(
        jax_nade_ops, "nade_sample",
        lambda key, w, v, bv, bh, batch_shape=(), impl="auto":
            nade_pallas.sample(key, w, v, bv, bh, batch_shape, True))


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _exp(run_dir, decoder="rnn-nade", mode="feedback", **train):
    return config.ExperimentConfig(
        name="dbn",
        data=config.DataConfig(dataset="synthetic", n_tracks=K, pitch_min=48,
                               pitch_max=48 + D - 1, window=6, batch_size=3,
                               synthetic_songs=6, synthetic_steps=20,
                               transpose_range=2),
        model=multinn.MultINNConfig(**dict(MODEL, decoder_type=decoder,
                                           mode=mode)),
        train=config.TrainConfig(**dict(dict(
            epochs=2, lr=3e-3, seed=5, steps_per_call=2, log_every_steps=2,
            ckpt_every_steps=0, pretrain_encoder_epochs=1,
            pretrain_lr=0.05, run_dir=str(run_dir)), **train))).validate()


def _both(tmp_path, decoder, mode, **train):
    cfg = _exp(tmp_path / "torch", decoder, mode, **train)
    d = config.to_dict(cfg)
    jcfg = jax_config.from_dict(jax_config.ExperimentConfig, dict(
        d, train=dict(d["train"], run_dir=str(tmp_path / "jax"))))
    jp = jax_multinn.init(jax.random.PRNGKey(1), jcfg.model)
    return (trainer.Trainer(cfg, params=from_jax(jp, device="cpu")),
            jax_trainer.Trainer(jcfg, params=jp))


def test_three_adam_steps_under_weight_decay_keep_the_encoder(
        tmp_path, interpret_samplers):
    """JAX's make_optimizer(freeze_encoder=True) under adamw against the
    port's Trainer: decoders within 1e-5, the encoder bit-identical to its
    start in both (weight decay is gradient-independent, so a frozen
    encoder must be out of the optimizer entirely)."""
    import optax
    tt, jt = _both(tmp_path, "rnn-nade", "feedback", weight_decay=0.01)
    enc0 = [x.clone() for x in multinn.tree_leaves(tt.params.encoder)]
    jp = jt.params
    opt = jax_trainer.make_optimizer(jt.cfg.train, freeze_encoder=True)
    state = opt.init(jp)
    batches = list(tt.dataset.batches("train", epoch=0))[:3]

    @jax.jit
    def step(p, st, x, key):
        (loss, _), grads = jax.value_and_grad(
            lambda q: jax_multinn.loss(q, key, x, detailed=False),
            has_aux=True)(p)
        updates, st = opt.update(grads, st, p)
        return optax.apply_updates(p, updates), st, loss

    for i, b in enumerate(batches):
        x = np.asarray(b, np.float32)
        jp, state, jl = step(jp, state, jnp.asarray(x),
                             jax.random.PRNGKey(10 + i))
        m = tt.train_step(t(x), sampling.PRNGKey(10 + i))
        _close(m["loss"], jl, rtol=1e-5, atol=1e-5)
    for a, b, c in zip(multinn.tree_leaves(tt.params.encoder), enc0,
                       jax.tree.leaves(jp.encoder)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    for a, b in zip(tt._leaves, jax.tree.leaves(jp.decoder)):
        _close(a, b, rtol=1e-4, atol=2e-6)
    # the decoders did move
    assert not torch.equal(tt._leaves[0], t(jt.params.decoder.cell[0].wx))
    tt.close()
    jt.close()


def _records(run_dir, split):
    with open(run_dir / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in ("time", "steps_per_sec")}
            for r in rows if r["split"] == split]


@pytest.mark.parametrize("decoder,mode,train", [
    ("rnn-nade", "feedback", {}),
    # single detailed steps and no evaluation: one JAX program to compile
    ("rnn-rbm", "per-track", dict(steps_per_call=1, log_every_steps=1,
                                  eval_every_epochs=3))])
def test_pretrain_then_train_matches_the_jax_trainer(tmp_path, decoder, mode,
                                                     train,
                                                     interpret_samplers):
    tt, jt = _both(tmp_path, decoder, mode, **train)
    got, want = tt.train(), jt.train()
    jt.ckpt.wait()
    for a, b in zip(multinn.tree_leaves(tt.params.encoder),
                    jax.tree.leaves(jt.params.encoder)):
        _close(a, b, rtol=1e-5, atol=1e-5)
    assert tt.calibration is not None and 0 < tt.calibration["ratio"]
    np.testing.assert_array_equal(tt.rng.numpy(), np.asarray(jt.rng))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    for split in ("train", "valid"):
        rows, jrows = (_records(tmp_path / "torch", split),
                       _records(tmp_path / "jax", split))
        assert [r["step"] for r in rows] == [r["step"] for r in jrows]
        for r, w in zip(rows, jrows):
            for name in w:
                if name not in ("step", "split"):
                    np.testing.assert_allclose(r[name], w[name], rtol=1e-4,
                                               atol=1e-4, err_msg=name)
    # the checkpoint holds the encoder; a fresh trainer restores it
    fresh = trainer.Trainer(tt.cfg, params=from_jax(
        jax_multinn.init(jax.random.PRNGKey(2), jt.cfg.model), device="cpu"))
    fresh.restore()
    for a, b in zip(fresh._all_leaves, tt._all_leaves):
        assert torch.equal(a, b)
    for tr in (tt, jt, fresh):
        tr.close()




def test_cli_pretrains_and_trains_the_dbn_config(tmp_path):
    """The shipped DBN config on the synthetic source at narrow widths: the
    encoder is pre-trained (the log's CD-loss and calibration lines), then
    trained into checkpoints whose params start with the encoder's."""
    run = tmp_path / "run"
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    logger = setup_logger()              # configured before it is watched
    logger.addHandler(handler)
    try:
        assert train_cli.main([
            "--config", "configs/lpd5_feedback_rnnnade.json",
            "--device", "cpu", "--data.source=synthetic",
            "--data.synthetic_songs=4", "--data.synthetic_steps=32",
            "--data.window=8", "--data.batch_size=4", "--model.n_hidden=8",
            "--model.n_rnn=6", "--model.encoder_hidden=[6]",
            "--train.epochs=1", "--train.pretrain_encoder_epochs=1",
            "--train.steps_per_call=2", "--train.log_every_steps=1",
            f"--train.run_dir={run}"]) == 0
    finally:
        logger.removeHandler(handler)
    cfg = config.load_json(str(run / "config.json"))
    assert cfg.model.encoder_hidden == (6,) and cfg.data.source == "synthetic"
    assert cfg.model.mode == "feedback" and cfg.model.n_pitches == 84
    log = "\n".join(messages)
    assert "pretrain layer 0 epoch 0 cd-loss" in log
    assert "pretrained decode calibration" in log
    rows = _records(run, "valid")
    assert rows and all(np.isfinite(r["loss"]) for r in rows)
    state = trainer.Checkpointer(str(run / "ckpt")).restore()[0]
    assert tuple(state["params"][0].shape) == (84, 6)     # encoder w first
