"""multinn_torch's Trainer against the JAX package's training step on the
CPU: the learning-rate schedules and the clip against optax, three Adam
steps of each decoder family against ``make_optimizer`` + ``multinn.loss``
(trainer.py's step) from the same params, batches and keys, and
``evaluate`` on a masked short tail batch against the JAX eval step's
frame-weighted math.

The data is the JAX package's synthetic ``Dataset`` (the port's Trainer is
duck-typed on its interface). The RBM side runs the Gibbs chain as the
Pallas kernel in interpret mode on the JAX side, so both draw the same
stream; tolerances are float32 (the frameworks sum in other orders)."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from multinn_tpu.data.datasets import DataConfig, Dataset  # noqa: E402
from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops import gibbs_pallas  # noqa: E402
from multinn_tpu.training import trainer as jax_trainer  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.training import trainer  # noqa: E402
from multinn_torch.utils import config  # noqa: E402
from multinn_torch.utils.convert import from_jax, to_numpy  # noqa: E402

torch.set_num_threads(1)
K, D = 2, 24
MODEL = dict(n_tracks=K, n_pitches=D, mode="feedback", n_hidden=6, n_rnn=4,
             cd_k=1, gen_k=2, w_std=0.5)


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


def _dataset():
    return Dataset(DataConfig(dataset="synthetic", n_tracks=K, pitch_min=48,
                              pitch_max=48 + D - 1, window=6, batch_size=3,
                              synthetic_songs=6, synthetic_steps=20))


def _train_cfg(**kw):
    return config.TrainConfig(**kw)


@pytest.mark.parametrize("kw,steps_per_epoch", [
    (dict(), 0),
    (dict(warmup_steps=4), 0),
    (dict(lr_schedule="cosine", lr_min=1e-4, epochs=3), 7),
    (dict(lr_schedule="cosine", warmup_steps=3, decay_steps=12,
          lr_min=2e-4), 0),
    (dict(lr_schedule="cosine", warmup_steps=30, decay_steps=12), 0)])
def test_schedules_match_optax(kw, steps_per_epoch):
    cfg = _train_cfg(**kw)
    want = jax_trainer.make_schedule(cfg, steps_per_epoch)
    got = trainer.make_schedule(cfg, steps_per_epoch)
    for step in range(0, 40, 3):
        w = want if isinstance(want, float) else float(want(step))
        np.testing.assert_allclose(got(step), w, rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError):
        trainer.make_schedule(_train_cfg(lr_schedule="step"))


@pytest.mark.parametrize("kw", [
    dict(), dict(optimizer="sgd"), dict(weight_decay=0.1),
    dict(optimizer="sgd", weight_decay=0.1), dict(grad_clip=0.0),
    dict(lr_schedule="cosine", warmup_steps=2, decay_steps=6)])
def test_optimizer_and_clip_match_optax(kw):
    """Three updates of two leaves, one gradient far above the clip and
    two below it."""
    cfg = _train_cfg(**dict(dict(grad_clip=1.0, lr=0.05), **kw))
    rng = np.random.default_rng(0)
    params = [rng.normal(0, 1, (3, 4)).astype(np.float32),
              rng.normal(0, 1, (5,)).astype(np.float32)]
    grads = [[rng.normal(0, s, p.shape).astype(np.float32) for p in params]
             for s in (3.0, 0.1, 0.2)]
    opt = jax_trainer.make_optimizer(cfg)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    ours = trainer.make_optimizer(cfg)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = ours.init(tp)
    for g in grads:
        jg = [jnp.asarray(x) for x in g]
        upd, state = opt.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        norm = ours.update(tp, [torch.from_numpy(x) for x in g], tstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    with pytest.raises(ValueError):
        trainer.make_optimizer(_train_cfg(optimizer="rmsprop"))


def _jax_steps(jp, cfg, batches, n_steps):
    """The JAX trainer's hot step (trainer.py:289-300) with its key
    sequence. Returns per-step (loss, grad_norm, params)."""
    opt = jax_trainer.make_optimizer(cfg.train, steps_per_epoch=n_steps)
    state = opt.init(jp)
    rng = jax.random.PRNGKey(cfg.train.seed)
    rng, _ = jax.random.split(rng)

    def step(params, opt_state, batch, key, detailed):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: jax_multinn.loss(p, key, batch, detailed=detailed),
            has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        metrics["grad_norm"] = optax.global_norm(grads)
        return optax.apply_updates(params, updates), opt_state, metrics

    hot = jax.jit(lambda *a: step(*a, False))
    out = []
    for i, batch in enumerate(batches[:n_steps]):
        rng, key = jax.random.split(rng)
        jp, state, m = hot(jp, state, jnp.asarray(batch, jnp.float32), key)
        out.append((float(m["loss"]), float(m["grad_norm"]), jp))
    return out


def _compare_params(got, jp, tol):
    """``got``: to_numpy's tree; ``jp``: JAX params."""
    for name in vars(got.decoder):
        if name == "cell":
            continue
        np.testing.assert_allclose(getattr(got.decoder, name),
                                   np.asarray(getattr(jp.decoder, name)),
                                   **tol)
    for gc, jc in zip(got.decoder.cell, jp.decoder.cell):
        for name in ("wx", "wh", "b"):
            np.testing.assert_allclose(getattr(gc, name),
                                       np.asarray(getattr(jc, name)), **tol)


@pytest.mark.parametrize("decoder", ["rnn-nade", "rnn-rbm"])
def test_three_adam_steps_match_the_jax_step(decoder, interpret_chain):
    """A rebuilt dataset iterates the same epoch-0 batches; log_every is
    large, so every step is the hot form, as in the JAX loop above."""
    ds = _dataset()
    cfg = config.ExperimentConfig(
        model=multinn.MultINNConfig(**dict(MODEL, decoder_type=decoder)),
        train=config.TrainConfig(seed=3, log_every_steps=1000))
    jp = jax_multinn.init(jax.random.PRNGKey(1), jax_multinn.MultINNConfig(
        **dict(MODEL, decoder_type=decoder)))
    batches = list(ds.batches("train", epoch=0, augment=True))[:3]
    want = _jax_steps(jp, cfg, batches, 3)

    class ThreeBatches:                  # the Dataset interface, 3 batches
        def n_batches(self, split):
            return 3

        def batches(self, split, epoch=0, **kw):
            return iter(batches)

    tr = trainer.Trainer(cfg, ThreeBatches(),
                         params=from_jax(jp, device="cpu"))
    losses = []
    real_step = tr.train_step

    def recording_step(x, key, detailed=False):
        m = real_step(x, key, detailed)
        losses.append((float(m["loss"]), float(m["grad_norm"]),
                       to_numpy(tr.params)))
        return m

    tr.train_step = recording_step
    tr.train_epoch()
    assert tr.step == 3 and tr.epoch == 0     # train() advances the epoch
    tol = dict(rtol=1e-4, atol=2e-6)
    for (loss, gnorm, tparams), (jloss, jgnorm, jparams) in zip(losses, want):
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        np.testing.assert_allclose(gnorm, jgnorm, rtol=1e-4)
        _compare_params(tparams, jparams, tol)


def test_steps_per_call_runs_groups_and_leftovers(tmp_path):
    """steps_per_call=2 over 5 batches: two groups (keys split(key, 2)) and
    one single step; the logged step is the detailed group end. The epoch
    is train()'s to advance, not train_epoch()'s."""
    ds = _dataset()
    cfg = config.ExperimentConfig(
        model=multinn.MultINNConfig(**dict(MODEL, decoder_type="rnn-nade")),
        train=config.TrainConfig(steps_per_call=2, log_every_steps=2,
                                 run_dir=str(tmp_path)))
    tr = trainer.Trainer(cfg, ds, params=from_jax(jax_multinn.init(
        jax.random.PRNGKey(0), jax_multinn.MultINNConfig(
            **dict(MODEL, decoder_type="rnn-nade"))), device="cpu"))
    first = to_numpy(tr.params).decoder.w
    last = tr.train_epoch()
    assert tr.step == ds.n_batches("train") == 5 and tr.epoch == 0
    assert not tr.capture_groups               # the CPU runs groups eagerly
    assert [s for s, _ in tr.history] == [2, 4]
    assert {"loss_mean", "grad_norm", "f1", "nll"} <= set(last)
    assert np.isfinite(last["loss_mean"])
    assert not np.array_equal(first, to_numpy(tr.params).decoder.w)


@pytest.mark.parametrize("decoder", ["rnn-nade", "rnn-rbm"])
def test_evaluate_matches_the_jax_eval_math(decoder, interpret_chain):
    """The valid split ends in a short batch whose second window is mostly
    masked: sums weighted by real frames, as the JAX eval step's."""
    ds = _dataset()
    jcfg = jax_multinn.MultINNConfig(**dict(MODEL, decoder_type=decoder))
    jp = jax_multinn.init(jax.random.PRNGKey(2), jcfg)
    cfg = config.ExperimentConfig(
        model=multinn.MultINNConfig(**dict(MODEL, decoder_type=decoder)),
        train=config.TrainConfig(seed=5))
    tr = trainer.Trainer(cfg, ds, params=from_jax(jp, device="cpu"))
    got = tr.evaluate("valid")

    @jax.jit
    def jax_eval(k, x, mask):
        k_loss, k_ll = jax.random.split(k)
        _, m = jax_multinn.loss(jp, k_loss, x, frame_mask=mask)
        return m, jax_multinn.log_likelihood(jp, k_ll, x, frame_mask=mask)

    sums, n_total = {}, 0.0
    key = jax.random.PRNGKey(cfg.train.seed + 1000 + tr.epoch)
    for batch, mask in ds.batches("valid", shuffle=False,
                                  drop_remainder=False, with_masks=True):
        key, k = jax.random.split(key)
        m, ll = jax_eval(k, jnp.asarray(batch, jnp.float32),
                         jnp.asarray(mask))
        n = float(np.sum(mask))
        m = {name: np.asarray(v) for name, v in m.items()}
        m["ll_per_frame"] = float(jnp.sum(ll)) / (max(n, 1.0) * K)
        for name, v in m.items():
            sums[name] = sums.get(name, 0.0) + v * n
        n_total += n
    want = {}
    for name, v in sums.items():
        if np.ndim(v) == 0:
            want[name] = float(v) / n_total
        else:
            want.update({f"{name}_{i}": float(x) / n_total
                         for i, x in enumerate(v)})
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_unported_features_raise(tmp_path):
    """A mesh without a torch.distributed world is refused at construction
    (the ranks join one first: parallel.mesh.init_distributed), and
    Hessian-free training of an RBM with the reference's ValueError; HF on an RNN-NADE, image
    summaries, DBN encoders, checkpoints, train(), resume and fault
    injection are ported (a DBN encoder is frozen: its tensors are not the
    optimizer's), and pre-training is the reference's no-op for a
    pass-through encoder."""
    ds = types.SimpleNamespace(n_batches=lambda split: 1,
                               batches=lambda *a, **k: iter(()))
    base = config.ExperimentConfig(
        model=multinn.MultINNConfig(**MODEL),
        train=config.TrainConfig(run_dir=str(tmp_path), epochs=1,
                                 fault_inject_step=3,
                                 pretrain_encoder_epochs=1))
    cfg = config.ExperimentConfig(model=base.model,
                                  train=config.TrainConfig(optimizer="hf"))
    with pytest.raises(ValueError, match="rnn-nade"):
        trainer.Trainer(cfg, ds, device="cpu")
    hf_nade = trainer.Trainer(config.ExperimentConfig(
        model=multinn.MultINNConfig(**dict(MODEL, decoder_type="rnn-nade")),
        train=config.TrainConfig(optimizer="hf", hf_lambda0=0.5,
                                 run_dir=str(tmp_path / "hf"))),
        ds, device="cpu")
    assert hf_nade.optimizer is None
    assert float(hf_nade.opt_state.lam) == 0.5
    hf_nade.close()
    images = trainer.Trainer(config.ExperimentConfig(
        model=base.model, train=config.TrainConfig(
            run_dir=str(tmp_path / "images"), image_summaries=True)),
        ds, device="cpu")
    assert images.cfg.train.image_summaries
    images.close()
    dbn = trainer.Trainer(config.ExperimentConfig(
        model=multinn.MultINNConfig(**dict(MODEL, encoder_hidden=(8,))),
        train=base.train), ds, device="cpu")
    enc = multinn.tree_leaves(dbn.params.encoder)
    assert len(enc) == 3 and not any(t.requires_grad for t in enc)
    assert not {id(t) for t in enc} & {id(t) for t in dbn._leaves}
    assert len(dbn._all_leaves) == len(enc) + len(dbn._leaves)
    dbn.close()
    with pytest.raises(RuntimeError, match="init_distributed"):
        trainer.Trainer(config.ExperimentConfig(
            model=base.model, mesh=config.MeshConfig(use_mesh=True)), ds,
            device="cpu")
    tr = trainer.Trainer(base, ds, device="cpu")
    assert tr.device == torch.device("cpu")
    tr.pretrain_encoders()
    assert not tr.maybe_resume()
    with pytest.raises(FileNotFoundError):
        tr.restore()
    assert tr.train() == {} and tr.epoch == 1
    tr.save_checkpoint()
    assert tr.ckpt.latest_step() == 0 and tr.maybe_resume()
    tr.close()


@pytest.mark.parametrize("dtype", ["bf16", "bfloat16"])
def test_bf16_matmul_policy_is_refused(dtype):
    """The JAX trainer runs its step under matmul_dtype's precision policy;
    so does the port now: bf16 is accepted (no longer refused) and the
    trainer's step context carries it, f32 carries none; an unknown dtype
    is still refused by the config."""
    from multinn_torch.ops import precision
    ds = types.SimpleNamespace(n_batches=lambda split: 1)
    cfg = config.ExperimentConfig(model=multinn.MultINNConfig(
        **dict(MODEL, matmul_dtype=dtype)))
    tr = trainer.Trainer(cfg, ds, device="cpu")
    with tr._policy():
        assert precision.matmul_dtype() == torch.bfloat16
    f32 = config.ExperimentConfig(model=multinn.MultINNConfig(
        **dict(MODEL, matmul_dtype="f32")))
    tr32 = trainer.Trainer(f32, ds, device="cpu")
    assert tr32.cfg.model.matmul_dtype == "f32"
    with tr32._policy():
        assert precision.matmul_dtype() is None
    with pytest.raises(ValueError, match="matmul_dtype"):
        multinn.MultINNConfig(**dict(MODEL, matmul_dtype="fp8"))


def test_to_numpy_is_the_inverse_of_from_jax():
    jp = jax_multinn.init(jax.random.PRNGKey(4), jax_multinn.MultINNConfig(
        **dict(MODEL, decoder_type="rnn-nade", rnn_layers=2)))
    tp = from_jax(jp, device="cpu")
    back = from_jax(to_numpy(tp), device="cpu")
    for a, b in zip(multinn.tree_leaves(back), multinn.tree_leaves(tp)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(to_numpy(tp).decoder.v,
                                  np.asarray(jp.decoder.v))
