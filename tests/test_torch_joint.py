"""multinn_torch's joint (composer) mode against the JAX package on the CPU.

Joint mode is one decoder over the K*D-wide concatenated frame; the port
keeps it as a stack of one track (``from_jax`` adds the axis), which is
how the whole-generation kernels take it (gen_common._eff_dims).

* The gates admit the joint flagship (K=5 x D=84 -> one track of 420
  pitches, H=150, U=100) at B=1 and B=8 for both families.
* ``loss``, ``log_likelihood``, ``conditional_logits`` and the loss
  gradients within 1e-5 (float32 sums in other orders), with and without
  a DBN encoder, both families (the JAX RBM chain as the Pallas kernel in
  interpret mode, which draws the port's stream); ``loss_per_track`` (1,).
* The fused path's plain versions bit-equal to the Pallas kernels in
  interpret mode (the roll; the final state within 1e-5), a DBN's roll
  decoded under fold_in(key, 0x5eed); the fused roll against the scan
  path's distribution (per-pitch means over 4 songs of T=96 within 0.13,
  the JAX test's bound for one song); the scan path bit-equal to the JAX
  scan path.
* Three Adam steps and ``evaluate`` in joint mode equal the JAX trainer's;
  the Generator and the service serve a joint config; accompaniment
  raises, in ``generate_accompaniment`` and in a service with
  ``accompany_tracks``; ``--model.mode=composer`` trains and generates
  from the command line.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops import gibbs_pallas, nade_pallas  # noqa: E402
from multinn_tpu.ops import nade_ops as jax_nade_ops  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import (gen_common, gen_fused, gen_fused_nade,  # noqa
                               gen_fused_rbm, sampling)
from multinn_torch.serving import service  # noqa: E402
from multinn_torch.training import trainer  # noqa: E402
from multinn_torch.training.generator import Generator  # noqa: E402
from multinn_torch.utils import config  # noqa: E402
from multinn_torch.utils.convert import from_jax, to_numpy  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
K, D, H, U, T = 3, 8, 10, 6, 6
CASES = [("rnn-nade", ()), ("rnn-nade", (6,)), ("rnn-rbm", ()),
         ("rnn-rbm", (6,))]


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


def _model(decoder="rnn-nade", enc=(), **kw):
    return dict(dict(n_tracks=K, n_pitches=D, mode="joint",
                     decoder_type=decoder, encoder_hidden=enc, n_hidden=H,
                     n_rnn=U, cd_k=1, gen_k=3, w_std=0.5), **kw)


def _params(decoder="rnn-nade", enc=(), seed=0, **kw):
    """JAX params and their port; a DBN's hidden biases drawn away from 0,
    so no feature sits on the threshold."""
    jp = jax_multinn.init(jax.random.PRNGKey(seed),
                          jax_multinn.MultINNConfig(**_model(decoder, enc,
                                                             **kw)))
    rng = np.random.default_rng(seed)
    jp = jp.replace(encoder=tuple(
        e.replace(bh=jnp.asarray(rng.normal(0, 1.0, e.bh.shape),
                                 jnp.float32)) for e in jp.encoder))
    return jp, from_jax(jp, device="cpu")


def _roll(shape, seed, density=0.3):
    return (np.random.default_rng(seed).random(shape) < density).astype(
        np.float32)


def _named(tp, leaves):
    """A list of decoder tensors in tree_leaves order -> to_numpy's tree
    (the JAX layout: joint mode's stack of one dropped)."""
    it = iter(leaves)
    return to_numpy(dataclasses.replace(
        tp, decoder=multinn.tree_map(lambda _: next(it), tp.decoder))).decoder


def _compare_decoder(got, jdec, tol):
    for name in vars(got):
        if name == "cell":
            continue
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(jdec, name)), **tol,
                                   err_msg=name)
    for gc, jc in zip(got.cell, jdec.cell):
        for name in ("wx", "wh", "b"):
            np.testing.assert_allclose(getattr(gc, name),
                                       np.asarray(getattr(jc, name)), **tol,
                                       err_msg=name)


FLAGSHIP = dict(n_tracks=5, n_pitches=84, mode="composer", n_hidden=150,
                n_rnn=100, gen_k=10)


@pytest.mark.parametrize("decoder", ["rnn-rbm", "rnn-nade"])
def test_gates_admit_the_joint_flagship(decoder):
    cfg = multinn.MultINNConfig(**dict(FLAGSHIP, decoder_type=decoder))
    assert cfg.mode == "joint" and multinn.n_decoders(cfg) == 1
    assert gen_common._eff_dims(cfg) == (1, 420)
    gate = (gen_fused.supported if decoder == "rnn-rbm"
            else gen_fused.supported_nade)
    for batch in (1, 8):
        assert gate(cfg, batch, 1024)
    mod = gen_fused_rbm if decoder == "rnn-rbm" else gen_fused_nade
    from multinn_torch.models.base import get_decoder
    params = gen_common._decoder_param_shapes(cfg, get_decoder(decoder))
    assert tuple(params.w.shape) == (1, 420, 150)
    st = torch.empty((1, 1, 8, 100), device="meta")
    v0 = torch.empty((1, 8, 420), device="meta")
    build = (gen_fused_rbm._rbm_args if decoder == "rnn-rbm"
             else gen_fused_nade._nade_args)
    args = build(params, st, st, v0)
    # one 420-wide track: its frames at t-1 and of both parities, h and c,
    # the scratch row, and the lists of one previous and one fresh row
    # the RBM's: bv(t), bh(t) and its chain's mask words, one per 32 units
    # of v (14) and of h (5)
    scr = (max(400, 420 + 150 + 14 + 5) if decoder == "rnn-rbm"
           else max(400, 2 * 420 + 150))
    want = 4 * (420 + 2 * 420 + 2 * 100 + scr) + 2 * (4 + 2 * 420)
    assert mod._sample_bytes(args) == -(-want // 16) * 16
    assert mod._sample_bytes(args) <= gen_common.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("decoder,enc", CASES)
def test_loss_likelihood_logits_and_grads_equal_jax(decoder, enc,
                                                    interpret_samplers):
    jp, tp = _params(decoder, enc, seed=1)
    x = _roll((4, T, K, D), 2)
    key = jax.random.PRNGKey(3)
    mask = (np.arange(T)[None] < np.array([T, 4, 2, T])[:, None]
            ).astype(np.float32)

    def jloss(p):
        return jax_multinn.loss(p, key, jnp.asarray(x), detailed=False,
                                frame_mask=jnp.asarray(mask))[0]

    jl, jg = jax.value_and_grad(jloss)(jp)
    leaves = [t.requires_grad_(True) for t in multinn.tree_leaves(tp.decoder)]
    tl, met = multinn.loss(tp, sampling.PRNGKey(3), torch.from_numpy(x),
                           detailed=False, frame_mask=torch.from_numpy(mask))
    assert met["loss_per_track"].shape == (1,)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    _compare_decoder(_named(tp, torch.autograd.grad(tl, leaves)),
                     jg.decoder, dict(rtol=1e-4, atol=1e-5))
    # the detailed metrics contract, as test_multinn.py's
    _, jm = jax_multinn.loss(jp, key, jnp.asarray(x))
    _, tm = multinn.loss(tp, sampling.PRNGKey(3), torch.from_numpy(x))
    assert set(tm) == set(jm)
    np.testing.assert_allclose(tm["loss_per_track"].numpy(),
                               np.asarray(jm["loss_per_track"]), **TOL)
    jll = jax_multinn.log_likelihood(jp, key, jnp.asarray(x),
                                     frame_mask=jnp.asarray(mask))
    tll = multinn.log_likelihood(tp, sampling.PRNGKey(3), torch.from_numpy(x),
                                 frame_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tll.detach().numpy(), np.asarray(jll), **TOL)
    if decoder == "rnn-nade":
        jlog, jtgt = jax_multinn.conditional_logits(jp, jnp.asarray(x))
        tlog, ttgt = multinn.conditional_logits(tp, torch.from_numpy(x))
        assert tuple(tlog.shape) == (1, T, 4, K * D if not enc else enc[-1])
        np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                                   **TOL)
        np.testing.assert_array_equal(ttgt.numpy(), np.asarray(jtgt))
    else:
        with pytest.raises(ValueError, match="rnn-nade"):
            multinn.conditional_logits(tp, torch.from_numpy(x))


def _primed(decoder, enc, batch, seed):
    jp, tp = _params(decoder, enc, seed=seed)
    seed_roll = _roll((batch, 4, K, D), seed + 7)
    js = jax_multinn.prime(jp, jax_multinn.init_state(jp, batch),
                           jnp.asarray(seed_roll))
    ts = multinn.prime(tp, multinn.init_state(tp, batch),
                       torch.from_numpy(seed_roll))
    for a, b in zip(ts.decoder.cell, js.decoder.cell):
        np.testing.assert_allclose(a.h[0].numpy(), np.asarray(b.h), **TOL)
    return jp, tp, js, ts


@pytest.mark.parametrize("decoder,enc", CASES)
def test_fused_plain_bit_equal_to_pallas_interpret(decoder, enc):
    """The joint decoder as one track of the joint width through each
    kernel's plain version, against JAX's _generate_fused in interpret
    mode; a DBN's latent roll decoded under fold_in(key, 0x5eed)."""
    jp, tp, js, ts = _primed(decoder, enc, 3, seed=2)
    temp = 0.8
    jfin, jroll = jax_multinn._generate_fused(
        jax_multinn.tempered_params(jp, temp), jax.random.PRNGKey(6), js, 7,
        interpret=True, dec_beta=1.0 / temp)
    tfin, troll = multinn.generate(tp, sampling.PRNGKey(6), ts, 7,
                                   temperature=temp)     # the gate: fused
    assert troll.shape == (3, 7, K, D)
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    np.testing.assert_array_equal(tfin.decoder.v_prev[0].numpy(),
                                  np.asarray(jfin.decoder.v_prev))
    for a, b in zip(tfin.decoder.cell, jfin.decoder.cell):
        np.testing.assert_allclose(a.h[0].numpy(), np.asarray(b.h), **TOL)
    assert tfin.ctx is None
    assert 0.02 < float(troll.mean()) < 0.98            # non-degenerate


@pytest.mark.parametrize("decoder", ["rnn-rbm", "rnn-nade"])
def test_fused_roll_matches_scan_distribution(decoder):
    """tests/test_gen_fused.py:366 on the port: fused against scan in
    distribution, the roll contract, the state contract (v_prev the last
    frame of the joint row, one stacked decoder), a continuation."""
    cfg = multinn.MultINNConfig(n_tracks=3, n_pitches=16, mode="joint",
                                decoder_type=decoder, n_hidden=12, n_rnn=10,
                                cd_k=1, gen_k=3, w_std=0.2)
    params = multinn.init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    params.decoder.bv += torch.linspace(-2.0, 2.0, 3 * 16)
    n, b = 96, 4          # 4 songs: the time means of one song's
    # correlated Gibbs samples have a noise floor near the bound
    _, scan_roll = multinn.generate(params, sampling.PRNGKey(1),
                                    multinn.init_state(params, b), n,
                                    fused=False)
    fin, fused_roll = multinn.generate(params, sampling.PRNGKey(2),
                                       multinn.init_state(params, b), n,
                                       fused=True)
    assert fused_roll.shape == scan_roll.shape == (b, n, 3, 16)
    assert set(np.unique(fused_roll.numpy())) <= {0.0, 1.0}
    np.testing.assert_allclose(fused_roll.mean(dim=(0, 1)).numpy(),
                               scan_roll.mean(dim=(0, 1)).numpy(), atol=0.13)
    assert tuple(fin.decoder.v_prev.shape) == (1, b, 48)
    np.testing.assert_array_equal(fin.decoder.v_prev[0].numpy(),
                                  fused_roll[:, -1].reshape(b, -1).numpy())
    assert tuple(fin.decoder.cell[0].h.shape) == (1, b, 10)
    _, roll2 = multinn.generate(params, sampling.PRNGKey(3), fin, 4,
                                fused=True)
    assert roll2.shape == (b, 4, 3, 16)


@pytest.mark.parametrize("decoder,enc", CASES[:3])
def test_scan_path_bit_equal_to_jax(decoder, enc, interpret_samplers):
    """The step loop: the joint decoder draws on the step key itself, the
    DBN decode on ``kd``, as the JAX package's."""
    jp, tp, js, ts = _primed(decoder, enc, 2, seed=4)
    _, jroll = jax.jit(lambda st: jax_multinn.generate(
        jp, jax.random.PRNGKey(8), st, 4, fused=False))(js)
    tfin, troll = multinn.generate(tp, sampling.PRNGKey(8), ts, 4,
                                   fused=False)
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    assert tuple(tfin.decoder.v_prev.shape[:2]) == (1, 2)


@pytest.mark.parametrize("decoder", ["rnn-nade", "rnn-rbm"])
def test_three_adam_steps_and_evaluate_equal_jax(decoder,
                                                 interpret_samplers):
    import optax

    from multinn_tpu.data.datasets import DataConfig, Dataset
    from multinn_tpu.training import trainer as jax_trainer
    ds = Dataset(DataConfig(dataset="synthetic", n_tracks=2, pitch_min=48,
                            pitch_max=71, window=6, batch_size=3,
                            synthetic_songs=6, synthetic_steps=20))
    model = dict(n_tracks=2, n_pitches=24, mode="joint", n_hidden=6,
                 n_rnn=4, decoder_type=decoder, cd_k=1, w_std=0.5)
    jp = jax_multinn.init(jax.random.PRNGKey(1),
                          jax_multinn.MultINNConfig(**model))
    cfg = config.ExperimentConfig(
        model=multinn.MultINNConfig(**model),
        train=config.TrainConfig(seed=3, log_every_steps=1000))
    opt = jax_trainer.make_optimizer(cfg.train, steps_per_epoch=3)
    state = opt.init(jp)
    rng = jax.random.split(jax.random.PRNGKey(3))[0]

    @jax.jit
    def jstep(p, s, batch, k):
        loss, g = jax.value_and_grad(lambda q: jax_multinn.loss(
            q, k, batch, detailed=False)[0])(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    tr = trainer.Trainer(cfg, ds, params=from_jax(jp, device="cpu"))
    for batch in list(ds.batches("train", epoch=0, augment=True))[:3]:
        rng, k = jax.random.split(rng)
        jp, state, jl = jstep(jp, state, jnp.asarray(batch, jnp.float32), k)
        tr.rng, tk = sampling.split(tr.rng)
        m = tr.train_step(tr._to_device(batch), tk)
        np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-5)
    _compare_decoder(to_numpy(tr.params).decoder, jp.decoder,
                     dict(rtol=1e-4, atol=2e-6))
    # evaluate: the JAX eval step's frame-weighted math (ll over K tracks)
    got = tr.evaluate("valid")
    key = jax.random.PRNGKey(cfg.train.seed + 1000 + tr.epoch)
    loss_sum, ll_sum, n_total = 0.0, 0.0, 0.0
    for batch, mask in ds.batches("valid", shuffle=False,
                                  drop_remainder=False, with_masks=True):
        key, k = jax.random.split(key)
        k_loss, k_ll = jax.random.split(k)
        x = jnp.asarray(batch, jnp.float32)
        loss, _ = jax_multinn.loss(jp, k_loss, x, frame_mask=mask)
        ll = jax_multinn.log_likelihood(jp, k_ll, x, frame_mask=mask)
        n = float(np.sum(mask))
        loss_sum += float(loss) * n
        ll_sum += float(jnp.sum(ll)) / (max(n, 1.0) * 2) * n
        n_total += n
    np.testing.assert_allclose(got["loss"], loss_sum / n_total, rtol=1e-5)
    np.testing.assert_allclose(got["ll_per_frame"], ll_sum / n_total,
                               rtol=1e-5)
    assert "loss_per_track_0" in got and "loss_per_track_1" not in got


def _experiment(decoder="rnn-nade", n_steps=6, **kw):
    return config.ExperimentConfig(
        model=multinn.MultINNConfig(**_model(decoder, **kw)),
        data=config.DataConfig(n_tracks=K, pitch_min=24,
                               pitch_max=24 + D - 1),
        generate=config.GenerateConfig(n_steps=n_steps, seed_steps=3))


@pytest.mark.parametrize("decoder", ["rnn-nade", "rnn-rbm"])
def test_generator_and_service_serve_joint(decoder):
    """Generator.generate equals multinn.generate from a fresh state (the
    fused plain version; bit-packed transport); the service answers plain
    and seeded requests; accompaniment raises as in the reference."""
    _, tp = _params(decoder, seed=5)
    cfg = _experiment(decoder)
    gen = Generator(cfg, tp)
    got = gen.generate(sampling.PRNGKey(4), 6, batch=2)
    _, want = multinn.generate(tp, sampling.PRNGKey(4),
                               multinn.init_state(tp, 2), 6)
    assert got.shape == (2, 6, K, D)
    np.testing.assert_array_equal(got, want.numpy().astype(np.uint8))
    with pytest.raises(ValueError, match="joint"):
        gen.accompany(sampling.PRNGKey(0), _roll((2, 6, K, D), 1), (0,))
    for fused in (True, False):
        with pytest.raises(ValueError, match="joint"):
            multinn.generate_accompaniment(
                tp, sampling.PRNGKey(0), multinn.init_state(tp, 2),
                torch.from_numpy(_roll((2, 6, K, D), 1)), (0,),
                fused=fused)
    svc = service.GenerationService(cfg, tp, service.ServeConfig(
        batch=2, n_steps=6, seed_steps=3, max_wait_ms=200.0))
    try:
        seed = (_roll((3, K, D), 2)).astype(np.uint8)
        res = [f.result(timeout=120) for f in
               (svc.submit(), svc.submit(seed=seed), svc.submit())]
        assert all(r.roll.shape == (6, K, D) for r in res)
        assert svc.stats()["batches"] >= 2
    finally:
        svc.close()
    with pytest.raises(ValueError, match="joint"):
        service.GenerationService(cfg, tp, service.ServeConfig(
            batch=2, n_steps=6, accompany_tracks=(0,)))


def test_composer_cli_trains_and_generates(tmp_path):
    from multinn_torch import generate as generate_cli
    from multinn_torch import train as train_cli
    run = str(tmp_path / "run")
    assert train_cli.main([
        "--config", "configs/synthetic_smoke.json", "--device", "cpu",
        "--model.mode=composer", "--model.n_hidden=8", "--model.n_rnn=6",
        "--data.window=16", "--data.synthetic_songs=8",
        "--data.synthetic_steps=48", "--train.epochs=1",
        f"--train.run_dir={run}"]) == 0
    cfg = config.load_json(os.path.join(run, "config.json"))
    assert cfg.model.mode == "joint"
    assert generate_cli.main(["--run", run, "--device", "cpu",
                              "--generate.n_steps=8"]) == 0
    with np.load(os.path.join(run, "samples", "pianorolls.npz")) as z:
        rolls = z["rolls"]
    assert rolls.shape[1:] == (8, 5, 84)


def test_joint_dbn_pretraining_equals_the_jax_trainer(tmp_path,
                                                      interpret_samplers):
    """The joint encoder pre-trains on the concatenated K*D frames: the
    visible-bias marginals and one epoch of CD-1, against JAX
    ``Trainer.pretrain_encoders`` (the chain in interpret mode)."""
    from multinn_tpu.training import trainer as jax_trainer
    from multinn_tpu.utils import config as jax_config
    cfg = config.ExperimentConfig(
        name="joint_dbn",
        data=config.DataConfig(dataset="synthetic", n_tracks=2, pitch_min=48,
                               pitch_max=71, window=6, batch_size=3,
                               synthetic_songs=6, synthetic_steps=20),
        model=multinn.MultINNConfig(n_tracks=2, n_pitches=24, mode="joint",
                                    decoder_type="rnn-nade",
                                    encoder_hidden=(6,), n_hidden=8,
                                    n_rnn=6, w_std=0.5),
        train=config.TrainConfig(pretrain_encoder_epochs=1, pretrain_lr=0.05,
                                 seed=5, run_dir=str(tmp_path / "torch"))
    ).validate()
    d = config.to_dict(cfg)
    jcfg = jax_config.from_dict(jax_config.ExperimentConfig, dict(
        d, train=dict(d["train"], run_dir=str(tmp_path / "jax"))))
    jp = jax_multinn.init(jax.random.PRNGKey(1), jcfg.model)
    tt = trainer.Trainer(cfg, params=from_jax(jp, device="cpu"))
    jt = jax_trainer.Trainer(jcfg, params=jp)
    tt.pretrain_encoders()
    jt.pretrain_encoders()
    for a, b in zip(multinn.tree_leaves(tt.params.encoder),
                    jax.tree.leaves(jt.params.encoder)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert tuple(tt.params.encoder[0].w.shape) == (48, 6)
    np.testing.assert_array_equal(tt.rng.numpy(), np.asarray(jt.rng))
    tt.close()
    jt.close()
