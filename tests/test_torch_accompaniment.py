"""Accompaniment in multinn_torch — ``multinn.generate_accompaniment`` —
against the JAX package on the CPU:

* the fused path (the kernels' given-track merge, their plain versions)
  bit-equal to JAX ``_generate_accomp_fused`` with the Pallas kernels in
  interpret mode, for RNN-RBM and RNN-NADE, pass-through and DBN encoders;
* the scan path in both forms (the sampled subset, and all tracks with a
  select) bit-equal to JAX's scan with the JAX Gibbs chain and NADE
  sampler run as the Pallas kernels in interpret mode;
* the given tracks equal the given roll bit for bit; feedback mode
  conditions on them and per-track mode does not; temperature tempers
  only the sampled tracks; the reference's refusals.

``Generator.accompany`` and the service's accompaniment requests are in
test_torch_accompaniment_serving.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops import gibbs_pallas, nade_pallas  # noqa: E402
from multinn_tpu.ops import nade_ops as jax_nade_ops  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import gen_fused, sampling  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

torch.set_num_threads(1)
K, D, H, U = 3, 10, 8, 6
GIVEN = (0, 2)


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


def _cfg(decoder="rnn-nade", mode="feedback", **kw):
    return dict(dict(n_tracks=K, n_pitches=D, mode=mode,
                     decoder_type=decoder, n_hidden=H, n_rnn=U, cd_k=1,
                     gen_k=3, w_std=0.5), **kw)


def _params(decoder="rnn-nade", mode="feedback", seed=0, **kw):
    """JAX params and their port; a DBN's hidden biases drawn away from 0,
    so no feature sits on the threshold."""
    jp = jax_multinn.init(jax.random.PRNGKey(seed),
                          jax_multinn.MultINNConfig(**_cfg(decoder, mode,
                                                           **kw)))
    rng = np.random.default_rng(seed)
    jp = jp.replace(encoder=tuple(
        e.replace(bh=jnp.asarray(rng.normal(0, 0.5, e.bh.shape),
                                 jnp.float32)) for e in jp.encoder))
    return jp, from_jax(jp, device="cpu")


def _given(b=2, t=6, seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((b, t, K, D)) < density).astype(np.float32)


def _margin(tp, x):
    """The least |pre-activation| of a one-layer DBN over x (the features
    are bit-equal between the packages when it is not tiny)."""
    if not tp.encoder:
        return np.inf
    enc = tp.encoder[0]
    bh = enc.bh if tp.cfg.shared_encoder else enc.bh[:, None]
    xk = torch.from_numpy(x).movedim(2, 0).reshape(K, -1, D)
    return float((xk @ enc.w + bh).abs().min())


CASES = [("rnn-rbm", "feedback", ()), ("rnn-nade", "feedback", ()),
         ("rnn-nade", "feedback", (6,)), ("rnn-rbm", "per-track", (6,))]


@pytest.mark.parametrize("decoder,mode,enc", CASES)
def test_fused_accompaniment_bit_equal_to_jax(decoder, mode, enc):
    jp, tp = _params(decoder, mode, encoder_hidden=enc)
    g = _given()
    assert _margin(tp, g) > 1e-5
    js, ts = jax_multinn.init_state(jp, 2), multinn.init_state(tp, 2)
    jfin, jroll = jax_multinn._generate_accomp_fused(
        jp, jax.random.PRNGKey(4), js, jnp.asarray(g), GIVEN,
        interpret=True)
    tfin, troll = multinn.generate_accompaniment(
        tp, sampling.PRNGKey(4), ts, torch.from_numpy(g), (2, 0, 2),
        fused=True)
    assert troll.shape == g.shape
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    for i in GIVEN:
        np.testing.assert_array_equal(troll[:, :, i].numpy(), g[:, :, i])
    assert set(np.unique(troll.numpy())) <= {0.0, 1.0}
    np.testing.assert_array_equal(tfin.decoder.v_prev.numpy(),
                                  np.asarray(jfin.decoder.v_prev))
    # the default picks the kernel: the gate admits the batch
    _, auto = multinn.generate_accompaniment(
        tp, sampling.PRNGKey(4), ts, torch.from_numpy(g), GIVEN)
    np.testing.assert_array_equal(auto.numpy(), troll.numpy())


@pytest.mark.parametrize("decoder,mode,enc", CASES[:1] + CASES[2:])
def test_scan_accompaniment_bit_equal_to_jax(decoder, mode, enc,
                                             interpret_samplers):
    jp, tp = _params(decoder, mode, seed=1, encoder_hidden=enc)
    g = _given(seed=1)
    assert _margin(tp, g) > 1e-5
    _, jroll = jax.jit(lambda p, s, x: jax_multinn.generate_accompaniment(
        p, jax.random.PRNGKey(5), s, x, GIVEN, fused=False, temperature=0.8)
    )(jp, jax_multinn.init_state(jp, 2), jnp.asarray(g))
    ts = multinn.init_state(tp, 2)
    for subset in (True, False):
        _, troll = multinn.generate_accompaniment(
            tp, sampling.PRNGKey(5), ts, torch.from_numpy(g), GIVEN,
            fused=False, subset=subset, temperature=0.8)
        np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
        for i in GIVEN:
            np.testing.assert_array_equal(troll[:, :, i].numpy(),
                                          g[:, :, i])


@pytest.mark.parametrize("fused", [True, False])
def test_feedback_conditions_on_the_given_music_per_track_does_not(fused):
    """Same key, two given rolls: the sampled tracks react in feedback
    mode (the context carries the given tracks' features) and are
    identical in per-track mode (independent decoders)."""
    g_a = _given(t=12, seed=1, density=0.6)
    g_b = np.zeros_like(g_a)

    def sampled(mode, g):
        _, tp = _params("rnn-nade", mode)
        _, roll = multinn.generate_accompaniment(
            tp, sampling.PRNGKey(3), multinn.init_state(tp, 2),
            torch.from_numpy(g), (0,), fused=fused)
        return roll[:, :, 1:].numpy()

    assert not np.array_equal(sampled("feedback", g_a),
                              sampled("feedback", g_b))
    np.testing.assert_array_equal(sampled("per-track", g_a),
                                  sampled("per-track", g_b))


def test_temperature_tempers_only_the_sampled_tracks():
    _, tp = _params("rnn-nade")
    tp = dataclasses.replace(tp, decoder=dataclasses.replace(
        tp.decoder, bv=tp.decoder.bv - 1.5))
    g = _given(b=4, t=24, density=0.25)
    _, hot = multinn.generate_accompaniment(
        tp, sampling.PRNGKey(1), multinn.init_state(tp, 4),
        torch.from_numpy(g), (0,), temperature=100.0)
    np.testing.assert_array_equal(hot[:, :, 0].numpy(), g[:, :, 0])
    assert 0.4 < float(hot[:, :, 1:].mean()) < 0.6


def test_refusals_and_gates():
    _, tp = _params("rnn-nade")
    g = torch.from_numpy(_given())
    st = multinn.init_state(tp, 2)
    key = sampling.PRNGKey(1)
    for tracks, match in (((), "empty"), ((3,), "out of range"),
                          ((0, 1, 2), "nothing to sample")):
        with pytest.raises(ValueError, match=match):
            multinn.generate_accompaniment(tp, key, st, g, tracks)
    with pytest.raises(ValueError, match="does not match"):
        multinn.generate_accompaniment(tp, key, st, g[:, :, :2], (0,))
    joint = dataclasses.replace(tp, cfg=dataclasses.replace(tp.cfg,
                                                            mode="joint"))
    with pytest.raises(ValueError, match="joint"):
        multinn.generate_accompaniment(joint, key, st, g, (0,))
    # the gates take the accompaniment's arguments: one track to sample
    cfg = tp.cfg
    assert gen_fused.supported_nade(cfg, 2, 6, n_given=2)
    assert not gen_fused.supported_nade(cfg, 2, 6, n_given=K)
    rbm = dataclasses.replace(cfg, decoder_type="rnn-rbm")
    assert gen_fused.supported(rbm, 2, 6, conditioned=True)
    assert not gen_fused.supported(dataclasses.replace(rbm, n_tracks=1), 2,
                                   6, conditioned=True)
