"""multinn_torch's DBN encoders (models/encoders.py) and the model, trainer
and generation paths that run them, against the JAX package on the CPU.

* Every encoder function within 1e-6 of JAX; ``features`` bit for bit,
  on inputs whose pre-activations all lie at least 1e-5 from the
  threshold, and one case pins sigmoid(-1e-7) rounding to 0.5 (so
  ``features`` is 1 there, where ``s >= 0`` would give 0).
* ``from_jax`` -> ``to_numpy`` round-trips exactly, shared and per-track.
* The DBN ``loss``, its gradients, the likelihood, the conditional
  logits and priming (RNN-NADE feedback and hybrid, RNN-RBM per-track,
  the JAX chain as the Pallas kernel in interpret mode).

The DBN generation paths are in test_torch_dbn_generate.py, the trainer's
in test_torch_dbn_train.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import encoders as jax_enc  # noqa: E402
from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.nn import rbm as jax_rbm  # noqa: E402
from multinn_tpu.ops import gibbs_pallas, nade_pallas  # noqa: E402
from multinn_tpu.ops import nade_ops as jax_nade_ops  # noqa: E402
from multinn_torch.models import encoders, multinn  # noqa: E402
from multinn_torch.nn import rbm  # noqa: E402
from multinn_torch.ops import sampling  # noqa: E402
from multinn_torch.utils.convert import from_jax, to_numpy  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)
D, SIZES = 24, (8, 4)     # the synthetic source needs 24 pitches
K = 2


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


def _jax_encoder(seed=0, sizes=SIZES, w_std=0.5):
    rng = np.random.default_rng(seed)
    dims = (D, *sizes)
    return tuple(jax_rbm.RBMParams(
        w=jnp.asarray(rng.normal(0, w_std, (dims[i], dims[i + 1])),
                      jnp.float32),
        bv=jnp.asarray(rng.normal(0, 0.5, dims[i]), jnp.float32),
        bh=jnp.asarray(rng.normal(0, 0.5, dims[i + 1]), jnp.float32))
        for i in range(len(sizes)))


def _port(jenc):
    return tuple(rbm.RBMParams(w=t(p.w), bv=t(p.bv), bh=t(p.bh))
                 for p in jenc)


def _roll(shape, seed, density=0.3):
    return (np.random.default_rng(seed).random(shape) < density).astype(
        np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_encoder_functions_match_jax():
    jenc = _jax_encoder()
    tenc = _port(jenc)
    x = _roll((3, 5, D), 1)
    jx, tx = jnp.asarray(x), t(x)
    _close(encoders.encode(tenc, tx), jax_enc.encode(jenc, jx))
    # the sampled top layer: the same uniforms, compared against close p
    key = 7
    got = encoders.encode(tenc, tx, key=sampling.PRNGKey(key))
    want = jax_enc.encode(jenc, jx, key=jax.random.PRNGKey(key))
    assert set(np.unique(got.numpy())) <= {0.0, 1.0}
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lat = _roll((3, 5, SIZES[-1]), 2, 0.5)
    _close(encoders.decode_logits(tenc, t(lat)),
           jax_enc.decode_logits(jenc, jnp.asarray(lat)))
    _close(encoders.decode(tenc, t(lat)),
           jax_enc.decode(jenc, jnp.asarray(lat)))
    for layer in range(len(SIZES) + 1):
        _close(encoders.layer_inputs(tenc, tx, layer),
               jax_enc.layer_inputs(jenc, jx, layer))
    for got_p, want_p in zip(encoders.init_visible_biases(tenc, tx),
                             jax_enc.init_visible_biases(jenc, jx)):
        for name in ("w", "bv", "bh"):
            _close(getattr(got_p, name), getattr(want_p, name))
    got_c = encoders.decode_calibration(tenc, tx)
    want_c = jax_enc.decode_calibration(jenc, jx)
    assert set(got_c) == set(want_c)
    for name in want_c:
        _close(got_c[name], want_c[name])
    assert encoders.out_dim(encoders.EncoderConfig(D, SIZES)) == SIZES[-1]
    assert encoders.decode((), tx) is tx and encoders.features((), tx) is tx


def test_features_bit_equal_away_from_the_threshold():
    jenc = _jax_encoder(3)
    tenc = _port(jenc)
    x = _roll((4, 6, D), 4)
    # every top-layer pre-activation at least 1e-5 from the threshold, so
    # summation order cannot flip a feature
    pre = (encoders.layer_inputs(tenc, t(x), len(SIZES) - 1)
           @ tenc[-1].w + tenc[-1].bh)
    assert float(pre.abs().min()) > 1e-5
    got = encoders.features(tenc, t(x))
    want = np.asarray(jax_enc.features(jenc, jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1 and not got.requires_grad


def test_threshold_is_taken_on_the_sigmoid():
    """sigmoid(-1e-7) rounds to 0.5 in float32 in both frameworks: the
    feature is 1 there, not the 0 that ``s >= 0`` would give."""
    s = np.float32(-1e-7)
    assert float(torch.sigmoid(torch.tensor(s))) == 0.5
    assert float(jax.nn.sigmoid(jnp.float32(s))) == 0.5
    jenc = (jax_rbm.RBMParams(w=jnp.zeros((D, 3)), bv=jnp.zeros(D),
                              bh=jnp.full((3,), s)),)
    x = np.ones((2, D), np.float32)
    got = encoders.features(_port(jenc), t(x))
    np.testing.assert_array_equal(got.numpy(), np.ones((2, 3)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_enc.features(jenc, jnp.asarray(x))))


def test_pretrain_loss_and_grads_match_jax(interpret_samplers):
    jenc = _jax_encoder(5)
    tenc = _port(jenc)
    x = _roll((2, 3, 4, D), 6)                  # (K, B, T, D): 24 rows
    for layer in range(len(SIZES)):
        jl, jg = jax.value_and_grad(jax_enc.pretrain_loss)(
            jenc, jax.random.PRNGKey(layer), jnp.asarray(x), layer)
        leaves = [p.requires_grad_(True) for p in
                  multinn.tree_leaves(tenc[layer])]
        tl = encoders.pretrain_loss(tenc, sampling.PRNGKey(layer), t(x),
                                    layer)
        grads = torch.autograd.grad(tl, leaves)
        _close(tl, jl, rtol=1e-6, atol=1e-5)
        for g, name in zip(grads, ("w", "bv", "bh")):
            _close(g, getattr(jg[layer], name), rtol=1e-5, atol=1e-6)
        for p in leaves:
            p.requires_grad_(False)


MODEL = dict(n_tracks=K, n_pitches=D, n_hidden=10, n_rnn=6, cd_k=1, gen_k=2,
             w_std=0.5, encoder_hidden=(6,))
DBN_CASES = [("rnn-nade", "feedback"), ("rnn-rbm", "per-track"),
             ("rnn-nade", "hybrid")]


def _jax_params(decoder, mode, seed=0, **kw):
    return jax_multinn.init(jax.random.PRNGKey(seed),
                            jax_multinn.MultINNConfig(**dict(
                                MODEL, decoder_type=decoder, mode=mode,
                                **kw)))


@pytest.mark.parametrize("mode", ["feedback", "per-track"])
def test_from_jax_round_trips_dbn_encoders(mode):
    jp = _jax_params("rnn-rbm", mode, encoder_hidden=(8, 4))
    tp = from_jax(jp, device="cpu")
    back = to_numpy(tp)
    lead = () if mode == "feedback" else (K,)
    assert len(back.encoder) == 2
    for jl, tl, bl in zip(jp.encoder, tp.encoder, back.encoder):
        for name in ("w", "bv", "bh"):
            want = np.asarray(getattr(jl, name))
            assert getattr(tl, name).shape[:len(lead)] == lead
            np.testing.assert_array_equal(getattr(tl, name).numpy(), want)
            np.testing.assert_array_equal(getattr(bl, name), want)
    again = from_jax(back, device="cpu")
    for a, b in zip(multinn.tree_leaves(again), multinn.tree_leaves(tp)):
        assert torch.equal(a, b)
    # the port's own init has the JAX shapes
    mine = multinn.init(tp.cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    assert ([tuple(x.shape) for x in multinn.tree_leaves(mine.encoder)]
            == [x.shape for x in jax.tree.leaves(jp.encoder)])


def _features_margin(tp, x):
    """The least |pre-activation| of the top encoder layer over x."""
    xk = torch.from_numpy(x).movedim(2, 0)
    enc = tp.encoder
    outs = []
    for i in range(tp.cfg.n_tracks):
        e = enc if tp.cfg.shared_encoder else multinn.index_tree(enc, i)
        h = encoders.layer_inputs(e, xk[i], len(e) - 1)
        outs.append((h @ e[-1].w + e[-1].bh).abs().min())
    return float(min(outs))


@pytest.mark.parametrize("decoder,mode", DBN_CASES)
def test_dbn_loss_and_gradients_match_jax(decoder, mode, interpret_samplers):
    jp = _jax_params(decoder, mode, seed=1)
    tp = from_jax(jp, device="cpu")
    x = _roll((3, 5, K, D), 7)
    assert _features_margin(tp, x) > 1e-5
    np.testing.assert_array_equal(
        multinn._encode_tracks(tp, t(x)).numpy(),
        np.asarray(jax_multinn._encode_tracks(jp, jnp.asarray(x))))
    seed = _roll((3, 4, K, D), 8)
    assert _features_margin(tp, seed) > 1e-5

    @jax.jit
    def reference(p, x, seed):
        (loss, metrics), grads = jax.value_and_grad(
            lambda q: jax_multinn.loss(q, jax.random.PRNGKey(3), x),
            has_aux=True)(p)
        ll = jax_multinn.log_likelihood(p, jax.random.PRNGKey(4), x)
        cond = (jax_multinn.conditional_logits(p, x)
                if decoder == "rnn-nade" else None)
        state = jax_multinn.prime(p, jax_multinn.init_state(p, 3), seed)
        return loss, metrics, grads, ll, cond, state

    jl, jm, jg, jll, jcond, js = reference(jp, jnp.asarray(x),
                                           jnp.asarray(seed))
    leaves = [p.requires_grad_(True)
              for p in multinn.tree_leaves(tp.decoder)]
    tl, tm = multinn.loss(tp, sampling.PRNGKey(3), t(x))
    grads = torch.autograd.grad(tl, leaves)
    _close(tl, jl, rtol=1e-5, atol=1e-5)
    _close(tm["loss_per_track"], jm["loss_per_track"], rtol=1e-5, atol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jg.decoder)):
        _close(g, w, rtol=1e-4, atol=1e-5)
    # the features are detached: JAX's encoder gradient is exactly zero
    assert all(not np.asarray(g).any() for g in jax.tree.leaves(jg.encoder))
    _close(multinn.log_likelihood(tp, sampling.PRNGKey(4), t(x)), jll,
           rtol=1e-5, atol=1e-4)
    if decoder == "rnn-nade":
        gl, gt = multinn.conditional_logits(tp, t(x))
        _close(gl, jcond[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(jcond[1]))
    ts = multinn.prime(tp, multinn.init_state(tp, 3), t(seed))
    for a, b in zip(multinn.tree_leaves(ts),
                    [x for x in jax.tree.leaves(js) if x is not None]):
        _close(a, b, rtol=1e-5, atol=1e-6)
