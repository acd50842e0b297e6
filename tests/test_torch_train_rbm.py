"""multinn_torch's RBM training math against the JAX package on the CPU:
the RBM primitives (free energy, CD-k, reconstruction, pseudo-likelihood
on ``jax.random``'s stream), the frame metrics, and ``rnn_rbm.loss`` /
``multinn.loss`` in feedback and per-track modes — loss, metrics and every
gradient against ``jax.value_and_grad``, with and without a frame mask.

The JAX side runs its CD chain as the Pallas kernel in interpret mode (the
``interpret_chain`` fixture), which draws the stream the port's chain
draws, so both sides use the same vk. The chain samples ``u < p`` with p
from the conditioned biases, which the two frameworks compute to within a
few ulps; a difference could flip a draw when a uniform lands between the
two values. These seeds flip none, and the tests assert that the chains
agree bit for bit (``test_cd_chain_sees_the_same_vk``): a flip would fail
there first, and the fallback is then to inject the port's vk into the
JAX free energy. Tolerance rtol = atol = 1e-5 (float32)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import base as jax_base  # noqa: E402
from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.models import rnn_rbm as jax_rnn_rbm  # noqa: E402
from multinn_tpu.nn import rbm as jax_rbm  # noqa: E402
from multinn_tpu.ops import gibbs as jax_gibbs  # noqa: E402
from multinn_tpu.ops import gibbs_pallas  # noqa: E402
from multinn_tpu.training import metrics as jax_metrics  # noqa: E402
from multinn_torch.models import multinn, rnn_rbm  # noqa: E402
from multinn_torch.nn import rbm  # noqa: E402
from multinn_torch.ops import gibbs, sampling  # noqa: E402
from multinn_torch.training import metrics  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
K, D, H, U, B, T = 3, 8, 6, 4, 3, 5


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **dict(TOL, **kw))


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture
def interpret_chain(monkeypatch):
    """The JAX dispatch runs the Pallas chain in interpret mode."""
    orig = gibbs_pallas.gibbs_chain
    monkeypatch.setenv("MULTINN_GIBBS_IMPL", "pallas")
    monkeypatch.setattr(
        gibbs_pallas, "gibbs_chain",
        lambda key, v0, w, bv, bh, k, interpret=True: orig(
            key, v0, w, bv, bh, k, True))


def _rbm_inputs(seed=0, lead=(T, B)):
    rng = np.random.default_rng(seed)
    v = (rng.random((*lead, D)) < 0.4).astype(np.float32)
    w = rng.normal(0, 0.8, (D, H)).astype(np.float32)
    bv = rng.normal(0, 0.5, (*lead, D)).astype(np.float32)
    bh = rng.normal(0, 0.5, (*lead, H)).astype(np.float32)
    return v, w, bv, bh


@pytest.mark.parametrize("k", [1, 3])
def test_reconstruction_and_gibbs_draw_jax_random_bit_for_bit(k):
    args = _rbm_inputs(1)
    key, tkey = jax.random.PRNGKey(11), sampling.PRNGKey(11)
    close(rbm.reconstruction(tkey, *map(t, args), k=k),
          jax_rbm.reconstruction(key, *args, k=k))
    np.testing.assert_array_equal(
        rbm.gibbs_chain(tkey, *map(t, args), k).numpy(),
        np.asarray(jax_rbm.gibbs_chain(key, *args, k)))
    vk, hk = rbm.gibbs_step(tkey, *map(t, args))
    jv, jh = jax_rbm.gibbs_step(key, *args)
    np.testing.assert_array_equal(vk.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(hk.numpy(), np.asarray(jh))


def test_pseudo_log_likelihood_and_free_energy_match():
    args = _rbm_inputs(2)
    for seed in (0, 5):
        close(rbm.pseudo_log_likelihood(sampling.PRNGKey(seed),
                                        *map(t, args)),
              jax_rbm.pseudo_log_likelihood(jax.random.PRNGKey(seed), *args))
    close(rbm.free_energy(*map(t, args)), jax_rbm.free_energy(*args))


def test_cd_loss_and_gradients_match(interpret_chain):
    """nn.rbm.cd_loss (jax.random chain) and ops.gibbs.cd_loss (the kernel
    stream, against the Pallas chain in interpret mode)."""
    args = _rbm_inputs(3)

    def grads(fn, *a):
        ts = [t(x).requires_grad_(i > 0) for i, x in enumerate(a)]
        loss = fn(*ts)
        return loss, torch.autograd.grad(loss, ts[1:])

    key, tkey = jax.random.PRNGKey(4), sampling.PRNGKey(4)
    want, wg = jax.value_and_grad(
        lambda *a: jax_rbm.cd_loss(key, args[0], *a, k=2),
        argnums=(0, 1, 2))(*args[1:])
    got, gg = grads(lambda *a: rbm.cd_loss(tkey, *a, k=2), *args)
    close(got, want)
    for a, b in zip(gg, wg):
        close(a, b)
    want, wg = jax.value_and_grad(
        lambda *a: jax_gibbs.cd_loss(key, args[0], *a, k=2, impl="pallas"),
        argnums=(0, 1, 2))(*args[1:])
    got, gg = grads(lambda *a: gibbs.cd_loss(tkey, *a, k=2), *args)
    close(got, want)
    for a, b in zip(gg, wg):
        close(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_frame_metrics_and_bce_match(masked):
    rng = np.random.default_rng(6)
    pred = rng.random((T, B, D)).astype(np.float32)
    target = (rng.random((T, B, D)) < 0.3).astype(np.float32)
    mask = (rng.random((T, B)) < 0.7).astype(np.float32) if masked else None
    tm = None if mask is None else t(mask)
    got = metrics.frame_metrics(t(pred), t(target), mask=tm)
    want = jax_metrics.frame_metrics(pred, target, mask=mask)
    assert set(got) == set(want)
    for name in want:
        close(got[name], want[name], err_msg=name)
    close(metrics.binary_cross_entropy(t(pred), t(target), mask=tm),
          jax_metrics.binary_cross_entropy(pred, target, mask=mask))


def _model(mode, seed=0):
    cfg = jax_multinn.MultINNConfig(
        n_tracks=K, n_pitches=D, mode=mode, n_hidden=H, n_rnn=U, gen_k=2,
        cd_k=1, w_std=0.5)
    jp = jax_multinn.init(jax.random.PRNGKey(seed), cfg)
    return jp, from_jax(jp, device="cpu")


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((B, T, K, D)) < 0.4).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 3:] = 0.0
    mask[2, 1:] = 0.0
    return x, mask


def _check_loss(jfn, tfn, jparams, tparams):
    """Loss, metrics and gradients of ``jfn(params)`` (JAX) and
    ``tfn(params)`` (the port) for the decoder leaves."""
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jparams)
    leaves = multinn.tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tl, tmet = tfn(tparams)
    close(tl, jl)
    assert set(tmet) == set(jmet)
    for name in jmet:
        close(tmet[name], jmet[name], err_msg=name)
    grads = torch.autograd.grad(tl, leaves)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for a, b in zip(grads, jleaves):
        close(a, b)


@pytest.mark.parametrize("mode,detailed,masked", [
    ("feedback", True, True), ("feedback", False, False),
    ("per-track", True, False), ("per-track", False, True)])
def test_multinn_loss_matches_value_and_grad(mode, detailed, masked,
                                             interpret_chain):
    jp, tp = _model(mode, seed=1)
    x, mask = _batch(2)
    m = mask if masked else None
    key = jax.random.PRNGKey(7)
    _check_loss(
        lambda p: jax_multinn.loss(p, key, jnp.asarray(x), detailed=detailed,
                                   frame_mask=m),
        lambda p: multinn.loss(p, sampling.PRNGKey(7), t(x),
                               detailed=detailed,
                               frame_mask=None if m is None else t(m)),
        jp, tp)


@pytest.mark.parametrize("detailed,masked", [(True, False), (False, True)])
def test_rnn_rbm_loss_one_decoder_matches(detailed, masked, interpret_chain):
    """One decoder (not track-stacked) with a (B, T, C) context."""
    jp, tp = _model("feedback", seed=2)
    one_j = jax.tree.map(lambda a: a[1], jp.decoder)
    one_t = multinn.index_tree(tp.decoder, 1)
    x, mask = _batch(3)
    ctx = np.random.default_rng(4).random((B, T, K * D)).astype(np.float32)
    m = mask if masked else None
    key = jax.random.PRNGKey(8)
    _check_loss(
        lambda p: jax_rnn_rbm.loss(p, key, jnp.asarray(x[:, :, 1]),
                                   ctx=jnp.asarray(ctx), detailed=detailed,
                                   frame_mask=m),
        lambda p: rnn_rbm.loss(p, sampling.PRNGKey(8), t(x[:, :, 1]),
                               ctx=t(ctx), detailed=detailed,
                               frame_mask=None if m is None else t(m)),
        one_j, one_t)


def test_cd_chain_sees_the_same_vk(interpret_chain, monkeypatch):
    """The port's per-track chains return exactly the vk the Pallas chain
    draws for each track on the JAX side (under jax.vmap over tracks the
    kernel gives each track the unbatched call under that track's key)."""
    jp, tp = _model("feedback", seed=1)
    x, _ = _batch(2)
    keys = jax.random.split(jax.random.PRNGKey(7), K)
    ctx_tm = jnp.swapaxes(jax_multinn._feedback_ctx(
        jnp.moveaxis(jnp.asarray(x), 2, 0)), 0, 1)
    jvk = []
    for i in range(K):
        p = jax.tree.map(lambda a: a[i], jp.decoder)
        x_tm = jnp.swapaxes(jnp.asarray(x[:, :, i]), 0, 1)
        _, u_prev = jax_base.scan_states(
            p, jax_rnn_rbm.init_state(p, (B,)),
            jax_base.rnn_input(x_tm, ctx_tm))
        bv_t, bh_t = jax_base.conditioned_biases(p, u_prev)
        k1 = jax.random.split(keys[i], 3)[0]
        jvk.append(gibbs_pallas.gibbs_chain(k1, x_tm, p.w, bv_t, bh_t, 1))
    ours = []
    real = gibbs.gibbs_chain

    def spy(*a, **kw):
        ours.append(real(*a, **kw))
        return ours[-1]

    monkeypatch.setattr(gibbs, "gibbs_chain", spy)
    multinn.loss(tp, sampling.PRNGKey(7), t(x), detailed=False)
    assert len(ours) == K
    np.testing.assert_array_equal(torch.stack(ours).numpy(),
                                  np.stack(jvk))


@pytest.mark.parametrize("mode,masked", [("feedback", True),
                                         ("per-track", False)])
def test_log_likelihood_proxy_matches(mode, masked):
    jp, tp = _model(mode, seed=3)
    x, mask = _batch(5)
    m = mask if masked else None
    want = jax_multinn.log_likelihood(jp, jax.random.PRNGKey(9),
                                      jnp.asarray(x), frame_mask=m)
    got = multinn.log_likelihood(tp, sampling.PRNGKey(9), t(x),
                                 frame_mask=None if m is None else t(m))
    assert got.shape == (B,)
    close(got, want)
    if mode != "per-track":
        return
    one = rnn_rbm.log_likelihood_proxy(
        multinn.index_tree(tp.decoder, 0), sampling.PRNGKey(2),
        t(x[:, :, 0]))
    close(one, jax_rnn_rbm.log_likelihood_proxy(
        jax.tree.map(lambda a: a[0], jp.decoder), jax.random.PRNGKey(2),
        jnp.asarray(x[:, :, 0])))
