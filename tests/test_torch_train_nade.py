"""multinn_torch's RNN-NADE training math against the JAX package on the
CPU: ``rnn_nade.loss``, ``log_likelihood`` and ``conditional_logits``, and
``multinn.loss`` / ``log_likelihood`` / ``conditional_logits``, with
gradients, in feedback, per-track and hybrid modes; and the golden pin
``rnn_nade_loss`` (tests/golden/golden.npz) reproduced from the same
parameters. The port's likelihood runs the kernels' plain versions (the
sequential dim loops); the JAX side runs its cumsum form. Tolerance
rtol = atol = 1e-5 (float32, sums in other orders)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.models import rnn_nade as jax_rnn_nade  # noqa: E402
from multinn_torch.models import multinn, rnn_nade  # noqa: E402
from multinn_torch.ops import _build, sampling  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
K, D, H, U, B, T = 3, 8, 6, 4, 3, 5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **dict(TOL, **kw))


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _model(mode, seed=0, **kw):
    cfg = jax_multinn.MultINNConfig(
        n_tracks=K, n_pitches=D, mode=mode, decoder_type="rnn-nade",
        n_hidden=H, n_rnn=U, w_std=0.5, **kw)
    jp = jax_multinn.init(jax.random.PRNGKey(seed), cfg)
    return jp, from_jax(jp, device="cpu")


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((B, T, K, D)) < 0.4).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, 2:] = 0.0
    mask[2, 4:] = 0.0
    return x, mask


def _check(jfn, tfn, jparams, tparams):
    """Value (and aux metrics) and every gradient of jfn (JAX) and tfn (the
    port) with respect to the decoder leaves."""
    (jv, jaux), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jparams)
    leaves = multinn.tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tv, taux = tfn(tparams)
    close(tv, jv)
    assert set(taux) == set(jaux)
    for name in jaux:
        close(taux[name], jaux[name], err_msg=name)
    grads = torch.autograd.grad(tv, leaves)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for a, b in zip(grads, jleaves):
        close(a, b)


@pytest.mark.parametrize("mode,detailed,masked,layers", [
    ("feedback", True, True, 1), ("feedback", False, False, 1),
    ("per-track", True, False, 2), ("hybrid", False, True, 1)])
def test_multinn_loss_matches_value_and_grad(mode, detailed, masked, layers):
    jp, tp = _model(mode, seed=1, rnn_layers=layers)
    x, mask = _batch(2)
    m = mask if masked else None
    _build.launches.clear()
    _check(lambda p: jax_multinn.loss(p, jax.random.PRNGKey(3),
                                      jnp.asarray(x), detailed=detailed,
                                      frame_mask=m),
           lambda p: multinn.loss(p, sampling.PRNGKey(3), t(x),
                                  detailed=detailed,
                                  frame_mask=None if m is None else t(m)),
           jp, tp)
    assert not _build.launches            # CPU tensors: the plain versions


@pytest.mark.parametrize("mode,masked", [("feedback", True),
                                         ("per-track", False)])
def test_multinn_log_likelihood_matches_with_gradients(mode, masked):
    jp, tp = _model(mode, seed=2)
    x, mask = _batch(4)
    m = mask if masked else None
    _check(lambda p: (jnp.sum(jax_multinn.log_likelihood(
               p, jax.random.PRNGKey(0), jnp.asarray(x), frame_mask=m)), {}),
           lambda p: (multinn.log_likelihood(
               p, sampling.PRNGKey(0), t(x),
               frame_mask=None if m is None else t(m)).sum(), {}),
           jp, tp)
    got = multinn.log_likelihood(tp, sampling.PRNGKey(0), t(x))
    want = jax_multinn.log_likelihood(jp, jax.random.PRNGKey(0),
                                      jnp.asarray(x))
    assert got.shape == (B,)
    close(got, want)


def test_multinn_conditional_logits_match():
    jp, tp = _model("feedback", seed=3)
    x, _ = _batch(5)
    logits, targets = multinn.conditional_logits(tp, t(x))
    jl, jt = jax_multinn.conditional_logits(jp, jnp.asarray(x))
    assert logits.shape == (K, T, B, D)
    close(logits, jl)
    close(targets, jt)
    rbm = multinn.MultINNParams(encoder=(), decoder=tp.decoder,
                                cfg=multinn.MultINNConfig(n_tracks=K,
                                                          n_pitches=D))
    with pytest.raises(ValueError, match="rnn-nade"):
        multinn.conditional_logits(rbm, t(x))


@pytest.mark.parametrize("masked", [False, True])
def test_rnn_nade_one_decoder_matches(masked):
    """One decoder (not track-stacked) with a (B, T, C) context: loss with
    metrics, log_likelihood and conditional_logits."""
    jp, tp = _model("feedback", seed=4)
    one_j = jax.tree.map(lambda a: a[2], jp.decoder)
    one_t = multinn.index_tree(tp.decoder, 2)
    x, mask = _batch(6)
    ctx = np.random.default_rng(7).random((B, T, K * D)).astype(np.float32)
    m = mask if masked else None
    tm = None if m is None else t(m)
    _check(lambda p: jax_rnn_nade.loss(p, None, jnp.asarray(x[:, :, 2]),
                                       ctx=jnp.asarray(ctx), frame_mask=m),
           lambda p: rnn_nade.loss(p, None, t(x[:, :, 2]), ctx=t(ctx),
                                   frame_mask=tm),
           one_j, one_t)
    close(rnn_nade.log_likelihood(one_t, None, t(x[:, :, 2]), ctx=t(ctx),
                                  frame_mask=tm),
          jax_rnn_nade.log_likelihood(one_j, None, jnp.asarray(x[:, :, 2]),
                                      ctx=jnp.asarray(ctx), frame_mask=m))
    close(rnn_nade.conditional_logits(one_t, t(x[:, :, 2]), ctx=t(ctx)),
          jax_rnn_nade.conditional_logits(one_j, jnp.asarray(x[:, :, 2]),
                                          ctx=jnp.asarray(ctx)))
    assert rnn_nade.log_likelihood_proxy is rnn_nade.log_likelihood


def test_golden_rnn_nade_loss_is_reproduced():
    """tests/golden_gen.py:33-39: the loss of multinn.init(PRNGKey(1234))
    on its bernoulli x under PRNGKey(99), carried across by from_jax."""
    cfg = jax_multinn.MultINNConfig(n_tracks=2, n_pitches=16, mode="feedback",
                                    decoder_type="rnn-nade", n_hidden=8,
                                    n_rnn=6, cd_k=1, gen_k=2, w_std=0.1)
    params = from_jax(jax_multinn.init(jax.random.PRNGKey(1234), cfg),
                      device="cpu")
    x = jax.random.bernoulli(jax.random.PRNGKey(5678), 0.3,
                             (2, 6, 2, 16)).astype(jnp.float32)
    loss, metrics = multinn.loss(params, sampling.PRNGKey(99), t(x))
    want = np.load(GOLDEN)["rnn_nade_loss"]
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
    np.testing.assert_allclose(metrics["nll"].item(), want, rtol=1e-5)
