"""multinn_torch's bf16 matmul policy (ops/precision.py) against the JAX
package's on the CPU.

* Off (the default) is exactly ``a @ b``; an unknown name raises; contexts
  nest and the inner one wins.
* Under bf16, ``mm`` equals the JAX ``mm`` forward (2D and track-stacked
  weights) and its backward feeds bf16: d/da = g16 b16^T and d/db =
  sum a16^T g16 with f32 accumulation, against the JAX custom_vjp. The
  CPU route upcasts the bf16 feeds and multiplies in f32: the products are
  exact, so only the order of the f32 sums differs (rtol 1e-6).
* The model's loss and gradients under the policy equal the JAX package's
  under its policy (both families, a DBN encoder, the RBM chain as the
  Pallas kernel in interpret mode): the loss within 1e-5 relative, the
  gradients within 1e-3 of max |ref| (BF16_GRAD); they track the f32 run
  as tests/test_precision.py asks (|l16 - l32| < 0.05 (|l32| + 1),
  gradient cosine > 0.99).
* Three trainer steps under ``matmul_dtype="bf16"`` equal the JAX
  trainer's (its step body enters the policy), and the policy reaches the
  group body and the evaluation.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops import gibbs_pallas  # noqa: E402
from multinn_tpu.ops import precision as jax_precision  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import precision, sampling  # noqa: E402
from multinn_torch.training import trainer  # noqa: E402
from multinn_torch.utils import config  # noqa: E402
from multinn_torch.utils.convert import from_jax, to_numpy  # noqa: E402

torch.set_num_threads(1)
SUM_ORDER = dict(rtol=1e-6, atol=1e-6)   # f32 sums in another order
MODEL_TOL = dict(rtol=1e-5, atol=1e-6)
# a feed whose f32 value differs from JAX's in the last bit (the
# frameworks sum in other orders) may round to the neighbouring bf16 value,
# 2^-8 away: gradients under the policy are held to 1e-3 of max |ref|
BF16_GRAD = 1e-3


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


def _arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def test_policy_off_is_exact_f32():
    a, b = (torch.from_numpy(x) for x in _arrays((4, 7), (7, 3)))
    assert precision.matmul_dtype() is None
    assert torch.equal(precision.mm(a, b), a @ b)
    with precision.matmul_precision("f32"):
        assert torch.equal(precision.mm(a, b), a @ b)


def test_bad_name_and_nesting():
    with pytest.raises(ValueError, match="matmul precision"):
        with precision.matmul_precision("fp8"):
            pass
    with precision.matmul_precision("bf16"):
        assert precision.matmul_dtype() == torch.bfloat16
        with precision.matmul_precision("float32"):
            assert precision.matmul_dtype() is None
        assert precision.matmul_dtype() == torch.bfloat16
    assert precision.matmul_dtype() is None


@pytest.mark.parametrize("a_shape,b_shape", [
    ((2, 5, 7), (7, 3)),          # a weight, batch dims on a
    ((3, 4, 7), (3, 7, 5)),       # track-stacked (K, X, Y) against (K, B, X)
    ((6, 3, 4, 7), (3, 7, 5))])   # time-major (T, K, B, X)
def test_bf16_forward_and_backward_equal_jax(a_shape, b_shape):
    a, b, g = _arrays(a_shape, b_shape,
                      (*a_shape[:-1], b_shape[-1]), seed=1)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    with precision.matmul_precision("bf16"):
        out = precision.mm(ta, tb)
    assert out.dtype == torch.float32
    da, db = torch.autograd.grad(out, (ta, tb), torch.from_numpy(g))

    def jmm(x, y):
        if y.ndim == 2:
            return jax_precision.mm(x, y)
        # the JAX call sites vmap over tracks with a 2D weight per track
        return jnp.moveaxis(jax.vmap(jax_precision.mm, in_axes=(-3, 0))(
            x, y), 0, -3)

    with jax_precision.matmul_precision("bf16"):
        jout, vjp = jax.vjp(jmm, jnp.asarray(a), jnp.asarray(b))
        jda, jdb = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **SUM_ORDER)
    np.testing.assert_allclose(da.numpy(), np.asarray(jda), **SUM_ORDER)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), **SUM_ORDER)
    # the feeds really are rounded: the f32 product differs
    assert not np.allclose(out.detach().numpy(), a @ b if b.ndim == 2
                           else (ta @ tb).detach().numpy(), rtol=1e-6,
                           atol=0)


def test_backward_saves_the_bf16_feeds():
    a, b = (torch.from_numpy(x).requires_grad_(True)
            for x in _arrays((4, 7), (7, 3), seed=2))
    with precision.matmul_precision("bf16"):
        out = precision.mm(a, b)
    saved = out.grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.bfloat16] * 2
    assert torch.equal(saved[0], a.detach().to(torch.bfloat16))


MODEL = dict(n_tracks=3, n_pitches=12, mode="feedback", n_hidden=16, n_rnn=8,
             cd_k=1, w_std=0.3)


@pytest.mark.parametrize("dec,enc", [("rnn-nade", ()), ("rnn-rbm", ()),
                                     ("rnn-nade", (6,))])
def test_model_loss_and_grads_under_bf16_equal_jax(dec, enc,
                                                   interpret_chain):
    cfg = jax_multinn.MultINNConfig(**dict(MODEL, decoder_type=dec,
                                           encoder_hidden=enc))
    jp = jax_multinn.init(jax.random.PRNGKey(0), cfg)
    tp = from_jax(jp, device="cpu")
    x = (np.random.default_rng(1).random((4, 6, 3, 12)) < 0.3
         ).astype(np.float32)
    key = jax.random.PRNGKey(2)

    def jloss(p):
        return jax_multinn.loss(p, key, jnp.asarray(x), detailed=False)[0]

    with jax_precision.matmul_precision("bf16"):
        jl16, jg16 = jax.value_and_grad(jloss)(jp)
    leaves = [t.requires_grad_(True) for t in multinn.tree_leaves(tp.decoder)]
    out = {}
    for name in ("f32", "bf16"):
        with precision.matmul_precision(name):
            loss, _ = multinn.loss(tp, sampling.PRNGKey(2),
                                   torch.from_numpy(x), detailed=False)
        out[name] = (float(loss.detach()),
                     torch.autograd.grad(loss, leaves))
    np.testing.assert_allclose(out["bf16"][0], float(jl16), **MODEL_TOL)
    it = iter(out["bf16"][1])
    got = to_numpy(dataclasses.replace(
        tp, decoder=multinn.tree_map(lambda _: next(it), tp.decoder)))
    for name in ("w", "bv", "bh", "wuv", "wuh"):
        want = np.asarray(getattr(jg16.decoder, name))
        np.testing.assert_allclose(getattr(got.decoder, name), want, rtol=0,
                                   atol=BF16_GRAD * np.abs(want).max())
    # tracks f32 as the JAX test does
    l16, l32 = out["bf16"][0], out["f32"][0]
    assert abs(l16 - l32) < 0.05 * (abs(l32) + 1.0)
    f16 = torch.cat([g.reshape(-1) for g in out["bf16"][1]])
    f32 = torch.cat([g.reshape(-1) for g in out["f32"][1]])
    assert bool(torch.isfinite(f16).all())
    assert float(f16 @ f32 / (f16.norm() * f32.norm())) > 0.99


def test_trainer_steps_under_bf16_equal_jax(interpret_chain, monkeypatch):
    """Three hot steps of the NADE flagship's shape cut small, as
    test_torch_trainer's Adam test, with matmul_dtype='bf16' on both
    sides; then a group of two steps and evaluate under the policy."""
    import optax

    from multinn_tpu.data.datasets import DataConfig, Dataset
    from multinn_tpu.training import trainer as jax_trainer
    ds = Dataset(DataConfig(dataset="synthetic", n_tracks=2, pitch_min=48,
                            pitch_max=71, window=6, batch_size=3,
                            synthetic_songs=6, synthetic_steps=20))
    model = dict(n_tracks=2, n_pitches=24, mode="feedback", n_hidden=6,
                 n_rnn=4, decoder_type="rnn-nade", w_std=0.5,
                 matmul_dtype="bf16")
    jcfg = jax_multinn.MultINNConfig(**model)
    jp = jax_multinn.init(jax.random.PRNGKey(1), jcfg)
    cfg = config.ExperimentConfig(
        model=multinn.MultINNConfig(**model),
        train=config.TrainConfig(seed=3, log_every_steps=1000))
    batches = list(ds.batches("train", epoch=0, augment=True))[:3]
    opt = jax_trainer.make_optimizer(cfg.train, steps_per_epoch=3)
    state = opt.init(jp)
    rng = jax.random.split(jax.random.PRNGKey(3))[0]

    @jax.jit
    def jstep(p, s, batch, k):
        with jax_precision.matmul_precision("bf16"):
            loss, g = jax.value_and_grad(lambda q: jax_multinn.loss(
                q, k, batch, detailed=False)[0])(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    tr = trainer.Trainer(cfg, ds, params=from_jax(jp, device="cpu"))
    for batch in batches:
        rng, k = jax.random.split(rng)
        jp, state, jl = jstep(jp, state, jnp.asarray(batch, jnp.float32), k)
        tr.rng, tk = sampling.split(tr.rng)
        m = tr.train_step(tr._to_device(batch), tk)
        np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-5)
    got = to_numpy(tr.params)
    np.testing.assert_allclose(got.decoder.w, np.asarray(jp.decoder.w),
                               rtol=1e-4, atol=2e-6)
    # the group body and the evaluation run under the policy too
    seen = []
    real_mm = precision._MMBf16.apply

    def spy(a, b):
        seen.append(True)
        return real_mm(a, b)

    monkeypatch.setattr(precision._MMBf16, "apply", spy)
    tr._group_body(tr._to_device(np.stack(batches[:2])), sampling.PRNGKey(0))
    n_group = len(seen)
    tr.evaluate("valid")
    assert n_group > 0 and len(seen) > n_group
