"""multinn_torch NADE sampler (ops/nade_ops.py, ops/nade_cuda.py) and the
RNN-NADE decoder (models/rnn_nade.py) against the JAX package: the plain
sampler draws the Pallas kernel's stream bit for bit (nade_pallas.sample
in interpret mode, plain and under jax.vmap over tracks), priming, the
forced step and the temperature transform match within 1e-5 (float32; the
two frameworks sum in different orders), and the scan branch of
generation agrees with JAX's scan branch in distribution (its sweeps draw
the kernel stream, JAX's draw jax.random)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.models import rnn_nade as jax_rnn_nade  # noqa: E402
from multinn_tpu.ops import nade_pallas  # noqa: E402
from multinn_torch.models import base, multinn, rnn_nade  # noqa: E402
from multinn_torch.nn import rnn  # noqa: E402
from multinn_torch.ops import nade_ops, sampling  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
K, D, H, U, B, T = 3, 8, 6, 4, 3, 5


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _sweep_inputs(tracks, rows, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 0.8, (tracks, D, H)).astype(np.float32)
    v = rng.normal(0.0, 0.8, (tracks, D, H)).astype(np.float32)
    bv = rng.normal(0.0, 0.5, (tracks, rows, D)).astype(np.float32)
    bh = rng.normal(0.0, 0.5, (tracks, rows, H)).astype(np.float32)
    return w, v, bv, bh


@pytest.mark.parametrize("rows,seed", [(1, 0), (5, 1), (5, -7)])
def test_plain_sampler_bit_equal_to_pallas_interpret(rows, seed):
    w, v, bv, bh = (x[0] for x in _sweep_inputs(1, rows, abs(seed)))
    want = nade_pallas.sample(jax.random.PRNGKey(seed), jnp.asarray(w),
                              jnp.asarray(v), jnp.asarray(bv),
                              jnp.asarray(bh), (rows,), True)
    got = nade_ops.nade_sample(sampling.PRNGKey(seed), t(w), t(v), t(bv),
                               t(bh), (rows,))
    assert got.shape == (rows, D) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_sampler_bit_equal_under_vmap_over_tracks():
    """Under jax.vmap the Pallas grid gains the track axis in front, so
    program_id(0) stays 0 and every track keys its stream with its own
    split key's seed[0]: the port's per-track calls on the same keys draw
    the same bits."""
    w, v, bv, bh = _sweep_inputs(K, 4, 2)
    keys = jax.random.split(jax.random.PRNGKey(9), K)
    want = jax.vmap(lambda kk, a, b_, c, d_: nade_pallas.sample(
        kk, a, b_, c, d_, (4,), True))(keys, jnp.asarray(w), jnp.asarray(v),
                                       jnp.asarray(bv), jnp.asarray(bh))
    tkeys = sampling.split(sampling.PRNGKey(9), K)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(
        jax.random.key_data(keys)))
    got = torch.stack([nade_ops.nade_sample(tkeys[i], t(w[i]), t(v[i]),
                                            t(bv[i]), t(bh[i]), (4,))
                       for i in range(K)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.1 < float(got.mean()) < 0.9


def test_sampler_broadcasts_biases_and_refuses_cuda_on_cpu():
    w, v, bv, bh = (x[0] for x in _sweep_inputs(1, 1, 3))
    key = sampling.PRNGKey(2)
    want = nade_pallas.sample(jax.random.PRNGKey(2), jnp.asarray(w),
                              jnp.asarray(v), jnp.asarray(bv[0]),
                              jnp.asarray(bh[0]), (2, 3), True)
    got = nade_ops.nade_sample(key, t(w), t(v), t(bv[0]), t(bh[0]), (2, 3))
    assert got.shape == (2, 3, D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), nade_ops.nade_sample(key, t(w), t(v), t(bv[0]),
                                          t(bh[0]), (2, 3),
                                          impl="plain").numpy())
    with pytest.raises(ValueError, match="CUDA"):
        nade_ops.nade_sample(key, t(w), t(v), t(bv[0]), t(bh[0]), (2, 3),
                             impl="cuda")


def _model(mode="feedback", cell="lstm", layers=1, seed=0):
    cfg = jax_multinn.MultINNConfig(
        n_tracks=K, n_pitches=D, mode=mode, decoder_type="rnn-nade",
        n_hidden=H, n_rnn=U, cell=cell, rnn_layers=layers, w_std=0.5)
    jp = jax_multinn.init(jax.random.PRNGKey(seed), cfg)
    return jp, from_jax(jp, device="cpu")


def test_registry_and_init_match_jax_shapes():
    assert base.get_decoder("rnn-nade") is rnn_nade
    assert base.get_decoder("RNN_NADE") is rnn_nade
    jp, _ = _model()
    cfg = multinn.MultINNConfig(**{
        f: getattr(jp.cfg, f) for f in ("n_tracks", "n_pitches", "mode",
                                        "decoder_type", "n_hidden", "n_rnn",
                                        "w_std")})
    tp = multinn.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tleaves = [tp.decoder.cell[0].wx, tp.decoder.cell[0].wh,
               tp.decoder.cell[0].b, tp.decoder.w, tp.decoder.v,
               tp.decoder.bv, tp.decoder.bh, tp.decoder.wuv, tp.decoder.wuh]
    assert ([tuple(x.shape) for x in tleaves]
            == [x.shape for x in jax.tree.leaves(jp.decoder)])
    assert not torch.equal(tp.decoder.w, tp.decoder.v)
    assert float(tp.decoder.bv.abs().sum()) == 0.0
    state = multinn.init_state(tp, B)
    assert isinstance(state.decoder, rnn_nade.State)
    assert state.decoder.v_prev.shape == (K, B, D)


@pytest.mark.parametrize("mode,cell,layers", [
    ("feedback", "lstm", 1), ("per-track", "lstm", 2),
    ("feedback", "vanilla", 2)])
def test_prime_matches(mode, cell, layers):
    jp, tp = _model(mode, cell, layers)
    seed = (np.random.default_rng(9).random((B, T, K, D)) < 0.3
            ).astype(np.float32)
    js = jax_multinn.prime(jp, jax_multinn.init_state(jp, B),
                           jnp.asarray(seed))
    ts = multinn.prime(tp, multinn.init_state(tp, B), t(seed))
    for a, b in zip(ts.decoder.cell, js.decoder.cell):
        close(a.h, b.h)
        if cell == "lstm":
            close(a.c, b.c)
    close(ts.decoder.v_prev, js.decoder.v_prev)
    if mode == "feedback":
        close(ts.ctx, js.ctx)


def test_forced_step_matches():
    jp, tp = _model(seed=1)
    seed = (np.random.default_rng(10).random((B, T, K, D)) < 0.3
            ).astype(np.float32)
    js = jax_multinn.prime(jp, jax_multinn.init_state(jp, B),
                           jnp.asarray(seed))
    ts = multinn.prime(tp, multinn.init_state(tp, B), t(seed))
    v = (np.random.default_rng(11).random((K, B, D)) < 0.5).astype(np.float32)
    jn = jax.vmap(lambda p, s, x: jax_rnn_nade.forced_step(p, s, x, js.ctx))(
        jp.decoder, js.decoder, jnp.asarray(v))
    tn = rnn_nade.forced_step(tp.decoder, ts.decoder, t(v),
                              ts.ctx.expand(K, *ts.ctx.shape))
    close(tn.cell[0].h, jn.cell[0].h)
    close(tn.cell[0].c, jn.cell[0].c)
    np.testing.assert_array_equal(tn.v_prev.numpy(), v)


def test_tempered_params_match():
    jp, tp = _model()
    jt = jax_rnn_nade.tempered_params(jp.decoder, 0.7)
    tt = rnn_nade.tempered_params(tp.decoder, 0.7)
    for name in ("w", "v", "bv", "bh", "wuv", "wuh"):
        close(getattr(tt, name), getattr(jt, name))
    # only the output logit is scaled: w, bh, wuh and the cells are kept
    assert tt.w is tp.decoder.w and tt.wuh is tp.decoder.wuh
    assert rnn_nade.tempered_params(tp.decoder, 1.0) is tp.decoder
    with pytest.raises(ValueError):
        rnn_nade.tempered_params(tp.decoder, 0.0)


def test_generate_loops_sample_step_on_split_keys():
    _, tp = _model("per-track")
    dec = multinn.index_tree(tp.decoder, 1)
    state = rnn_nade.init_state(dec, (B,))
    key = sampling.PRNGKey(4)
    final, vs = rnn_nade.generate(dec, key, state, 4)
    assert vs.shape == (B, 4, D)
    st, frames = state, []
    for kt in sampling.split(key, 4):
        st, v = rnn_nade.sample_step(dec, kt, st)
        frames.append(v)
    assert torch.equal(vs, torch.stack(frames, dim=1))
    assert torch.equal(final.cell[0].h, st.cell[0].h)
    assert isinstance(rnn.state_h(final.cell[0]), torch.Tensor)


def test_scan_branch_matches_jax_scan_in_distribution():
    """fused=False: per-step NADE sweeps on the kernel stream vs JAX's scan
    branch on jax.random — same model, so per-track note densities agree
    (B*T*D = 4096 bits per track; tolerance 0.05)."""
    jp, _ = _model(seed=3)
    dec = jp.decoder
    jp = jp.replace(decoder=dec.replace(
        bv=dec.bv + jnp.linspace(-2.0, 2.0, D)[None, :]))
    tp = from_jax(jp, device="cpu")
    batch, steps = 8, 64
    _, jroll = jax_multinn.generate(jp, jax.random.PRNGKey(1),
                                    jax_multinn.init_state(jp, batch), steps,
                                    fused=False)
    _, troll = multinn.generate(tp, sampling.PRNGKey(1),
                                multinn.init_state(tp, batch), steps,
                                fused=False)
    assert troll.shape == (batch, steps, K, D)
    assert set(torch.unique(troll).tolist()) <= {0.0, 1.0}
    np.testing.assert_allclose(troll.mean(dim=(0, 1, 3)).numpy(),
                               np.asarray(jroll).mean(axis=(0, 1, 3)),
                               atol=0.05)
