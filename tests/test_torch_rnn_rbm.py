"""multinn_torch deterministic math against the JAX package, with the same
parameters (``utils.convert.from_jax``): the LSTM and vanilla cells (step,
scan, stacked), the RBM free energy and conditionals, the conditioned
biases and priming. Tolerance rtol = atol = 1e-5 (float32; the two
frameworks sum in different orders)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import base as jax_base  # noqa: E402
from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.models import rnn_rbm as jax_rnn_rbm  # noqa: E402
from multinn_tpu.nn import rbm as jax_rbm  # noqa: E402
from multinn_tpu.nn import rnn as jax_rnn  # noqa: E402
from multinn_torch.models import base, multinn, rnn_rbm  # noqa: E402
from multinn_torch.nn import rbm, rnn  # noqa: E402
from multinn_torch.ops import sampling  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
K, D, H, U, B, T = 3, 8, 6, 4, 3, 5


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _cell_params(cell, n_in, seed=0):
    init = jax_rnn.CELLS[cell][0]
    jp = init(jax.random.PRNGKey(seed), n_in, U, w_std=0.5)
    cls = rnn.LSTMParams if cell == "lstm" else rnn.VanillaRNNParams
    return jp, cls(wx=t(jp.wx), wh=t(jp.wh), b=t(jp.b))


def _cell_state(cell, seed=1):
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 0.5, (B, U)).astype(np.float32)
    c = rng.normal(0, 0.5, (B, U)).astype(np.float32)
    if cell == "lstm":
        return jax_rnn.LSTMState(h=jnp.asarray(h), c=jnp.asarray(c)), \
            rnn.LSTMState(h=t(h), c=t(c))
    return jax_rnn.VanillaRNNState(h=jnp.asarray(h)), \
        rnn.VanillaRNNState(h=t(h))


def test_lstm_init_shapes_and_forget_bias():
    p = rnn.lstm_init(7, U, torch.Generator().manual_seed(0))
    jp = jax_rnn.lstm_init(jax.random.PRNGKey(0), 7, U)
    assert p.wx.shape == jp.wx.shape and p.wh.shape == jp.wh.shape
    close(p.b, jp.b)                 # zeros with the forget block at 1


@pytest.mark.parametrize("cell", ["lstm", "vanilla"])
def test_cell_step_and_scan_match(cell):
    jp, tp = _cell_params(cell, D)
    js, ts = _cell_state(cell)
    x = np.random.default_rng(2).normal(0, 1, (T, B, D)).astype(np.float32)
    step, scan = jax_rnn.CELLS[cell][2], jax_rnn.CELLS[cell][3]
    close(rnn.CELLS[cell][2](tp, ts, t(x[0])).h, step(jp, js, x[0]).h)
    jfin, jhs = scan(jp, js, jnp.asarray(x))
    tfin, ths = rnn.CELLS[cell][3](tp, ts, t(x))
    close(ths, jhs)
    close(tfin.h, jfin.h)
    if cell == "lstm":
        close(tfin.c, jfin.c)


@pytest.mark.parametrize("cell", ["lstm", "vanilla"])
def test_stacked_step_and_scan_match(cell):
    layers = [_cell_params(cell, D, 0), _cell_params(cell, U, 1)]
    jps, tps = tuple(l[0] for l in layers), tuple(l[1] for l in layers)
    states = [_cell_state(cell, 3), _cell_state(cell, 4)]
    jss, tss = tuple(s[0] for s in states), tuple(s[1] for s in states)
    x = np.random.default_rng(5).normal(0, 1, (T, B, D)).astype(np.float32)
    jst = jax_rnn.stacked_step(cell, jps, jss, jnp.asarray(x[0]))
    tst = rnn.stacked_step(cell, tps, tss, t(x[0]))
    for a, b in zip(tst, jst):
        close(a.h, b.h)
    jfin, jhs = jax_rnn.stacked_scan(cell, jps, jss, jnp.asarray(x))
    tfin, ths = rnn.stacked_scan(cell, tps, tss, t(x))
    close(ths, jhs)
    for a, b in zip(tfin, jfin):
        close(a.h, b.h)


def test_rbm_free_energy_and_conditionals_match():
    rng = np.random.default_rng(6)
    v = (rng.random((T, B, D)) < 0.5).astype(np.float32)
    hs = (rng.random((T, B, H)) < 0.5).astype(np.float32)
    w = rng.normal(0, 0.8, (D, H)).astype(np.float32)
    bv = rng.normal(0, 0.5, (T, B, D)).astype(np.float32)
    bh = rng.normal(0, 0.5, (T, B, H)).astype(np.float32)
    close(rbm.free_energy(t(v), t(w), t(bv), t(bh)),
          jax_rbm.free_energy(v, w, bv, bh))
    close(rbm.free_energy(t(v), t(w), t(bv[0, 0]), t(bh[0, 0])),
          jax_rbm.free_energy(v, w, bv[0, 0], bh[0, 0]))
    close(rbm.prob_h_given_v(t(v), t(w), t(bh)),
          jax_rbm.prob_h_given_v(v, w, bh))
    close(rbm.prob_v_given_h(t(hs), t(w), t(bv)),
          jax_rbm.prob_v_given_h(hs, w, bv))


def _model(mode="feedback", cell="lstm", layers=1):
    cfg = jax_multinn.MultINNConfig(
        n_tracks=K, n_pitches=D, mode=mode, n_hidden=H, n_rnn=U, cell=cell,
        rnn_layers=layers, gen_k=2, w_std=0.5)
    jp = jax_multinn.init(jax.random.PRNGKey(0), cfg)
    return jp, from_jax(jp, device="cpu")


def test_conditioned_biases_match_stacked_and_single():
    jp, tp = _model()
    u = np.random.default_rng(7).normal(0, 1, (K, B, U)).astype(np.float32)
    jbv, jbh = jax.vmap(jax_base.conditioned_biases)(jp.decoder,
                                                     jnp.asarray(u))
    tbv, tbh = base.conditioned_biases(tp.decoder, t(u))
    close(tbv, jbv)
    close(tbh, jbh)
    one_j = jax.tree.map(lambda a: a[1], jp.decoder)
    one_t = multinn.index_tree(tp.decoder, 1)
    ut = np.random.default_rng(8).normal(0, 1, (T, B, U)).astype(np.float32)
    close(base.conditioned_biases(one_t, t(ut))[0],
          jax_base.conditioned_biases(one_j, jnp.asarray(ut))[0])


@pytest.mark.parametrize("mode,cell,layers", [
    ("feedback", "lstm", 1), ("per-track", "lstm", 2),
    ("feedback", "vanilla", 2), ("hybrid", "lstm", 1)])
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
        # chained priming carries the context into the first seed frame
        js2 = jax_multinn.prime(jp, js, jnp.asarray(seed[:, ::-1]))
        ts2 = multinn.prime(tp, ts, t(np.ascontiguousarray(seed[:, ::-1])))
        close(ts2.decoder.cell[0].h, js2.decoder.cell[0].h)
    else:
        assert ts.ctx is None


def _state_from_jax(js):
    """The JAX MultINNState's arrays, as the port's state (LSTM cells)."""
    cells = tuple(rnn.LSTMState(h=t(c.h), c=t(c.c)) for c in js.decoder.cell)
    return multinn.MultINNState(
        decoder=rnn_rbm.State(cell=cells, v_prev=t(js.decoder.v_prev)),
        ctx=t(js.ctx))


def test_forced_step_and_state_conversion_match():
    jp, tp = _model()
    seed = (np.random.default_rng(10).random((B, T, K, D)) < 0.3
            ).astype(np.float32)
    js = jax_multinn.prime(jp, jax_multinn.init_state(jp, B),
                           jnp.asarray(seed))
    ts = _state_from_jax(js)
    v = (np.random.default_rng(11).random((K, B, D)) < 0.5).astype(np.float32)
    jn = jax.vmap(lambda p, s, x: jax_rnn_rbm.forced_step(p, s, x, js.ctx))(
        jp.decoder, js.decoder, jnp.asarray(v))
    tn = rnn_rbm.forced_step(tp.decoder, ts.decoder, t(v),
                             ts.ctx.expand(K, *ts.ctx.shape))
    close(tn.cell[0].h, jn.cell[0].h)
    close(tn.cell[0].c, jn.cell[0].c)


def test_tempered_params_match():
    jp, tp = _model()
    jt = jax_multinn.tempered_params(jp, 0.5)
    tt = multinn.tempered_params(tp, 0.5)
    for name in ("w", "bv", "bh", "wuv", "wuh"):
        close(getattr(tt.decoder, name), getattr(jt.decoder, name))
    close(tt.decoder.cell[0].wx, jt.decoder.cell[0].wx)
    assert multinn.tempered_params(tp, 1.0) is tp
    with pytest.raises(ValueError):
        rnn_rbm.tempered_params(tp.decoder, 0.0)


def test_generate_scan_loops_sample_step_on_split_keys():
    """base.generate_scan over one decoder: key t of split(key, n_steps),
    frames (B, n_steps, F) — the same as stepping by hand."""
    _, tp = _model("per-track")
    dec = multinn.index_tree(tp.decoder, 0)
    state = rnn_rbm.init_state(dec, (B,))
    key = sampling.PRNGKey(4)
    final, vs = base.generate_scan(rnn_rbm.sample_step, dec, key, state, 4)
    assert vs.shape == (B, 4, D)
    st, frames = state, []
    for kt in sampling.split(key, 4):
        st, v = rnn_rbm.sample_step(dec, kt, st)
        frames.append(v)
    assert torch.equal(vs, torch.stack(frames, dim=1))
    assert torch.equal(final.cell[0].h, st.cell[0].h)
    assert set(torch.unique(vs).tolist()) <= {0.0, 1.0}


def test_generate_state_replays_and_densities_match_jax():
    """rnn_rbm.generate on one decoder: the returned state is a forced_step
    replay of the returned frames (bit for bit), and per-pitch densities
    agree with the JAX rnn_rbm.generate on jax.random — the scan path's
    distribution tolerance, 0.05 (B*T = 2048 frames per pitch)."""
    jp, _ = _model("per-track")
    dec = jp.decoder
    jp = jp.replace(decoder=dec.replace(
        bv=dec.bv + jnp.linspace(-2.0, 2.0, D)[None, :]))
    tp = from_jax(jp, device="cpu")
    jdec = jax.tree.map(lambda a: a[0], jp.decoder)
    tdec = multinn.index_tree(tp.decoder, 0)
    batch, steps = 32, 64
    state = rnn_rbm.init_state(tdec, (batch,))
    final, vs = rnn_rbm.generate(tdec, sampling.PRNGKey(2), state, steps)
    assert vs.shape == (batch, steps, D)
    assert set(torch.unique(vs).tolist()) <= {0.0, 1.0}
    st = state
    for i in range(steps):
        st = rnn_rbm.forced_step(tdec, st, vs[:, i])
    assert torch.equal(final.cell[0].h, st.cell[0].h)
    assert torch.equal(final.cell[0].c, st.cell[0].c)
    assert torch.equal(final.v_prev, vs[:, -1])
    _, jvs = jax_rnn_rbm.generate(jdec, jax.random.PRNGKey(2),
                                  jax_rnn_rbm.init_state(jdec, (batch,)),
                                  steps)
    assert np.asarray(jvs).shape == (batch, steps, D)
    np.testing.assert_allclose(vs.mean(dim=(0, 1)).numpy(),
                               np.asarray(jvs).mean(axis=(0, 1)), atol=0.05)
