"""multinn_torch whole-generation RNN-RBM (ops/gen_fused_rbm.py) against
the JAX Pallas kernel in interpret mode: the plain version must give the
same roll bit for bit and the final cell state within 1e-5, for feedback
and per-track modes, one and two layers, LSTM and vanilla cells, and the
given-track merge."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops import gen_fused as jax_gen_fused  # noqa: E402
from multinn_torch.models import multinn, rnn_rbm  # noqa: E402
from multinn_torch.ops import gen_fused, gen_fused_rbm, sampling  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
K, D, H, U, B, T = 3, 8, 6, 4, 3, 5


def _primed(mode, cell, layers, seed=0):
    cfg = jax_multinn.MultINNConfig(
        n_tracks=K, n_pitches=D, mode=mode, n_hidden=H, n_rnn=U, cell=cell,
        rnn_layers=layers, gen_k=2, w_std=0.5)
    jp = jax_multinn.init(jax.random.PRNGKey(seed), cfg)
    tp = from_jax(jp)
    roll = (np.random.default_rng(seed + 1).random((B, 4, K, D)) < 0.3
            ).astype(np.float32)
    js = jax_multinn.prime(jp, jax_multinn.init_state(jp, B),
                           jnp.asarray(roll))
    ts = multinn.prime(tp, multinn.init_state(tp, B), torch.from_numpy(roll))
    return jp, tp, js, ts


@pytest.mark.parametrize("mode,cell,layers", [
    ("feedback", "lstm", 1), ("per-track", "lstm", 1),
    ("feedback", "lstm", 2), ("per-track", "vanilla", 1),
    ("feedback", "vanilla", 2)])
def test_plain_fused_bit_equal_to_pallas_interpret(mode, cell, layers):
    jp, tp, js, ts = _primed(mode, cell, layers)
    jfin, jroll = jax_multinn._generate_fused(jp, jax.random.PRNGKey(5), js,
                                              T, interpret=True)
    tfin, troll = multinn._generate_fused(tp, sampling.PRNGKey(5), ts, T)
    assert troll.shape == (B, T, K, D) and troll.dtype == torch.float32
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    for a, b in zip(tfin.decoder.cell, jfin.decoder.cell):
        np.testing.assert_allclose(a.h.numpy(), np.asarray(b.h), **TOL)
        if cell == "lstm":
            np.testing.assert_allclose(a.c.numpy(), np.asarray(b.c), **TOL)
    np.testing.assert_array_equal(tfin.decoder.v_prev.numpy(),
                                  np.asarray(jfin.decoder.v_prev))
    if mode == "feedback":
        np.testing.assert_array_equal(tfin.ctx.numpy(), np.asarray(jfin.ctx))


def test_given_merge_bit_equal_to_pallas_interpret():
    jp, tp, js, ts = _primed("feedback", "lstm", 1, seed=3)
    given = (np.random.default_rng(4).random((B, T, K, D)) < 0.5
             ).astype(np.float32)
    h0 = np.stack([np.asarray(c.h) for c in js.decoder.cell])
    c0 = np.stack([np.asarray(c.c) for c in js.decoder.cell])
    jroll, jh, jc = jax_gen_fused.generate_rbm(
        jax.random.PRNGKey(8), jp.decoder, jnp.asarray(h0), jnp.asarray(c0),
        js.decoder.v_prev, T, 2, interpret=True, given=jnp.asarray(given),
        given_tracks=(0, 2))
    troll, th, tc = gen_fused.generate_rbm(
        sampling.PRNGKey(8), tp.decoder, torch.from_numpy(h0),
        torch.from_numpy(c0), ts.decoder.v_prev, T, 2,
        given=torch.from_numpy(given), given_tracks=[2, 0])
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    np.testing.assert_array_equal(troll[:, :, [0, 2]].numpy(),
                                  given[:, :, [0, 2]])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_generate_rbm_argument_checks():
    _, tp, _, ts = _primed("feedback", "lstm", 1)
    h0 = torch.stack([c.h for c in ts.decoder.cell])
    c0 = torch.stack([c.c for c in ts.decoder.cell])
    args = (sampling.PRNGKey(0), tp.decoder, h0, c0, ts.decoder.v_prev, 2, 2)
    with pytest.raises(NotImplementedError, match="bf16"):
        gen_fused.generate_rbm(*args, wdtype=torch.bfloat16)
    with pytest.raises(ValueError, match="together"):
        gen_fused.generate_rbm(*args, given_tracks=(0,))
    with pytest.raises(ValueError, match="CUDA"):
        gen_fused.generate_rbm(*args, impl="cuda")
    # (K, B, U) state auto-promotes for one layer
    r1, _, _ = gen_fused.generate_rbm(sampling.PRNGKey(0), tp.decoder, h0[0],
                                      c0[0], ts.decoder.v_prev, 2, 2)
    r2, _, _ = gen_fused.generate_rbm(*args)
    assert torch.equal(r1, r2)


def test_gate_is_a_shared_memory_check():
    flagship = multinn.MultINNConfig(n_tracks=5, n_pitches=84,
                                     mode="feedback", n_hidden=150,
                                     n_rnn=100, gen_k=10)
    for batch in (1, 8, 128, 4096):
        assert gen_fused.supported(flagship, batch, 1024)
    assert not gen_fused.supported(flagship, 0, 1024)
    assert not gen_fused.supported(
        dataclasses.replace(flagship, decoder_type="rnn-nade"), 8)
    assert not gen_fused.supported(
        dataclasses.replace(flagship, encoder_hidden=(64,)), 8)
    assert not gen_fused.supported(
        dataclasses.replace(flagship, mode="joint"), 8)
    # state rows beyond one CTA's shared memory are refused
    assert not gen_fused.supported(
        dataclasses.replace(flagship, n_rnn=4096), 8)
    # the count the gate uses: flagship state rows of one sample
    params = gen_fused_rbm._decoder_param_shapes(flagship, rnn_rbm)
    st = torch.empty((1, 5, 1, 100), device="meta")
    args = gen_fused_rbm._rbm_args(params, st, st,
                                   torch.empty((5, 1, 84), device="meta"))
    assert gen_fused_rbm._cta_smem_bytes(args) == 4 * (
        2 * 500 + 3 * 420 + 2 * 750 + 2000)
