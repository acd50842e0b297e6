"""multinn_torch whole-generation RNN-RBM (ops/gen_fused_rbm.py) against
the JAX Pallas kernel in interpret mode: the plain version must give the
same roll bit for bit and the final cell state within 1e-5, for feedback
and per-track modes, one and two layers, LSTM and vanilla cells, and the
given-track merge."""

import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops import gen_fused as jax_gen_fused  # noqa: E402
from multinn_torch.models import multinn, rnn_rbm  # noqa: E402
from multinn_torch.ops import (gen_common, gen_fused,  # noqa: E402
                               gen_fused_rbm, sampling)
from multinn_torch.utils import config  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
K, D, H, U, B, T = 3, 8, 6, 4, 3, 5
CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"


def _primed(mode, cell, layers, seed=0):
    cfg = jax_multinn.MultINNConfig(
        n_tracks=K, n_pitches=D, mode=mode, n_hidden=H, n_rnn=U, cell=cell,
        rnn_layers=layers, gen_k=2, w_std=0.5)
    jp = jax_multinn.init(jax.random.PRNGKey(seed), cfg)
    tp = from_jax(jp, device="cpu")
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
    # the bf16 capacity mode runs; a third storage dtype is refused
    r16, _, _ = gen_fused.generate_rbm(*args, wdtype=torch.bfloat16)
    assert r16.shape == (B, 2, K, D) and r16.dtype == torch.float32
    with pytest.raises(ValueError, match="wdtype"):
        gen_fused.generate_rbm(*args, wdtype=torch.float16)
    with pytest.raises(ValueError, match="together"):
        gen_fused.generate_rbm(*args, given_tracks=(0,))
    with pytest.raises(ValueError, match="CUDA"):
        gen_fused.generate_rbm(*args, impl="cuda")
    # (K, B, U) state auto-promotes for one layer
    r1, _, _ = gen_fused.generate_rbm(sampling.PRNGKey(0), tp.decoder, h0[0],
                                      c0[0], ts.decoder.v_prev, 2, 2)
    r2, _, _ = gen_fused.generate_rbm(*args)
    assert torch.equal(r1, r2)


@pytest.mark.parametrize("case", ["base", "h_on", "h_off", "v_on",
                                  "given", "row_map"])
def test_plain_regimes_bit_equal_to_pallas_interpret(case):
    """The plain version in the chain's regimes against the JAX package's
    fused kernel in interpret mode, with the same bias shifts on both
    packages' parameters: a saturated hidden layer (every unit on, or
    none, when v follows bv(t) alone), a saturated visible one (every
    frame all ones), a given track of real values, and a launch under the
    row map (samples 2..4 of a batch of 7, against those rows of the
    whole batch). The rolls are bit-equal, h and c within 1e-5."""
    jp, tp, js, _ = _primed("feedback", "lstm", 1, seed=2)
    jdec, tdec = jp.decoder, tp.decoder
    shift = {"h_on": ("bh", 50.0), "h_off": ("bh", -50.0),
             "v_on": ("bv", 50.0)}.get(case)
    if shift is not None:
        name, by = shift
        jdec = jdec.replace(**{name: getattr(jdec, name) + by})
        tdec = dataclasses.replace(tdec, **{name: getattr(tdec, name) + by})
    h0 = np.stack([np.asarray(c.h) for c in js.decoder.cell])  # (L, K, B, U)
    c0 = np.stack([np.asarray(c.c) for c in js.decoder.cell])
    v0 = np.array(js.decoder.v_prev)                            # (K, B, D)
    jin, jkw, tkw, mine = (h0, c0, v0), {}, {}, slice(None)
    if case == "given":                     # real values in track 1
        rng = np.random.default_rng(6)
        given = (rng.random((B, T, K, D)) * (rng.random((B, T, K, D)) < 0.5)
                 ).astype(np.float32)
        jkw = dict(given=jnp.asarray(given), given_tracks=(1,))
        tkw = dict(given=torch.from_numpy(given), given_tracks=(1,))
    if case == "row_map":
        tkw, mine = dict(rows=(2, 7)), slice(2, 2 + B)

        def whole(x, axis):                 # B rows at 2 in a batch of 7
            pad = [(0, 0)] * x.ndim
            pad[axis] = (2, 7 - 2 - B)
            return np.pad(x, pad)
        jin = (whole(h0, 2), whole(c0, 2), whole(v0, 1))
    gen_k = 3
    jroll, jh, jc = jax_gen_fused.generate_rbm(
        jax.random.PRNGKey(9), jdec, *map(jnp.asarray, jin), T, gen_k,
        interpret=True, **jkw)
    troll, th, tc = gen_fused.generate_rbm(
        sampling.PRNGKey(9), tdec, *map(torch.from_numpy, (h0, c0, v0)), T,
        gen_k, **tkw)
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll)[mine])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh)[:, :, mine], **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc)[:, :, mine], **TOL)
    if case == "v_on":                      # every sampled v is all ones
        assert torch.equal(troll, torch.ones_like(troll))


def _flagship_args(cfg, batch=1):
    params = gen_fused_rbm._decoder_param_shapes(cfg, rnn_rbm)
    st = torch.empty((cfg.rnn_layers, cfg.n_tracks, batch, cfg.n_rnn),
                     device="meta")
    return gen_fused_rbm._rbm_args(
        params, st, st,
        torch.empty((cfg.n_tracks, batch, cfg.n_pitches), device="meta"))


FLAGSHIP = multinn.MultINNConfig(n_tracks=5, n_pitches=84, mode="feedback",
                                 n_hidden=150, n_rnn=100, gen_k=10)


def test_gate_is_a_shared_memory_check():
    flagship = FLAGSHIP
    for batch in (1, 8, 128, 4096):
        assert gen_fused.supported(flagship, batch, 1024)
    assert not gen_fused.supported(flagship, 0, 1024)
    assert not gen_fused.supported(
        dataclasses.replace(flagship, decoder_type="rnn-nade"), 8)
    # DBN encoders: the kernel runs at the latent width
    assert gen_fused.supported(
        dataclasses.replace(flagship, encoder_hidden=(64,)), 8)
    # joint mode: one track of K*D = 420 pitches (gen_common._eff_dims)
    assert gen_fused.supported(
        dataclasses.replace(flagship, mode="joint"), 8)
    # one sample's state rows beyond one CTA's shared memory are refused:
    # at n_rnn=16384 the gate row alone takes 256 KB
    assert not gen_fused.supported(
        dataclasses.replace(flagship, n_rnn=16384), 8)
    # K <= 31: the given-track merge is a 32-bit mask
    assert gen_fused.supported(
        dataclasses.replace(flagship, n_tracks=31, mode="per-track"), 8)
    assert not gen_fused.supported(
        dataclasses.replace(flagship, n_tracks=32, mode="per-track"), 8)
    # the count the gate uses: one flagship sample's state
    # previous frames, fresh rows of both parities, h and c, a scratch row
    # of max(G, D + H + the chain's mask words) floats, a word per 32 units
    # of v (3) and of h (5); the lists of 5 previous and 1 fresh row
    assert max(400, 84 + 150 + 3 + 5) == 400
    sample = 4 * (5 * 84 + 2 * 84 + 2 * 100 + 400) + (5 + 1) * (4 + 2 * 84)
    assert (gen_fused_rbm._sample_bytes(_flagship_args(flagship))
            == -(-sample // 16) * 16 == 5792)
    # beside the 16 warps' lists: up to max(D, H) = 150 indices and 7 of
    # padding, 16-byte aligned
    assert gen_fused_rbm._lists_bytes(84, 150) == 16 * 320


@pytest.mark.parametrize("n_tracks,cluster,tpc", [
    (1, 1, 1), (5, 5, 1), (8, 8, 1), (9, 8, 2), (12, 8, 2), (31, 8, 4)])
def test_tracks_per_cta(n_tracks, cluster, tpc):
    """C = min(K, 8) CTAs per cluster; CTA r owns tracks r, r + C, ...:
    ceil(K / C) track slots, each with its fresh rows, h, c and scratch in
    a sample's state (the weight placement and the samples per cluster
    are the launch's, tested on the card)."""
    assert gen_common.cluster_shape(n_tracks) == (cluster, tpc)
    cfg = dataclasses.replace(FLAGSHIP, n_tracks=n_tracks, mode="per-track")
    sample = (4 * (n_tracks * 84 + tpc * (2 * 84 + 2 * 100 + 400))
              + (n_tracks + tpc) * (4 + 2 * 84))
    assert gen_fused_rbm._sample_bytes(_flagship_args(cfg)) == \
        -(-sample // 16) * 16
    assert gen_fused.supported(cfg, 256)


def test_weights_beyond_shared_memory_are_admitted():
    """The lakh config (H=200, U=150) and K=12 (two tracks per CTA): not
    every per-step weight matrix fits a CTA beside one sample's state, so
    the launch reads those from global memory; the gate admits both."""
    lakh = dataclasses.replace(FLAGSHIP, n_hidden=200, n_rnn=150)
    two = dataclasses.replace(FLAGSHIP, n_tracks=12, mode="per-track")
    assert gen_fused.supported(lakh, 256) and gen_fused.supported(two, 256)


ADMITTED = {"jsb_rnnrbm.json": True, "lakh_16th_128bar.json": True,
            "lpd5_feedback_rnnnade.json": False,
            "lpd5_multinn_rnnrbm.json": True,       # DBN encoders
            "nottingham_rnnnade.json": False, "synthetic_smoke.json": True}


@pytest.mark.parametrize("name", sorted(ADMITTED))
def test_configs_admitted_before_are_still_admitted(name):
    """What the gate admitted with one CTA per sample it still admits, and
    the DBN config of this family, whose kernel runs at the latent
    width."""
    cfg = config.load_json(str(CONFIGS / name))
    for batch in (1, 8, 256, 4096):
        assert gen_fused.supported(cfg.model, batch, 1024) == ADMITTED[name]
