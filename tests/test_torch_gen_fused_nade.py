"""multinn_torch whole-generation RNN-NADE (ops/gen_fused_nade.py) against
the JAX Pallas kernel in interpret mode: the plain version must give the
same roll bit for bit and the final cell state within 1e-5 (float32; the
two sum their logits and gates in different orders), against the kernel's
sequential sweep (spec=1) and its default speculative one, for feedback
and per-track modes, one and two layers, LSTM and vanilla cells, B=1 and
B=8, a temperature, and the given-track merge."""

import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops.gen_common import _stack_joint  # noqa: E402
from multinn_tpu.ops import gen_fused as jax_gen_fused  # noqa: E402
from multinn_torch.models import multinn, rnn_nade  # noqa: E402
from multinn_torch.ops import (gen_common, gen_fused,  # noqa: E402
                               gen_fused_nade, sampling)
from multinn_torch.utils import config  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
K, D, H, U, T = 3, 8, 6, 4, 6
CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"


def _primed(mode, cell, layers, batch, seed=0):
    cfg = jax_multinn.MultINNConfig(
        n_tracks=K, n_pitches=D, mode=mode, decoder_type="rnn-nade",
        n_hidden=H, n_rnn=U, cell=cell, rnn_layers=layers, w_std=0.7)
    jp = jax_multinn.init(jax.random.PRNGKey(seed), cfg)
    tp = from_jax(jp, device="cpu")
    roll = (np.random.default_rng(seed + 1).random((batch, 4, K, D)) < 0.3
            ).astype(np.float32)
    js = jax_multinn.prime(jp, jax_multinn.init_state(jp, batch),
                           jnp.asarray(roll))
    ts = multinn.prime(tp, multinn.init_state(tp, batch),
                       torch.from_numpy(roll))
    return jp, tp, js, ts


def _h0c0(js):
    h0 = np.stack([np.asarray(c.h) for c in js.decoder.cell])
    c0 = np.stack([np.asarray(getattr(c, "c", np.zeros_like(c.h)))
                   for c in js.decoder.cell])
    return h0, c0


def _check_state(tfin, jfin, cell, mode):
    for a, b in zip(tfin.decoder.cell, jfin.decoder.cell):
        np.testing.assert_allclose(a.h.numpy(), np.asarray(b.h), **TOL)
        if cell == "lstm":
            np.testing.assert_allclose(a.c.numpy(), np.asarray(b.c), **TOL)
    np.testing.assert_array_equal(tfin.decoder.v_prev.numpy(),
                                  np.asarray(jfin.decoder.v_prev))
    if mode == "feedback":
        np.testing.assert_array_equal(tfin.ctx.numpy(), np.asarray(jfin.ctx))


CASES = [("feedback", "lstm", 1, 1, 1.0), ("feedback", "lstm", 1, 8, 1.0),
         ("per-track", "lstm", 2, 8, 1.0), ("per-track", "vanilla", 1, 1, 1.0),
         ("feedback", "vanilla", 2, 8, 1.0), ("feedback", "lstm", 2, 1, 0.7)]


@pytest.mark.parametrize("mode,cell,layers,batch,temp", CASES)
def test_plain_fused_bit_equal_to_sequential_sweep(mode, cell, layers, batch,
                                                   temp):
    """Against generate_nade(spec=1): the TPU kernel's sequential sweep."""
    jp, tp, js, ts = _primed(mode, cell, layers, batch)
    jp = jax_multinn.tempered_params(jp, temp)
    h0, c0 = _h0c0(js)
    jroll, jh, jc = jax_gen_fused.generate_nade(
        jax.random.PRNGKey(5), jp.decoder, jnp.asarray(h0), jnp.asarray(c0),
        js.decoder.v_prev, T, interpret=True, spec=1)
    tdec = multinn.tempered_params(tp, temp).decoder
    troll, th, tc = gen_fused.generate_nade(
        sampling.PRNGKey(5), tdec, torch.from_numpy(h0), torch.from_numpy(c0),
        ts.decoder.v_prev, T)
    assert troll.shape == (batch, T, K, D) and troll.dtype == torch.float32
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    if cell == "lstm":
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    assert 0.05 < float(troll.mean()) < 0.95          # non-degenerate


@pytest.mark.parametrize("mode,cell,layers,batch,temp", CASES[1::2])
def test_generate_bit_equal_to_jax_generate_fused(mode, cell, layers, batch,
                                                  temp):
    """multinn.generate (auto gate -> the fused path) against JAX's
    _generate_fused in interpret mode at its default speculative depth."""
    jp, tp, js, ts = _primed(mode, cell, layers, batch, seed=2)
    jfin, jroll = jax_multinn._generate_fused(
        jax_multinn.tempered_params(jp, temp), jax.random.PRNGKey(7), js, T,
        interpret=True)
    tfin, troll = multinn.generate(tp, sampling.PRNGKey(7), ts, T,
                                   temperature=temp)
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    assert isinstance(tfin.decoder, rnn_nade.State)
    _check_state(tfin, jfin, cell, mode)


def test_given_merge_bit_equal_to_pallas_interpret():
    jp, tp, js, ts = _primed("feedback", "lstm", 1, 3, seed=3)
    given = (np.random.default_rng(4).random((3, T, K, D)) < 0.5
             ).astype(np.float32)
    h0, c0 = _h0c0(js)
    jroll, jh, jc = jax_gen_fused.generate_nade(
        jax.random.PRNGKey(8), jp.decoder, jnp.asarray(h0), jnp.asarray(c0),
        js.decoder.v_prev, T, interpret=True, given=jnp.asarray(given),
        given_tracks=(0, 2))
    troll, th, tc = gen_fused.generate_nade(
        sampling.PRNGKey(8), tp.decoder, torch.from_numpy(h0),
        torch.from_numpy(c0), ts.decoder.v_prev, T,
        given=torch.from_numpy(given), given_tracks=[2, 0])
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    np.testing.assert_array_equal(troll[:, :, [0, 2]].numpy(),
                                  given[:, :, [0, 2]])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_exactly_five_matrices_are_rounded_to_bf16(monkeypatch):
    """The TPU kernel stores w, v, wuv, the layer-0 own-frame input
    projection and wctx in bf16 and everything else in f32; the port must
    round the same five. Left in f32 they change the logits by ~1e-3 and
    the roll parts from the reference at the first close draw."""
    jp, tp, js, ts = _primed("feedback", "lstm", 2, 8, seed=5)
    h0, c0 = _h0c0(js)
    args = gen_fused_nade._nade_args(tp.decoder, torch.from_numpy(h0),
                                     torch.from_numpy(c0), ts.decoder.v_prev)
    bf16 = {n for n, x in args._asdict().items()
            if x is not None and x.dtype == torch.bfloat16}
    assert bf16 == {"w", "v", "wuv", "wx_v", "wctx"}
    assert all(x.dtype == torch.float32 for n, x in args._asdict().items()
               if x is not None and n not in bf16)
    want = jnp.asarray(jp.decoder.v).astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(args.v.float().numpy(), np.asarray(want))

    jroll, _, _ = jax_gen_fused.generate_nade(
        jax.random.PRNGKey(6), jp.decoder, jnp.asarray(h0), jnp.asarray(c0),
        js.decoder.v_prev, 16, interpret=True, spec=1)

    def run():
        return gen_fused.generate_nade(
            sampling.PRNGKey(6), tp.decoder, torch.from_numpy(h0),
            torch.from_numpy(c0), ts.decoder.v_prev, 16)[0].numpy()

    np.testing.assert_array_equal(run(), np.asarray(jroll))
    monkeypatch.setattr(gen_fused_nade, "_bf16", lambda x: x.contiguous())
    assert not np.array_equal(run(), np.asarray(jroll))


def test_generate_nade_argument_checks():
    _, tp, _, ts = _primed("feedback", "lstm", 1, 2)
    h0 = torch.stack([c.h for c in ts.decoder.cell])
    c0 = torch.stack([c.c for c in ts.decoder.cell])
    args = (sampling.PRNGKey(0), tp.decoder, h0, c0, ts.decoder.v_prev, 2)
    # the bf16 capacity mode runs; a third storage dtype is refused
    r16, _, _ = gen_fused.generate_nade(*args, aux_dtype=torch.bfloat16)
    assert r16.shape == (2, 2, K, D) and r16.dtype == torch.float32
    with pytest.raises(ValueError, match="aux_dtype"):
        gen_fused.generate_nade(*args, aux_dtype=torch.float64)
    with pytest.raises(ValueError, match="together"):
        gen_fused.generate_nade(*args, given_tracks=(0,))
    with pytest.raises(ValueError, match="CUDA"):
        gen_fused.generate_nade(*args, impl="cuda")
    # (K, B, U) state auto-promotes for one layer; f32 aux is the default
    r1, _, _ = gen_fused.generate_nade(sampling.PRNGKey(0), tp.decoder, h0[0],
                                       c0[0], ts.decoder.v_prev, 2)
    r2, _, _ = gen_fused.generate_nade(*args, aux_dtype=torch.float32)
    assert torch.equal(r1, r2)


FLAGSHIP = multinn.MultINNConfig(n_tracks=5, n_pitches=84, mode="feedback",
                                 decoder_type="rnn-nade", n_hidden=150,
                                 n_rnn=100)


def _args(cfg, batch=1):
    params = gen_fused_nade._decoder_param_shapes(cfg, rnn_nade)
    st = torch.empty((cfg.rnn_layers, cfg.n_tracks, batch, cfg.n_rnn),
                     device="meta")
    return gen_fused_nade._nade_args(
        params, st, st,
        torch.empty((cfg.n_tracks, batch, cfg.n_pitches), device="meta"))


def test_gate_is_a_hopper_resource_check():
    flagship = FLAGSHIP
    # no "B = 1 or a multiple of 8" rule: batch only sets the grid
    for batch in (1, 3, 8, 48, 128, 4096):
        assert gen_fused.supported_nade(flagship, batch, 1024)
    assert not gen_fused.supported_nade(flagship, 0, 1024)
    assert not gen_fused.supported_nade(
        dataclasses.replace(flagship, decoder_type="rnn-rbm"), 8)
    # DBN encoders: the kernel runs at the latent width
    assert gen_fused.supported_nade(
        dataclasses.replace(flagship, encoder_hidden=(64,)), 8)
    # the random stream has 8 rows per dim
    assert gen_fused.supported_nade(
        dataclasses.replace(flagship, n_tracks=8), 8)
    assert not gen_fused.supported_nade(
        dataclasses.replace(flagship, n_tracks=9), 8)
    # a sweep warp holds H <= 256 hidden lanes in registers
    assert gen_fused.supported_nade(
        dataclasses.replace(flagship, n_hidden=256), 8)
    assert not gen_fused.supported_nade(
        dataclasses.replace(flagship, n_hidden=512), 8)
    # wider cells now fit: their matrices stay in global memory, and one
    # sample's state rows are what must fit (n_rnn=16384: 256 KB of gates)
    assert gen_fused.supported_nade(
        dataclasses.replace(flagship, n_rnn=256), 8)
    assert not gen_fused.supported_nade(
        dataclasses.replace(flagship, n_rnn=16384), 8)
    # the count the gate uses: one flagship sample's state
    # previous frames, fresh rows of both parities, h and c, a scratch row
    # of max(G, 2D + H) floats; the lists of 5 previous and 1 fresh row
    sample = 4 * (5 * 84 + 2 * 84 + 2 * 100 + max(400, 2 * 84 + 150)) \
        + (5 + 1) * (4 + 2 * 84)
    assert (gen_fused_nade._sample_bytes(_args(flagship))
            == -(-sample // 16) * 16 == 5792)


@pytest.mark.parametrize("n_tracks,n_hidden,n_rnn", [
    (1, 150, 100), (5, 150, 100), (8, 256, 100), (5, 150, 256),
    (5, 256, 400)])
def test_one_track_per_cta_and_the_sample_count(n_tracks, n_hidden, n_rnn):
    """One track per CTA (K <= 8), so a sample's state holds one fresh row
    pair, h, c and scratch row per CTA; the gate admits each of these,
    also where V, W, Wuh and Wuv do not all fit a CTA (the launch then
    reads the rest from global memory; the placement and the samples per
    cluster are the launch's, tested on the card)."""
    assert gen_common.cluster_shape(n_tracks) == (n_tracks, 1)
    cfg = dataclasses.replace(FLAGSHIP, n_tracks=n_tracks,
                              n_hidden=n_hidden, n_rnn=n_rnn)
    scratch = max(4 * n_rnn, 2 * 84 + n_hidden)
    sample = (4 * (n_tracks * 84 + 2 * 84 + 2 * n_rnn + scratch)
              + (n_tracks + 1) * (4 + 2 * 84))
    assert gen_fused_nade._sample_bytes(_args(cfg)) == -(-sample // 16) * 16
    assert gen_fused.supported_nade(cfg, 256)


ADMITTED = {"jsb_rnnrbm.json": False, "lakh_16th_128bar.json": False,
            "lpd5_feedback_rnnnade.json": True,      # a DBN encoder
            "lpd5_multinn_rnnrbm.json": False,
            "nottingham_rnnnade.json": True, "synthetic_smoke.json": False}


@pytest.mark.parametrize("name", sorted(ADMITTED))
def test_configs_admitted_before_are_still_admitted(name):
    """What the gate admitted with one CTA per sample it still admits, and
    the DBN config of this family, whose kernel runs at the latent
    width."""
    cfg = config.load_json(str(CONFIGS / name))
    for batch in (1, 8, 256, 4096):
        assert (gen_fused.supported_nade(cfg.model, batch, 1024)
                == ADMITTED[name])


SPEC_CASES = [("feedback", "lstm", 1, 1), ("per-track", "lstm", 2, 8),
              ("feedback", "vanilla", 1, 8)]


@pytest.mark.parametrize("spec", [1, 2, 4])
@pytest.mark.parametrize("mode,cell,layers,batch", SPEC_CASES)
def test_plain_fused_bit_equal_at_each_speculative_depth(mode, cell, layers,
                                                         batch, spec):
    """generate_nade(spec=s) against the Pallas kernel's generate_nade(
    spec=s) in interpret mode (D=8: every depth divides it): the roll bit
    for bit, h and c within TOL; and the same bits at every depth."""
    jp, tp, js, ts = _primed(mode, cell, layers, batch, seed=9)
    h0, c0 = _h0c0(js)
    jroll, jh, jc = jax_gen_fused.generate_nade(
        jax.random.PRNGKey(11), jp.decoder, jnp.asarray(h0), jnp.asarray(c0),
        js.decoder.v_prev, T, interpret=True, spec=spec)

    def run(s):
        return gen_fused.generate_nade(
            sampling.PRNGKey(11), tp.decoder, torch.from_numpy(h0),
            torch.from_numpy(c0), ts.decoder.v_prev, T, spec=s)

    troll, th, tc = run(spec)
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    if cell == "lstm":
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    assert 0.05 < float(troll.mean()) < 0.95
    for a, b in zip(run(1), (troll, th, tc)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("spec", [1, 2, 4])
def test_given_merge_at_each_speculative_depth(spec):
    jp, tp, js, ts = _primed("feedback", "lstm", 1, 3, seed=3)
    given = (np.random.default_rng(4).random((3, T, K, D)) < 0.5
             ).astype(np.float32)
    h0, c0 = _h0c0(js)
    jroll, jh, jc = jax_gen_fused.generate_nade(
        jax.random.PRNGKey(8), jp.decoder, jnp.asarray(h0), jnp.asarray(c0),
        js.decoder.v_prev, T, interpret=True, spec=spec,
        given=jnp.asarray(given), given_tracks=(1,))
    troll, th, tc = gen_fused.generate_nade(
        sampling.PRNGKey(8), tp.decoder, torch.from_numpy(h0),
        torch.from_numpy(c0), ts.decoder.v_prev, T, spec=spec,
        given=torch.from_numpy(given), given_tracks=[1])
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    np.testing.assert_array_equal(troll[:, :, 1].numpy(), given[:, :, 1])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


@pytest.mark.parametrize("spec", [1, 2, 4])
def test_joint_one_track_at_each_speculative_depth(spec):
    """Joint mode: one decoder over the K*D = 24-wide frame, as one track
    (Keff=1), against the Pallas kernel at the same depth."""
    cfg = jax_multinn.MultINNConfig(
        n_tracks=K, n_pitches=D, mode="joint", decoder_type="rnn-nade",
        n_hidden=H, n_rnn=U, w_std=0.7)
    jp = jax_multinn.init(jax.random.PRNGKey(12), cfg)
    tp = from_jax(jp, device="cpu")
    roll = (np.random.default_rng(13).random((8, 4, K, D)) < 0.3
            ).astype(np.float32)
    js = jax_multinn.prime(jp, jax_multinn.init_state(jp, 8),
                           jnp.asarray(roll))
    dec = tp.decoder
    assert dec.w.shape[:2] == (1, K * D)
    # the JAX state holds the one decoder unstacked: add the track axis
    h0 = np.asarray(js.decoder.cell[0].h)[None, None]        # (1, 1, B, U)
    c0 = np.asarray(js.decoder.cell[0].c)[None, None]
    v0 = np.asarray(js.decoder.v_prev)[None]                 # (1, B, K*D)
    jroll, jh, jc = jax_gen_fused.generate_nade(
        jax.random.PRNGKey(14), _stack_joint(jp.decoder), jnp.asarray(h0),
        jnp.asarray(c0), jnp.asarray(v0), T, interpret=True, spec=spec)
    troll, th, tc = gen_fused.generate_nade(
        sampling.PRNGKey(14), dec, torch.from_numpy(h0), torch.from_numpy(c0),
        torch.from_numpy(v0), T, spec=spec)
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    assert 0.02 < float(troll.mean()) < 0.98


def test_resolve_spec_equals_the_jax_package(monkeypatch):
    from multinn_tpu.ops import gen_fused_nade as jax_nade
    monkeypatch.delenv("MULTINN_NADE_SPEC", raising=False)
    for d in range(1, 65):
        assert gen_fused._resolve_spec(d) == jax_nade._resolve_spec(d)
    assert gen_fused._resolve_spec is gen_fused_nade._resolve_spec
    assert [gen_fused._resolve_spec(d) for d in (84, 64, 420, 6, 7)] == [
        4, 4, 4, 2, 1]


def test_speculative_depth_checks():
    _, tp, _, ts = _primed("feedback", "lstm", 1, 2)
    h0 = torch.stack([c.h for c in ts.decoder.cell])
    c0 = torch.stack([c.c for c in ts.decoder.cell])
    args = (sampling.PRNGKey(0), tp.decoder, h0, c0, ts.decoder.v_prev, 2)
    for bad in (3, 8, 0):
        with pytest.raises(ValueError, match="must be one of"):
            gen_fused.generate_nade(*args, spec=bad)
    # D=6: depth 4 does not divide it; 2 does, and None resolves to it
    cfg = multinn.MultINNConfig(n_tracks=2, n_pitches=6, mode="feedback",
                                decoder_type="rnn-nade", n_hidden=H,
                                n_rnn=U)
    p6 = multinn.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    st = multinn.init_state(p6, 2)
    args6 = (sampling.PRNGKey(0), p6.decoder,
             torch.stack([c.h for c in st.decoder.cell]),
             torch.stack([c.c for c in st.decoder.cell]), st.decoder.v_prev, 2)
    with pytest.raises(ValueError, match="divide D=6"):
        gen_fused.generate_nade(*args6, spec=4)
    auto = gen_fused.generate_nade(*args6)
    for a, b in zip(auto, gen_fused.generate_nade(*args6, spec=2)):
        assert torch.equal(a, b)
