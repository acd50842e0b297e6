"""The fused generation kernels' bf16 capacity modes in multinn_torch
(ops/gen_fused_rbm.py ``wdtype``, ops/gen_fused_nade.py ``aux_dtype``)
against the JAX package: the storage-dtype rule equal to the reference's
for the shipped configs over serving batches (None, its scan path, as
float32); each mode's plain version bit-equal in the roll to the Pallas
kernel in interpret mode (h and c within the f32 tests' 1e-5); the
reference's own checks of the modes (zero-coupling rolls identical
between the modes, ramped-bias means within 0.13); and the rule read at
the whole batch under a row map."""

import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops import gen_fused as jax_gen_fused  # noqa: E402
from multinn_tpu.ops import gen_fused_nade as jax_gen_fused_nade  # noqa: E402
from multinn_tpu.utils import config as jax_config  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import (gen_common, gen_fused,  # noqa: E402
                               gen_fused_nade, gen_fused_rbm, sampling)
from multinn_torch.utils import config  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
K, D, H, U, T = 3, 12, 8, 6, 16
CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
FLAGSHIP = dict(n_tracks=5, n_pitches=84, mode="feedback", n_hidden=150,
                n_rnn=100, gen_k=10)
# the shipped configs, the two-layer flagship (tests/test_gen_gates.py) and
# joint mode of both flagship families
RULE_CONFIGS = sorted(p.name for p in CONFIGS.glob("*.json")) + [
    "two-layer", "joint-rbm", "joint-nade"]
BATCHES = (1, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _configs(name):
    """(JAX config, port config) of a rule case."""
    if name.endswith(".json"):
        return (jax_config.load_json(str(CONFIGS / name)).model,
                config.load_json(str(CONFIGS / name)).model)
    kw = dict(FLAGSHIP, rnn_layers=2) if name == "two-layer" else dict(
        FLAGSHIP, mode="joint",
        decoder_type="rnn-nade" if name == "joint-nade" else "rnn-rbm")
    return jax_multinn.MultINNConfig(**kw), multinn.MultINNConfig(**kw)


def _as_torch(jax_dtype):
    if jax_dtype is None:                 # the reference's scan path
        return torch.float32
    return {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[
        jax_dtype]


@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("name", RULE_CONFIGS)
def test_storage_rule_equals_the_jax_package(name, extra):
    """rbm_weight_dtype(cfg, B, conditioned) and nade_aux_dtype(cfg, B,
    n_given) against the JAX package's, at every serving batch."""
    jcfg, tcfg = _configs(name)
    got = []
    for b in BATCHES:
        want_rbm = jax_gen_fused.rbm_weight_dtype(jcfg, b,
                                                  conditioned=bool(extra))
        want_nade = jax_gen_fused_nade.nade_aux_dtype(jcfg, b, n_given=extra)
        rbm = gen_fused.rbm_weight_dtype(tcfg, b, conditioned=bool(extra))
        nade = gen_fused.nade_aux_dtype(tcfg, b, n_given=extra)
        assert (rbm, nade) == (_as_torch(want_rbm), _as_torch(want_nade)), b
        got.append((rbm, nade))
    bf16 = {b for b, (r, n) in zip(BATCHES, got)
            if torch.bfloat16 in (r, n)}
    # the cells where the reference samples from bf16-rounded weights
    flips = {("lakh_16th_128bar.json", 0): {1, 8, 16, 24},
             ("lpd5_multinn_rnnrbm.json", 0): {96, 128},
             ("two-layer", 0): {1, 8, 16, 24, 32, 48, 64}}
    if (name, extra) in flips:
        assert bf16 == flips[(name, extra)]


def test_storage_rule_at_the_flagships():
    """The flagship RBM samples from f32 weights up to B=16 and from bf16
    ones at serving batches 24-128; the NADE flagship's aux matrices flip
    at 64; past the budget (and at batches not 1 or a multiple of 8 for
    the NADE) the reference runs its scan path: f32."""
    rbm = multinn.MultINNConfig(**FLAGSHIP)
    nade = dataclasses.replace(rbm, decoder_type="rnn-nade")
    assert [gen_fused.rbm_weight_dtype(rbm, b) for b in (16, 24, 128, 192)] \
        == [torch.float32, torch.bfloat16, torch.bfloat16, torch.float32]
    assert [gen_fused.nade_aux_dtype(nade, b) for b in (48, 64, 96, 65)] \
        == [torch.float32, torch.bfloat16, torch.float32, torch.float32]
    assert gen_fused.nade_aux_dtype(rbm, 64) == torch.float32
    # the contract's bytes at the flip: f32 over 10 MiB, bf16 within
    dims = gen_common.dims_of_cfg(rbm)
    assert (gen_common.rbm_layout_bytes(dims, 24, 4)
            > gen_common.VMEM_BUDGET_BYTES
            >= gen_common.rbm_layout_bytes(dims, 24, 2))


# -- each mode's plain version against the Pallas kernel in interpret mode ---

def _primed(family, mode, cell, layers, batch, seed=0, w_std=0.5):
    cfg = jax_multinn.MultINNConfig(
        n_tracks=K, n_pitches=D, mode=mode, decoder_type=family,
        n_hidden=H, n_rnn=U, cell=cell, rnn_layers=layers, gen_k=2,
        w_std=w_std)
    jp = jax_multinn.init(jax.random.PRNGKey(seed), cfg)
    tp = from_jax(jp, device="cpu")
    roll = (np.random.default_rng(seed + 1).random((batch, 4, K, D)) < 0.3
            ).astype(np.float32)
    js = jax_multinn.prime(jp, jax_multinn.init_state(jp, batch),
                           jnp.asarray(roll))
    h0 = np.stack([np.asarray(c.h) for c in js.decoder.cell])
    c0 = np.stack([np.asarray(getattr(c, "c", np.zeros_like(c.h)))
                   for c in js.decoder.cell])
    return jp, tp, js.decoder.v_prev, h0, c0


RBM_CASES = [("feedback", "lstm", 1, ()), ("per-track", "vanilla", 1, ()),
             ("feedback", "lstm", 2, ()), ("feedback", "lstm", 1, (1,))]


@pytest.mark.parametrize("mode,cell,layers,given_tracks", RBM_CASES)
def test_rbm_bf16_plain_bit_equal_to_pallas_interpret(mode, cell, layers,
                                                      given_tracks):
    b = 4
    jp, tp, v0, h0, c0 = _primed("rnn-rbm", mode, cell, layers, b, seed=1)
    given = None
    if given_tracks:
        given = (np.random.default_rng(9).random((b, T, K, D)) < 0.4
                 ).astype(np.float32)
    jroll, jh, jc = jax_gen_fused.generate_rbm(
        jax.random.PRNGKey(5), jp.decoder, jnp.asarray(h0), jnp.asarray(c0),
        v0, T, 2, interpret=True, wdtype=jnp.bfloat16,
        given=None if given is None else jnp.asarray(given),
        given_tracks=given_tracks)

    def run(wdtype):
        return gen_fused.generate_rbm(
            sampling.PRNGKey(5), tp.decoder, torch.from_numpy(h0),
            torch.from_numpy(c0), torch.from_numpy(np.asarray(v0)), T, 2,
            wdtype=wdtype,
            given=None if given is None else torch.from_numpy(given),
            given_tracks=given_tracks)

    troll, th, tc = run(torch.bfloat16)
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    assert 0.05 < float(troll.mean()) < 0.95          # non-degenerate
    # the mode computes another function than f32 storage
    assert not torch.equal(run(torch.float32)[1], th)


@pytest.mark.parametrize("spec", [1, 2, 4])
def test_nade_bf16_aux_plain_bit_equal_to_pallas_interpret(spec):
    """Two LSTM layers (wuh, wh and the layer-1 input projection all in the
    mode), feedback context, at each speculative depth."""
    b = 8
    jp, tp, v0, h0, c0 = _primed("rnn-nade", "feedback", "lstm", 2, b,
                                 seed=2, w_std=0.7)
    jroll, jh, jc = jax_gen_fused.generate_nade(
        jax.random.PRNGKey(6), jp.decoder, jnp.asarray(h0), jnp.asarray(c0),
        v0, T, interpret=True, spec=spec, aux_dtype=jnp.bfloat16)

    def run(aux_dtype):
        return gen_fused.generate_nade(
            sampling.PRNGKey(6), tp.decoder, torch.from_numpy(h0),
            torch.from_numpy(c0), torch.from_numpy(np.asarray(v0)), T,
            spec=spec, aux_dtype=aux_dtype)

    troll, th, tc = run(torch.bfloat16)
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    assert 0.05 < float(troll.mean()) < 0.95
    assert not torch.equal(run(torch.float32)[1], th)


def test_nade_bf16_aux_given_track_bit_equal_to_pallas_interpret():
    b = 8
    jp, tp, v0, h0, c0 = _primed("rnn-nade", "feedback", "lstm", 1, b,
                                 seed=3, w_std=0.7)
    given = (np.random.default_rng(4).random((b, T, K, D)) < 0.5
             ).astype(np.float32)
    jroll, jh, jc = jax_gen_fused.generate_nade(
        jax.random.PRNGKey(8), jp.decoder, jnp.asarray(h0), jnp.asarray(c0),
        v0, T, interpret=True, aux_dtype=jnp.bfloat16,
        given=jnp.asarray(given), given_tracks=(0,))
    troll, th, tc = gen_fused.generate_nade(
        sampling.PRNGKey(8), tp.decoder, torch.from_numpy(h0),
        torch.from_numpy(c0), torch.from_numpy(np.asarray(v0)), T,
        aux_dtype=torch.bfloat16, given=torch.from_numpy(given),
        given_tracks=(0,))
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_the_mode_stores_what_the_reference_stores():
    """bf16 exactly where the reference keeps bf16: the RBM's W, Wuv, Wuh and
    Wctx; the NADE's wuh, wh and wx_r beside its always-bf16 five."""
    _, tp, v0, h0, c0 = _primed("rnn-rbm", "feedback", "lstm", 2, 2)
    st = [torch.from_numpy(x) for x in (h0, c0)]
    args = gen_fused_rbm._rbm_args(tp.decoder, *st,
                                   torch.from_numpy(np.asarray(v0)),
                                   torch.bfloat16)
    bf16 = {n for n, x in args._asdict().items()
            if x is not None and x.dtype == torch.bfloat16}
    assert bf16 == {"w", "wuv", "wuh", "wctx"}
    _, tp, v0, h0, c0 = _primed("rnn-nade", "feedback", "lstm", 2, 2)
    st = [torch.from_numpy(x) for x in (h0, c0)]
    args = gen_fused_nade._nade_args(tp.decoder, *st,
                                     torch.from_numpy(np.asarray(v0)),
                                     torch.bfloat16)
    bf16 = {n for n, x in args._asdict().items()
            if x is not None and x.dtype == torch.bfloat16}
    assert bf16 == {"w", "v", "wuv", "wx_v", "wctx", "wuh", "wh", "wx_r"}


# -- the reference's own checks of the modes (tests/test_gen_fused.py) -------

REF_K, REF_D, REF_H, REF_U = 3, 16, 12, 10


def _ref_params(family, w_std, ramp):
    cfg = jax_multinn.MultINNConfig(
        n_tracks=REF_K, n_pitches=REF_D, mode="feedback",
        decoder_type=family, n_hidden=REF_H, n_rnn=REF_U, cd_k=1, gen_k=3,
        w_std=w_std)
    dec = from_jax(jax_multinn.init(jax.random.PRNGKey(0), cfg),
                   device="cpu").decoder
    if ramp:
        return dataclasses.replace(
            dec, bv=dec.bv + torch.linspace(-2.0, 2.0, REF_D)[None, :])
    pattern = torch.where(torch.arange(REF_D) % 3 == 0, 10.0, -10.0)
    zero = {n: torch.zeros_like(getattr(dec, n))
            for n in ("w", "wuv", "wuh") + (("v",) if family == "rnn-nade"
                                             else ())}
    return dataclasses.replace(dec, bv=pattern.repeat(REF_K, 1), **zero)


def _ref_run(family, dec, key, n_steps, dtype):
    h0 = torch.zeros(REF_K, 1, REF_U)
    v0 = torch.zeros(REF_K, 1, REF_D)
    if family == "rnn-rbm":
        return gen_fused.generate_rbm(sampling.PRNGKey(key), dec, h0, h0, v0,
                                      n_steps, 3 if n_steps > 4 else 2,
                                      wdtype=dtype)[0]
    return gen_fused.generate_nade(sampling.PRNGKey(key), dec, h0, h0, v0,
                                   n_steps, aux_dtype=dtype)[0]


@pytest.mark.parametrize("family,w_std", [("rnn-rbm", 0.2),
                                          ("rnn-nade", 0.3)])
def test_modes_sample_the_f32_distribution(family, w_std):
    """Ramped visible biases: the bf16 mode's per-pitch means within 0.13
    of f32's over 96 steps (different keys, as the reference's check); with
    every coupling zeroed the strong-bias pattern is bit-identical
    between the modes (rounding zeros is exact)."""
    dec = _ref_params(family, w_std, ramp=True)
    m32 = _ref_run(family, dec, 1, 96, torch.float32).mean(dim=(0, 1, 2))
    m16 = _ref_run(family, dec, 2, 96, torch.bfloat16).mean(dim=(0, 1, 2))
    np.testing.assert_allclose(m16.numpy(), m32.numpy(), atol=0.13)
    dec0 = _ref_params(family, 0.0, ramp=False)
    a = _ref_run(family, dec0, 3, 4, torch.float32)
    b = _ref_run(family, dec0, 3, 4, torch.bfloat16)
    assert torch.equal(a, b)


# -- the rule under a row map reads the whole batch ---------------------------

def _spy(monkeypatch, module, name):
    seen = []
    real = getattr(module, name)

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(module, name, spy)
    return seen


def test_rule_under_a_row_map_reads_the_whole_batch(monkeypatch):
    """A shard of 8 rows stores what one device running the whole batch
    stores: bf16 for the flagship RBM at B_global=24 and the NADE flagship
    at B_global=64, where 8 rows alone are f32; f32 at B_global=16 and 48,
    where the whole batch's f32 layout fits the reference's budget."""
    rbm_cfg = multinn.MultINNConfig(**FLAGSHIP)
    tp = multinn.init(rbm_cfg, torch.Generator().manual_seed(0), "cpu")
    state = multinn.init_state(tp, 8)
    h0 = torch.stack([c.h for c in state.decoder.cell])
    c0 = torch.stack([c.c for c in state.decoder.cell])
    seen = _spy(monkeypatch, gen_fused_rbm, "_rbm_args")
    for rows in (None, (8, 24), (8, 16)):
        gen_fused.generate_rbm(sampling.PRNGKey(0), tp.decoder, h0, c0,
                               state.decoder.v_prev, 1, 1, rows=rows)
    assert seen == [torch.float32, torch.bfloat16, torch.float32]

    nade_cfg = dataclasses.replace(rbm_cfg, decoder_type="rnn-nade")
    tp = multinn.init(nade_cfg, torch.Generator().manual_seed(0), "cpu")
    state = multinn.init_state(tp, 8)
    h0 = torch.stack([c.h for c in state.decoder.cell])
    c0 = torch.stack([c.c for c in state.decoder.cell])
    seen = _spy(monkeypatch, gen_fused_nade, "_nade_args")
    for rows in (None, (56, 64), (40, 48)):
        gen_fused.generate_nade(sampling.PRNGKey(0), tp.decoder, h0, c0,
                                state.decoder.v_prev, 1, rows=rows)
    assert seen == [torch.float32, torch.bfloat16, torch.float32]


def test_rule_is_the_same_at_every_depth(monkeypatch):
    """The NADE flagship at B=64, where the reference stores its aux
    matrices in bf16: every speculative depth asked for stores the same
    (the rule charges the default depth's side table), so every depth
    returns the same roll."""
    cfg = multinn.MultINNConfig(**dict(FLAGSHIP, decoder_type="rnn-nade"))
    tp = multinn.init(cfg, torch.Generator().manual_seed(0), "cpu")
    state = multinn.init_state(tp, 64)
    h0 = torch.stack([c.h for c in state.decoder.cell])
    c0 = torch.stack([c.c for c in state.decoder.cell])
    seen = _spy(monkeypatch, gen_fused_nade, "_nade_args")
    rolls = [gen_fused.generate_nade(sampling.PRNGKey(3), tp.decoder, h0, c0,
                                     state.decoder.v_prev, 1, spec=spec)[0]
             for spec in (1, 2, 4, None)]
    assert seen == [torch.bfloat16] * 4
    assert all(torch.equal(r, rolls[0]) for r in rolls[1:])
