"""Accompaniment in multinn_torch's serving layer against the JAX package
on the CPU: ``Generator.accompany`` (init_state -> prime -> the fused
kernel's plain version with the given features -> bitpack) bit-equal to
the JAX package's same chain with the Pallas kernel in interpret mode, for
a pass-through and a DBN encoder; the service's accompaniment requests as
the JAX package's ``tests/test_serving.py`` holds them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops import bitpack as jax_bitpack  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import sampling  # noqa: E402
from multinn_torch.serving import service  # noqa: E402
from multinn_torch.training.generator import Generator  # noqa: E402
from multinn_torch.utils import config  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

torch.set_num_threads(1)
K, D, H, U = 3, 10, 8, 6


def _cfg(decoder="rnn-nade", mode="feedback", **kw):
    return dict(dict(n_tracks=K, n_pitches=D, mode=mode,
                     decoder_type=decoder, n_hidden=H, n_rnn=U, cd_k=1,
                     gen_k=3, w_std=0.5), **kw)


def _params(decoder="rnn-nade", mode="feedback", seed=0, **kw):
    """JAX params and their port; a DBN's hidden biases drawn away from 0,
    so no feature sits on the threshold."""
    jp = jax_multinn.init(jax.random.PRNGKey(seed),
                          jax_multinn.MultINNConfig(**_cfg(decoder, mode,
                                                           **kw)))
    rng = np.random.default_rng(seed)
    jp = jp.replace(encoder=tuple(
        e.replace(bh=jnp.asarray(rng.normal(0, 0.5, e.bh.shape),
                                 jnp.float32)) for e in jp.encoder))
    return jp, from_jax(jp, device="cpu")


def _given(b=2, t=6, seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((b, t, K, D)) < density).astype(np.float32)


def _margin(tp, x):
    """The least |pre-activation| of a shared one-layer DBN over x."""
    if not tp.encoder:
        return np.inf
    xk = torch.from_numpy(x).reshape(-1, D)
    return float((xk @ tp.encoder[0].w + tp.encoder[0].bh).abs().min())


def _experiment(decoder="rnn-nade", mode="feedback", n_steps=6, **kw):
    return config.ExperimentConfig(
        model=multinn.MultINNConfig(**_cfg(decoder, mode, **kw)),
        data=config.DataConfig(n_tracks=K, pitch_min=24,
                               pitch_max=24 + D - 1),
        generate=config.GenerateConfig(n_steps=n_steps, seed_steps=3))


@pytest.mark.parametrize("enc", [(), (6,)])
def test_generator_accompany_bit_equal_to_jax(enc):
    """Generator.accompany: init_state -> prime on the seed -> the fused
    kernel with the given features -> bitpack, equal to the JAX package's
    same chain with the Pallas kernel in interpret mode."""
    jp, tp = _params("rnn-nade", encoder_hidden=enc, seed=2)
    gen = Generator(_experiment(encoder_hidden=enc), tp)
    g = _given(seed=3)
    seed = _given(t=4, seed=4)
    assert _margin(tp, g) > 1e-5 and _margin(tp, seed) > 1e-5
    js = jax_multinn.prime(jp, jax_multinn.init_state(jp, 2),
                           jnp.asarray(seed))
    _, jroll = jax_multinn._generate_accomp_fused(
        jp, jax.random.PRNGKey(9), js, jnp.asarray(g), (1,), interpret=True)
    want = jax_bitpack.unpack_rolls(
        np.asarray(jax_bitpack.pack_rolls(jroll)), D)
    got = gen.accompany(sampling.PRNGKey(9), g, (1,), seed=seed)
    assert got.dtype == np.uint8 and got.shape == g.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :, 1], g[:, :, 1])
    out = gen.accompany_async(sampling.PRNGKey(9), g, (1,), seed=seed)
    assert out.event is None and out.packed.dtype == torch.uint8
    np.testing.assert_array_equal(gen.fetch_rolls(out), want)
    with pytest.raises(ValueError, match="seed batch"):
        gen.accompany(sampling.PRNGKey(0), g, (1,), seed=seed[:1])


def test_service_accompaniment_requests():
    """accompany_tracks: accompaniment requests resolve with the given
    track passed through bit for bit; short given rolls right-pad zeros;
    accompaniment and plain requests go into separate batches; a service
    without accompany_tracks, seed and given together, and a bad shape
    raise."""
    _, tp = _params("rnn-nade", seed=1, w_std=0.3)
    cfg = _experiment()
    given = (np.random.default_rng(1).random((10, K, D)) < 0.2).astype(
        np.uint8)
    svc = service.GenerationService(cfg, tp, service.ServeConfig(
        batch=2, n_steps=6, seed_steps=3, accompany_tracks=(0,),
        accompany_steps=10, max_wait_ms=500.0))
    try:
        futs = [svc.submit(given=given), svc.submit(given=given),
                svc.submit()]
        res = [f.result(timeout=120) for f in futs]
        assert res[0].roll.shape == (10, K, D)        # accompany_steps
        assert res[2].roll.shape == (6, K, D)
        np.testing.assert_array_equal(res[0].roll[:, 0], given[:, 0])
        np.testing.assert_array_equal(res[1].roll[:, 0], given[:, 0])
        st = svc.stats()
        assert st["batches"] == 2 and st["accompany_batches"] == 1
        assert st["accompany_tracks"] == [0]
        assert res[0].batch_index == res[1].batch_index != res[2].batch_index
        # batch i samples under fold_in(PRNGKey(seed), i)
        direct = svc.generator.accompany(
            sampling.fold_in(sampling.PRNGKey(0), res[0].batch_index),
            np.stack([given, given]).astype(np.float32), (0,))
        for r in res[:2]:
            np.testing.assert_array_equal(r.roll, direct[r.row])
        short = svc.submit(given=given[:4]).result(timeout=120)
        np.testing.assert_array_equal(short.roll[:4, 0], given[:4, 0])
        assert short.roll[4:, 0].sum() == 0
        many = svc.submit_many(3, given=given)
        assert all(f.result(timeout=120).roll.shape == (10, K, D)
                   for f in many)
        with pytest.raises(ValueError, match="either a priming seed or"):
            svc.submit(seed=np.zeros((4, K, D), np.uint8), given=given)
        with pytest.raises(ValueError, match="accompaniment roll"):
            svc.submit(given=np.zeros((4, K + 1, D), np.uint8))
    finally:
        svc.close()
    svc2 = service.GenerationService(cfg, tp, service.ServeConfig(
        batch=2, n_steps=6))
    try:
        with pytest.raises(ValueError, match="accompany_tracks"):
            svc2.submit(given=given)
    finally:
        svc2.close()
