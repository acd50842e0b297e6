"""The sparse transport in multinn_torch against the JAX package on the
CPU:

* ``ops/sparsebytes``: ``sparse_pack`` records and count bit-equal to the
  JAX codec, the exact count past ``cap`` with the truncated records,
  ``sparse_unpack`` inverting them, ``record_cap`` and ``n_chunks``;
* ``Generator``: the rolls of ``packed="sparse"`` equal the packed
  transport's, for plain and accompaniment generations, through several
  fetch chunks with and without a size hint, and through the frame
  fallback when the records overflow their buffer;
* the service: sparse rolls equal packed ones, two consecutive overflows
  demote it (an overflow-free batch in between resets the count), and
  ``_resolve_transport`` resolves every choice as the JAX one does off the
  card, and "auto" to packed on a CUDA device.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from multinn_tpu.ops import sparsebytes as jax_sparsebytes  # noqa: E402
from multinn_tpu.serving import service as jax_service  # noqa: E402
from multinn_tpu.utils import config as jax_config  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import sampling, sparsebytes  # noqa: E402
from multinn_torch.serving import service  # noqa: E402
from multinn_torch.training.generator import Generator  # noqa: E402
from multinn_torch.utils import config  # noqa: E402

torch.set_num_threads(1)
K, D, T = 3, 16, 8
MODEL = dict(n_tracks=K, n_pitches=D, mode="feedback", n_hidden=8, n_rnn=6,
             gen_k=2)


def _cfg(**model):
    return config.ExperimentConfig(
        model=multinn.MultINNConfig(**dict(MODEL, **model)),
        data=config.DataConfig(n_tracks=K, pitch_min=40,
                               pitch_max=40 + D - 1),
        generate=config.GenerateConfig(n_steps=T, seed_steps=3))


def _params(cfg, seed=0):
    return multinn.init(cfg.model, torch.Generator().manual_seed(seed),
                        device="cpu")


@pytest.mark.parametrize("shape,density,cap", [
    ((3, 7, 2, 2), 0.3, 16), ((4, 5, 3), 0.05, 64), ((2, 9), 0.9, 4),
    ((5,), 0.0, 8), ((6, 4, 2), 0.5, 1)])
def test_codec_bit_equal_to_jax(shape, density, cap):
    rng = np.random.default_rng(len(shape))
    pk = ((rng.random(shape) < density)
          * rng.integers(1, 256, shape)).astype(np.uint8)
    jbuf, jcount = jax_sparsebytes.sparse_pack(jnp.asarray(pk), cap)
    buf, count = sparsebytes.sparse_pack(torch.from_numpy(pk), cap)
    assert buf.dtype == torch.uint8 and buf.shape == (cap, 5)
    assert count.dtype == torch.int32
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert int(count) == int(jcount) == int((pk != 0).sum())
    if int(count) <= cap:
        np.testing.assert_array_equal(
            sparsebytes.sparse_unpack(buf.numpy(), int(count), shape), pk)
    else:                                    # truncated: the first cap
        np.testing.assert_array_equal(       # records, in order
            buf.numpy()[:, 4], pk.reshape(-1)[pk.reshape(-1) != 0][:cap])
    with pytest.raises(ValueError, match="can't hold"):
        sparsebytes.sparse_unpack(buf.numpy()[:0], 1, shape)


@pytest.mark.parametrize("size", [0, 1, 4, 1 << 20, 4 * 262144 + 4, 10 ** 8])
def test_record_cap_and_chunks_equal_jax(size):
    assert sparsebytes.record_cap(size) == jax_sparsebytes.record_cap(size)
    assert (sparsebytes.record_cap(size, 16)
            == jax_sparsebytes.record_cap(size, 16))
    assert sparsebytes.n_chunks(size) == jax_sparsebytes.n_chunks(size)
    assert sparsebytes.n_chunks(size, 7) == jax_sparsebytes.n_chunks(size, 7)


@pytest.fixture
def small_chunks(monkeypatch):
    """Chunks of 4 records and a buffer of 256, so one generation's
    records span several chunks."""
    monkeypatch.setattr(sparsebytes, "FETCH_CHUNK", 4)
    monkeypatch.setattr(sparsebytes, "record_cap", lambda size, chunk=4: 256)


def test_generator_sparse_equals_packed(small_chunks):
    cfg = _cfg()
    gen = Generator(cfg, _params(cfg))
    key = sampling.PRNGKey(7)
    want = gen.fetch_rolls(gen.generate_async(key, T, 4))
    out = gen.generate_async(key, T, 4, packed="sparse")
    count = int(out.count)
    assert 4 < count <= 256 and out.sparse.shape == (256, 5)
    np.testing.assert_array_equal(gen.fetch_rolls(out), want)
    assert gen.last_sparse_count == count
    assert not gen.last_sparse_overflowed
    for hint in (count, 1, 10 ** 6):        # exact, too small, too large
        np.testing.assert_array_equal(gen.fetch_rolls(out, size_hint=hint),
                                      want)
    given = (np.random.default_rng(0).random((2, T, K, D)) < 0.3
             ).astype(np.float32)
    want = gen.fetch_rolls(gen.accompany_async(key, given, (1,)))
    np.testing.assert_array_equal(
        gen.fetch_rolls(gen.accompany_async(key, given, (1,),
                                            packed="sparse")), want)
    np.testing.assert_array_equal(want[:, :, 1], given[:, :, 1])
    with pytest.raises(ValueError, match="packed"):
        gen.generate_async(key, T, 1, packed=False)


def test_generator_overflow_takes_the_frame_fallback(monkeypatch):
    monkeypatch.setattr(sparsebytes, "record_cap", lambda size, chunk=0: 4)
    cfg = _cfg(w_std=3.0)                    # dense rolls
    gen = Generator(cfg, _params(cfg))
    key = sampling.PRNGKey(3)
    want = gen.fetch_rolls(gen.generate_async(key, T, 2))
    out = gen.generate_async(key, T, 2, packed="sparse")
    assert int(out.count) > 4
    np.testing.assert_array_equal(gen.fetch_rolls(out, size_hint=2), want)
    assert gen.last_sparse_overflowed and gen.last_sparse_count is None


def _serve(cfg, transport, **kw):
    return service.GenerationService(cfg, _params(cfg), service.ServeConfig(
        batch=4, n_steps=T, transport=transport, **kw))


def test_service_sparse_equals_packed(small_chunks):
    cfg = _cfg()
    rolls = {}
    for transport in ("packed", "sparse"):
        svc = _serve(cfg, transport, accompany_tracks=(0,))
        try:
            st = svc.stats()
            assert st["transport"] == transport
            assert st["transport_demoted"] is False
            given = np.zeros((T, K, D), np.uint8)
            given[:, 0, 2] = 1
            futs = svc.submit_many(4) + svc.submit_many(2, given=given)
            rolls[transport] = np.stack([f.result(60).roll for f in futs])
            assert svc.stats()["errors"] == 0
        finally:
            svc.close()
    np.testing.assert_array_equal(rolls["sparse"], rolls["packed"])


def test_service_demotes_after_two_overflows(monkeypatch):
    monkeypatch.setattr(sparsebytes, "record_cap", lambda size, chunk=0: 4)
    cfg = _cfg(w_std=3.0)
    svc = _serve(cfg, "sparse")
    try:
        svc._note_sparse_overflow(True)      # one, then a clean batch
        svc._note_sparse_overflow(False)
        assert svc._n_sparse_overflows == 0
        for _ in range(2):                   # two overflowing batches
            for f in svc.submit_many(4):
                f.result(60)
        st = svc.stats()
        assert st["transport"] == "sparse" and st["transport_demoted"]
        assert st["errors"] == 0
        gen = Generator(cfg, svc.generator.params)
        key = sampling.fold_in(sampling.PRNGKey(0), 2)
        want = gen.finalize(gen.fetch_rolls(gen.generate_async(key, T, 4)))
        got = np.stack([f.result(60).roll for f in svc.submit_many(4)])
        np.testing.assert_array_equal(got, want)
    finally:
        svc.close()


@pytest.mark.parametrize("choice", ["auto", "packed", "sparse"])
@pytest.mark.parametrize("batch,n_steps", [(4, 8), (8, 1024), (47, 1024),
                                           (64, 1024), (128, 8192)])
@pytest.mark.parametrize("d", [16, 84])
def test_resolve_transport_as_jax(choice, batch, n_steps, d):
    cfg = _cfg(n_pitches=d)
    jcfg = jax_config.from_dict(jax_config.ExperimentConfig,
                                config.to_dict(cfg))
    got = service._resolve_transport(choice, cfg, batch, n_steps)
    assert got == jax_service._resolve_transport(choice, jcfg, batch,
                                                 n_steps)
    assert got is True or got == "sparse"
    assert service._resolve_transport(choice, cfg, batch, n_steps,
                                      torch.device("cpu")) == got
    # on a CUDA device "auto" is packed (the card's measured drains)
    card = service._resolve_transport(choice, cfg, batch, n_steps,
                                      torch.device("cuda", 0))
    assert card == (True if choice == "auto" else got)
    with pytest.raises(ValueError, match="transport"):
        service._resolve_transport("zstd", cfg, batch, n_steps)
