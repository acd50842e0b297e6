"""The multinn_torch serving slice end to end on the CPU, against the JAX
package, for both decoder families: parameter conversion, configs, the
Generator (bit-equal to JAX's init_state -> prime -> fused kernel in
interpret mode -> bitpack for the same key), the GenerationService and its
batch choice, the scan path (distribution level: its Gibbs chains draw the
kernel stream, JAX's draw jax.random) and an import of the port with JAX
blocked."""

import dataclasses
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.models import base as jax_base  # noqa: E402
from multinn_tpu.models import encoders as jax_encoders  # noqa: E402
from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops import bitpack as jax_bitpack  # noqa: E402
from multinn_tpu.ops import sampling as jax_sampling  # noqa: E402
from multinn_tpu.serving import service as jax_service  # noqa: E402
from multinn_tpu.utils import config as jax_config  # noqa: E402
from multinn_torch.models import base, encoders, multinn  # noqa: E402
from multinn_torch.ops import bitpack, sampling  # noqa: E402
from multinn_torch.serving import service  # noqa: E402
from multinn_torch.training.generator import Generator  # noqa: E402
from multinn_torch.utils import config  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, D, B, T = 3, 8, 3, 5
MODEL = dict(n_tracks=K, n_pitches=D, mode="feedback", n_hidden=6, n_rnn=4,
             gen_k=2, w_std=0.5)


def _jax_params(seed=0, **kw):
    return jax_multinn.init(jax.random.PRNGKey(seed),
                            jax_multinn.MultINNConfig(**dict(MODEL, **kw)))


def _experiment():
    return config.ExperimentConfig(
        model=multinn.MultINNConfig(**MODEL),
        data=config.DataConfig(n_tracks=K, pitch_min=24, pitch_max=24 + D - 1),
        generate=config.GenerateConfig(n_steps=T, seed_steps=3))


def test_from_jax_keeps_the_layout():
    jp = _jax_params()
    tp = from_jax(jp, device="cpu")
    assert dataclasses.asdict(tp.cfg) == dataclasses.asdict(jp.cfg)
    assert tp.encoder == ()
    for name in ("w", "bv", "bh", "wuv", "wuh"):
        want = np.asarray(getattr(jp.decoder, name))
        got = getattr(tp.decoder, name)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    for jc, tc in zip(jp.decoder.cell, tp.decoder.cell):
        for name in ("wx", "wh", "b"):
            np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                          np.asarray(getattr(jc, name)))
    one = multinn.index_tree(tp.decoder, 2)
    np.testing.assert_array_equal(one.w.numpy(), np.asarray(jp.decoder.w[2]))
    restacked = multinn.stack_trees([multinn.index_tree(tp.decoder, i)
                                     for i in range(K)])
    assert torch.equal(restacked.cell[0].wx, tp.decoder.cell[0].wx)


def test_init_matches_jax_shapes():
    cfg = multinn.MultINNConfig(**MODEL)
    tp = multinn.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = _jax_params()
    jleaves = jax.tree.leaves(jp.decoder)
    tleaves = [tp.decoder.cell[0].wx, tp.decoder.cell[0].wh,
               tp.decoder.cell[0].b, tp.decoder.w, tp.decoder.bv,
               tp.decoder.bh, tp.decoder.wuv, tp.decoder.wuh]
    assert [tuple(x.shape) for x in tleaves] == [x.shape for x in jleaves]
    np.testing.assert_array_equal(tp.decoder.cell[0].b.numpy(),
                                  np.asarray(jp.decoder.cell[0].b))


@pytest.mark.parametrize("path", sorted(
    os.path.join(REPO, "configs", f)
    for f in os.listdir(os.path.join(REPO, "configs")) if f.endswith(".json")))
def test_every_config_loads_like_jax(path):
    got = dataclasses.asdict(config.load_json(path))
    want = dataclasses.asdict(jax_config.load_json(path))
    assert got == want


@pytest.mark.parametrize("ours,theirs", [
    (config.ExperimentConfig, jax_config.ExperimentConfig),
    (config.DataConfig, jax_config.DataConfig),
    (config.TrainConfig, jax_config.TrainConfig),
    (config.GenerateConfig, jax_config.GenerateConfig),
    (config.MeshConfig, jax_config.MeshConfig),
    (multinn.MultINNConfig, jax_multinn.MultINNConfig),
    (base.DecoderConfig, jax_base.DecoderConfig),
    (encoders.EncoderConfig, jax_encoders.EncoderConfig),
    (service.ServeConfig, jax_service.ServeConfig)])
def test_config_fields_and_defaults_equal_jax(ours, theirs):
    def defaults(cls):
        out = {}
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                out[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                out[f.name] = dataclasses.asdict(f.default_factory())
            else:
                out[f.name] = None
        return out
    assert defaults(ours) == defaults(theirs)


@pytest.mark.parametrize("fields", [
    dict(transpose_range=-1), dict(transpose_range=84),
    dict(transpose_range=100), dict(transpose_exclude=(5,)),
    dict(transpose_exclude=(-1, 2)), dict(encoding="piano"),
    dict(transpose_range=83, transpose_exclude=(0, 4))])
def test_data_config_refuses_what_jax_refuses(fields):
    """The port's DataConfig refuses exactly the dicts the reference's
    refuses (transpose range outside [0, n_pitches), track indices outside
    [0, n_tracks), an unknown encoding), and accepts the rest alike."""
    kw = dict(pitch_min=24, pitch_max=107, n_tracks=5, **fields)
    try:
        want = dataclasses.asdict(jax_config.DataConfig(**kw))
    except ValueError:
        with pytest.raises(ValueError):
            config.DataConfig(**kw)
        return
    assert dataclasses.asdict(config.DataConfig(**kw)) == want


def test_bitpack_matches_jax_and_round_trips():
    roll = (np.random.default_rng(0).random((2, 7, K, 13)) < 0.4
            ).astype(np.float32)
    packed = bitpack.pack_rolls(torch.from_numpy(roll))
    assert packed.dtype == torch.uint8 and packed.shape == (2, 7, K, 2)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jax_bitpack.pack_rolls(jnp.asarray(roll))))
    np.testing.assert_array_equal(bitpack.unpack_rolls(packed.numpy(), 13),
                                  roll.astype(np.uint8))


def _jax_generation(jp, seed_roll, key_seed, batch):
    state = jax_multinn.init_state(jp, batch)
    if seed_roll is not None:
        state = jax_multinn.prime(jp, state, jnp.asarray(seed_roll))
    _, roll = jax_multinn._generate_fused(jp, jax.random.PRNGKey(key_seed),
                                          state, T, interpret=True)
    return jax_bitpack.unpack_rolls(
        np.asarray(jax_bitpack.pack_rolls(roll)), D)


@pytest.mark.parametrize("seeded", [False, True])
def test_generator_bit_equal_to_jax(seeded):
    jp = _jax_params(1)
    gen = Generator(_experiment(), from_jax(jp, device="cpu"))
    seed_roll = ((np.random.default_rng(2).random((B, 4, K, D)) < 0.3)
                 .astype(np.float32) if seeded else None)
    want = _jax_generation(jp, seed_roll, 11, B)
    got = gen.generate(sampling.PRNGKey(11), T, seed=seed_roll, batch=B)
    assert got.shape == (B, T, K, D) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    out = gen.generate_async(sampling.PRNGKey(11), T, B, seed=seed_roll)
    assert out.event is None and out.packed.dtype == torch.uint8
    np.testing.assert_array_equal(gen.fetch_rolls(out), want)
    with pytest.raises(ValueError):
        gen.generate(sampling.PRNGKey(0), T, batch=B + 1,
                     seed=np.zeros((B, 2, K, D), np.float32))


def test_service_answers_plain_and_seeded_requests():
    tp = from_jax(_jax_params(2), device="cpu")
    svc = service.GenerationService(_experiment(), tp, service.ServeConfig(
        batch=2, n_steps=T, seed_steps=3, seed=4, max_wait_ms=1.0))
    try:
        rng = np.random.default_rng(5)
        seeds = (rng.random((2, 6, K, D)) < 0.3).astype(np.uint8)
        futs = svc.submit_many(3) + [svc.submit(seed=s) for s in seeds]
        res = [f.result(timeout=120) for f in futs]
        stats = svc.stats()
        with pytest.raises(ValueError, match="accompaniment"):
            svc.submit(given=np.zeros((T, K, D)))
    finally:
        svc.close()
    for r in res:
        assert r.roll.shape == (T, K, D) and r.roll.dtype == np.uint8
        assert set(np.unique(r.roll)) <= {0, 1}
        assert 0.0 <= r.queue_s <= r.total_s
    prov = [(r.batch_index, r.row) for r in res]
    assert len(set(prov)) == 5 and all(row < 2 for _, row in prov)
    assert stats["requests"] == 5 and stats["errors"] == 0
    assert stats["batches"] >= 3 and stats["seeded_batches"] >= 1
    assert stats["latency_ms"]["window"] == 5
    # batch i samples under fold_in(PRNGKey(seed), i): the JAX service's key
    b0 = min(bi for bi, _ in prov)
    key = sampling.fold_in(sampling.PRNGKey(4), b0)
    np.testing.assert_array_equal(
        sampling.key_to_seeds(key).numpy(),
        np.asarray(jax_sampling.key_to_seeds(
            jax.random.fold_in(jax.random.PRNGKey(4), b0))))
    direct = svc.generator.generate(key, T, batch=2)
    for r in res:
        if r.batch_index == b0:
            np.testing.assert_array_equal(r.roll, direct[r.row])


def test_service_under_concurrent_submitters():
    """More front-end threads than cores submit plain and seeded requests
    at once, with a short switch interval: every future resolves, no
    (batch, row) is handed out twice, and the request counter loses no
    update."""
    svc = service.GenerationService(_experiment(),
                                    from_jax(_jax_params(2), device="cpu"),
                                    service.ServeConfig(
                                        batch=4, n_steps=2, seed_steps=3,
                                        max_wait_ms=0.5))
    seed = np.zeros((3, K, D), np.uint8)
    seed[:, :, ::3] = 1
    futs, lock = [], threading.Lock()

    def front_end(i):
        for j in range(5):
            f = svc.submit(seed=seed) if (i + j) % 3 == 0 else svc.submit()
            with lock:
                futs.append(f)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=front_end, args=(i,))
                   for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        res = [f.result(timeout=120) for f in futs]
        stats = svc.stats()
    finally:
        sys.setswitchinterval(old)
        svc.close()
    assert len(res) == 80
    assert len({(r.batch_index, r.row) for r in res}) == 80
    assert stats["requests"] == 80 and stats["errors"] == 0
    assert not svc._dispatcher.is_alive() and not svc._drainer.is_alive()


def test_service_refuses_what_is_not_ported():
    tp = from_jax(_jax_params(), device="cpu")
    cfg = _experiment()
    # accompaniment is ported: a service takes accompany_tracks
    acc = service.GenerationService(cfg, tp, service.ServeConfig(
        batch=2, n_steps=T, accompany_tracks=(0,)))
    try:
        assert acc.stats()["accompany_tracks"] == [0]
    finally:
        acc.close()
    # the sparse transport is ported: a service takes it
    sparse = service.GenerationService(cfg, tp, service.ServeConfig(
        batch=2, n_steps=T, transport="sparse"))
    try:
        assert sparse.stats()["transport"] == "sparse"
    finally:
        sparse.close()
    svc = service.GenerationService(cfg, tp, service.ServeConfig(
        batch=2, n_steps=T))
    try:
        with pytest.raises(ValueError, match="seed_steps=0"):
            svc.submit(seed=np.zeros((4, K, D)))
    finally:
        svc.close()
    assert service.auto_batch(cfg, T) == 256


def test_scan_path_matches_jax_scan_in_distribution():
    """fused=False: per-step Gibbs chains on the kernel stream vs JAX's
    scan path on jax.random — same model, so per-track note densities
    agree (B*T*D = 4096 bits per track; tolerance 0.05)."""
    jp = _jax_params(3)
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


NADE_MODEL = dict(MODEL, decoder_type="rnn-nade")


def _nade_jax_params(seed=0):
    return jax_multinn.init(jax.random.PRNGKey(seed),
                            jax_multinn.MultINNConfig(**NADE_MODEL))


def _nade_experiment():
    return dataclasses.replace(_experiment(),
                               model=multinn.MultINNConfig(**NADE_MODEL))


def test_from_jax_round_trip_for_a_nade_model():
    jp = _nade_jax_params()
    tp = from_jax(jp, device="cpu")
    assert dataclasses.asdict(tp.cfg) == dataclasses.asdict(jp.cfg)
    assert type(tp.decoder).__module__.endswith("rnn_nade")
    for name in ("w", "v", "bv", "bh", "wuv", "wuh"):
        got = getattr(tp.decoder, name)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jp.decoder, name)))
    for jc, tc in zip(jp.decoder.cell, tp.decoder.cell):
        for name in ("wx", "wh", "b"):
            np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                          np.asarray(getattr(jc, name)))
    one = multinn.index_tree(tp.decoder, 1)
    np.testing.assert_array_equal(one.v.numpy(), np.asarray(jp.decoder.v[1]))


@pytest.mark.parametrize("seeded", [False, True])
def test_nade_generator_bit_equal_to_jax(seeded):
    jp = _nade_jax_params(1)
    gen = Generator(_nade_experiment(), from_jax(jp, device="cpu"))
    seed_roll = ((np.random.default_rng(3).random((B, 4, K, D)) < 0.3)
                 .astype(np.float32) if seeded else None)
    want = _jax_generation(jp, seed_roll, 12, B)
    got = gen.generate(sampling.PRNGKey(12), T, seed=seed_roll, batch=B)
    assert got.shape == (B, T, K, D) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_nade_service_answers_plain_and_seeded_requests():
    svc = service.GenerationService(
        _nade_experiment(), from_jax(_nade_jax_params(2), device="cpu"),
        service.ServeConfig(batch=2, n_steps=T, seed_steps=3, seed=4,
                            max_wait_ms=1.0))
    try:
        seeds = (np.random.default_rng(6).random((2, 6, K, D)) < 0.3
                 ).astype(np.uint8)
        futs = svc.submit_many(3) + [svc.submit(seed=s) for s in seeds]
        res = [f.result(timeout=120) for f in futs]
        stats = svc.stats()
    finally:
        svc.close()
    for r in res:
        assert r.roll.shape == (T, K, D) and r.roll.dtype == np.uint8
        assert set(np.unique(r.roll)) <= {0, 1}
    prov = [(r.batch_index, r.row) for r in res]
    assert len(set(prov)) == 5
    assert stats["requests"] == 5 and stats["errors"] == 0
    assert stats["seeded_batches"] >= 1
    b0 = min(bi for bi, _ in prov)
    direct = svc.generator.generate(
        sampling.fold_in(sampling.PRNGKey(4), b0), T, batch=2)
    for r in res:
        if r.batch_index == b0:
            np.testing.assert_array_equal(r.roll, direct[r.row])


def test_auto_batch_uses_the_nade_gate():
    cfg = _nade_experiment()
    # the NADE candidates (8, 16, 32, 48, 64, 128), all admitted here
    assert service.auto_batch(cfg, T) == 128
    # the NADE gate refuses more than 8 tracks (the RBM gate would not)
    wide = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, n_tracks=9))
    assert service.auto_batch(wide, T) == 8
    rbm_wide = dataclasses.replace(wide, model=dataclasses.replace(
        wide.model, decoder_type="rnn-rbm"))
    assert service.auto_batch(rbm_wide, T) == 256


def test_port_imports_and_serves_without_jax():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "orbax"):
            sys.modules[name] = None
        import torch
        import multinn_torch
        from multinn_torch.models import multinn
        from multinn_torch.ops import sampling
        from multinn_torch.serving.service import GenerationService, ServeConfig
        from multinn_torch.training.generator import Generator
        from multinn_torch.utils import config
        cfg = config.load_json("configs/synthetic_smoke.json")
        cfg = config.ExperimentConfig(
            model=multinn.MultINNConfig(n_tracks=2, n_pitches=8,
                                        mode="feedback", n_hidden=4,
                                        n_rnn=3, gen_k=2),
            data=config.DataConfig(n_tracks=2, pitch_min=24, pitch_max=31))
        params = multinn.init(cfg.model, torch.Generator().manual_seed(0),
                              device="cpu")
        svc = GenerationService(cfg, params, ServeConfig(batch=2, n_steps=3))
        roll = svc.submit().result(timeout=60).roll
        svc.close()
        assert roll.shape == (3, 2, 8), roll.shape
        assert not [m for m in sys.modules
                    if m.split(".")[0] == "multinn_tpu"], "imported multinn_tpu"
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


def test_no_jax_import_statement_in_the_port():
    pkg = os.path.join(REPO, "multinn_torch")
    offenders = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    for line in fh:
                        words = line.split()
                        if (len(words) > 1 and words[0] in ("import", "from")
                                and words[1].split(".")[0] in (
                                    "jax", "flax", "optax", "orbax")):
                            offenders.append(f"{f}: {line.strip()}")
    assert not offenders, offenders
