"""multinn_torch CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(--noconftest: tests/conftest.py sets up JAX for the rest of the suite).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import (_build, gen_fused_nade,  # noqa: E402
                               gen_fused_rbm, gibbs, kernel_prng, nade_ops,
                               sampling)
from multinn_torch.serving.service import (GenerationService,  # noqa: E402
                                           ServeConfig)
from multinn_torch.utils import config  # noqa: E402

pytestmark = pytest.mark.cuda

FLAGSHIP = dict(n_tracks=5, n_pitches=84, mode="feedback", n_hidden=150,
                n_rnn=100, gen_k=10)
NADE = dict(FLAGSHIP, decoder_type="rnn-nade")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _params(cfg, dev, seed=0):
    params = multinn.init(cfg, torch.Generator().manual_seed(seed))
    return multinn.tree_map(lambda x: x.to(dev), params)


@pytest.mark.parametrize("seed,salt", [(0, 0), (12345, -7),
                                       (-2 ** 31, 2 ** 31 - 1)])
def test_threefry_kernel_bit_equal_to_plain(dev, seed, salt):
    a = kernel_prng.random_bits((4096, 750), seed, salt, dev, impl="cuda")
    b = kernel_prng.random_bits((4096, 750), seed, salt, dev, impl="plain")
    assert torch.equal(a, b)


def test_keys_on_the_card_equal_the_host(dev):
    key = sampling.PRNGKey(3)
    assert torch.equal(sampling.fold_in(key.to(dev), 5).cpu(),
                       sampling.fold_in(key, 5))
    assert torch.equal(sampling.split(key.to(dev), 7).cpu(),
                       sampling.split(key, 7))
    # jax.random.fold_in(jax.random.PRNGKey(3), 5)
    np.testing.assert_array_equal(
        sampling.fold_in(key.to(dev), 5).cpu().numpy(),
        np.array([2464363587, 131619366], np.uint32))


def test_gibbs_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(0)
    n, d, h = 1040, 84, 150
    v0 = (torch.rand(n, d, generator=g) < 0.2).float().to(dev)
    w = (0.1 * torch.randn(d, h, generator=g)).to(dev)
    bv = (0.5 * torch.randn(n, d, generator=g)).to(dev)
    bh = (0.5 * torch.randn(n, h, generator=g)).to(dev)
    key = sampling.PRNGKey(1, device=dev)
    out_k = gibbs.gibbs_chain(key, v0, w, bv, bh, 25)
    out_p = gibbs.gibbs_chain(key, v0, w, bv, bh, 25, impl="plain")
    assert float((out_k != out_p).any(dim=1).float().mean()) <= 0.01


@pytest.mark.parametrize("mode,cell,layers", [
    ("feedback", "lstm", 1), ("per-track", "lstm", 2),
    ("feedback", "vanilla", 2)])
def test_fused_kernel_matches_plain(dev, mode, cell, layers):
    cfg = multinn.MultINNConfig(**dict(FLAGSHIP, mode=mode, cell=cell,
                                       rnn_layers=layers, w_std=0.1))
    params = _params(cfg, dev)
    seed = (torch.rand(8, 16, 5, 84, generator=torch.Generator()
                       .manual_seed(1)) < 0.1).float().to(dev)
    state = multinn.prime(params, multinn.init_state(params, 8), seed)
    key = sampling.PRNGKey(5, device=dev)
    fk, rk = multinn._generate_fused(params, key, state, 16, impl="cuda")
    fp, rp = multinn._generate_fused(params, key, state, 16, impl="plain")
    same = (rk == rp).flatten(1).all(dim=1)
    assert int(same.sum()) >= 7
    for a, b in zip(fk.decoder.cell, fp.decoder.cell):
        assert float((a.h - b.h).abs()[:, same].max()) <= 1e-4


def test_fused_given_merge_on_the_card(dev):
    params = _params(multinn.MultINNConfig(**FLAGSHIP), dev)
    state = multinn.init_state(params, 4)
    h0 = torch.stack([c.h for c in state.decoder.cell])
    c0 = torch.stack([c.c for c in state.decoder.cell])
    given = (torch.rand(4, 32, 5, 84, generator=torch.Generator()
                        .manual_seed(2)) < 0.3).float().to(dev)
    roll, _, _ = gen_fused_rbm.generate_rbm(
        sampling.PRNGKey(0, device=dev), params.decoder, h0, c0,
        state.decoder.v_prev, 32, 10, given=given, given_tracks=(1, 3))
    assert torch.equal(roll[:, :, [1, 3]], given[:, :, [1, 3]])


def test_service_runs_on_the_kernels(dev):
    cfg = config.ExperimentConfig(
        model=multinn.MultINNConfig(**FLAGSHIP),
        data=config.DataConfig(n_tracks=5, pitch_min=24, pitch_max=107),
        generate=config.GenerateConfig(n_steps=64, seed_steps=8))
    params = _params(cfg.model, dev)
    _build.launches.clear()
    svc = GenerationService(cfg, params, ServeConfig(batch=4, n_steps=64,
                                                     seed_steps=8))
    try:
        seed = np.zeros((8, 5, 84), np.uint8)
        seed[:, :, ::7] = 1
        res = [f.result(timeout=300)
               for f in svc.submit_many(5) + [svc.submit(seed=seed)]]
    finally:
        svc.close()
    assert all(r.roll.shape == (64, 5, 84) for r in res)
    assert _build.launches["gen_fused_rbm"] >= 3
    assert _build.launches["threefry2x32"] >= 2


@pytest.mark.parametrize("rows", [1, 8, 1040])
def test_nade_sampler_kernel_matches_plain(dev, rows):
    g = torch.Generator().manual_seed(3)
    d, h = 84, 150
    w = (0.1 * torch.randn(d, h, generator=g)).to(dev)
    v = (0.1 * torch.randn(d, h, generator=g)).to(dev)
    bv = (-1.0 + 0.5 * torch.randn(rows, d, generator=g)).to(dev)
    bh = (0.5 * torch.randn(rows, h, generator=g)).to(dev)
    key = sampling.PRNGKey(2, device=dev)
    _build.launches.clear()
    out_k = nade_ops.nade_sample(key, w, v, bv, bh, (rows,))
    out_p = nade_ops.nade_sample(key, w, v, bv, bh, (rows,), impl="plain")
    assert _build.launches["nade_sample"] == 1
    assert out_k.shape == (rows, d)
    differ = int((out_k != out_p).any(dim=1).sum())
    assert differ <= max(1, rows // 100)
    assert 0.05 < float(out_k.mean()) < 0.95


@pytest.mark.parametrize("mode,cell,layers", [
    ("feedback", "lstm", 1), ("per-track", "lstm", 2),
    ("feedback", "vanilla", 2)])
def test_fused_nade_kernel_matches_plain(dev, mode, cell, layers):
    cfg = multinn.MultINNConfig(**dict(NADE, mode=mode, cell=cell,
                                       rnn_layers=layers, w_std=0.1))
    params = _params(cfg, dev)
    seed = (torch.rand(8, 16, 5, 84, generator=torch.Generator()
                       .manual_seed(1)) < 0.1).float().to(dev)
    state = multinn.prime(params, multinn.init_state(params, 8), seed)
    key = sampling.PRNGKey(5, device=dev)
    fk, rk = multinn._generate_fused(params, key, state, 16, impl="cuda")
    fp, rp = multinn._generate_fused(params, key, state, 16, impl="plain")
    same = (rk == rp).flatten(1).all(dim=1)
    assert int(same.sum()) >= 7
    for a, b in zip(fk.decoder.cell, fp.decoder.cell):
        assert float((a.h - b.h).abs()[:, same].max()) <= 1e-4


def test_fused_nade_given_merge_on_the_card(dev):
    params = _params(multinn.MultINNConfig(**NADE), dev)
    state = multinn.init_state(params, 4)
    h0 = torch.stack([c.h for c in state.decoder.cell])
    c0 = torch.stack([c.c for c in state.decoder.cell])
    given = (torch.rand(4, 32, 5, 84, generator=torch.Generator()
                        .manual_seed(2)) < 0.3).float().to(dev)
    key = sampling.PRNGKey(0, device=dev)
    roll, hk, _ = gen_fused_nade.generate_nade(
        key, params.decoder, h0, c0, state.decoder.v_prev, 32, given=given,
        given_tracks=(1, 3))
    assert torch.equal(roll[:, :, [1, 3]], given[:, :, [1, 3]])
    _, hp, _ = gen_fused_nade.generate_nade(
        key, params.decoder, h0, c0, state.decoder.v_prev, 32, impl="plain",
        given=given, given_tracks=(1, 3))
    assert float((hk - hp).abs()[:, [1, 3]].max()) <= 1e-4


def test_nade_service_and_scan_branch_run_on_the_kernels(dev):
    cfg = config.ExperimentConfig(
        model=multinn.MultINNConfig(**NADE),
        data=config.DataConfig(n_tracks=5, pitch_min=24, pitch_max=107),
        generate=config.GenerateConfig(n_steps=64, seed_steps=8))
    params = _params(cfg.model, dev)
    _build.launches.clear()
    svc = GenerationService(cfg, params, ServeConfig(batch=4, n_steps=64,
                                                     seed_steps=8))
    try:
        seed = np.zeros((8, 5, 84), np.uint8)
        seed[:, :, ::7] = 1
        res = [f.result(timeout=300)
               for f in svc.submit_many(5) + [svc.submit(seed=seed)]]
    finally:
        svc.close()
    assert all(r.roll.shape == (64, 5, 84) for r in res)
    assert _build.launches["gen_fused_nade"] >= 3
    _, roll = multinn.generate(params, sampling.PRNGKey(1, device=dev),
                               multinn.init_state(params, 2), 4, fused=False)
    assert roll.shape == (2, 4, 5, 84)
    assert _build.launches["nade_sample"] == 4 * 5
