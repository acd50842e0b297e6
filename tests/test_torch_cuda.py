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
from multinn_torch.ops import (_build, gen_common,  # noqa: E402
                               gen_fused_nade, gen_fused_rbm, gibbs,
                               gibbs_cuda, kernel_prng, nade_ll, nade_ops,
                               sampling)
from multinn_torch.serving.service import (GenerationService,  # noqa: E402
                                           ServeConfig)
from multinn_torch.utils import config  # noqa: E402

pytestmark = pytest.mark.cuda

FLAGSHIP = dict(n_tracks=5, n_pitches=84, mode="feedback", n_hidden=150,
                n_rnn=100, gen_k=10)
NADE = dict(FLAGSHIP, decoder_type="rnn-nade")
# the two shipped DBN configs' models (configs/lpd5_*.json)
DBN_NADE = dict(NADE, encoder_hidden=(64,))
DBN_RBM = dict(FLAGSHIP, mode="per-track", encoder_hidden=(64,), gen_k=25)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _params(cfg, dev, seed=0):
    return multinn.init(cfg, torch.Generator().manual_seed(seed), device=dev)


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


def _sampler_inputs(dev, rows, d=84, h=150, seed=3, bias=-1.0):
    g = torch.Generator().manual_seed(seed)
    w = (0.1 * torch.randn(d, h, generator=g)).to(dev)
    v = (0.1 * torch.randn(d, h, generator=g)).to(dev)
    bv = (bias + 0.5 * torch.randn(rows, d, generator=g)).to(dev)
    bh = (0.5 * torch.randn(rows, h, generator=g)).to(dev)
    return w, v, bv, bh


@pytest.mark.parametrize("rows,d,h", [(1, 84, 150), (8, 84, 150),
                                      (256, 84, 150), (1040, 84, 150),
                                      (8, 168, 400), (256, 168, 400)])
def test_nade_sampler_kernel_matches_plain(dev, rows, d, h):
    """One row, the scan path's 8 rows, many CTAs of one row each (256 and
    1040 rows, more than a wave), and a (D, H) whose W and V exceed shared
    memory (read from L2): at most one row in a hundred differs (a draw flips only where a uniform lands within the
    last ulp of its probability)."""
    w, v, bv, bh = _sampler_inputs(dev, rows, d, h)
    key = sampling.PRNGKey(2, device=dev)
    _build.launches.clear()
    out_k = nade_ops.nade_sample(key, w, v, bv, bh, (rows,))
    out_p = nade_ops.nade_sample(key, w, v, bv, bh, (rows,), impl="plain")
    assert _build.launches["nade_sample"] == 1
    assert out_k.shape == (rows, d)
    differ = int((out_k != out_p).any(dim=1).sum())
    assert differ <= max(1, rows // 100)
    assert 0.05 < float(out_k.mean()) < 0.95


@pytest.mark.parametrize("staged", [1, 0])
@pytest.mark.parametrize("bias", [-1.0, -3.0])
def test_nade_sampler_each_plan_matches_plain(dev, staged, bias):
    """W and V staged or read from L2, at a density near 0.27 (bv about -1)
    and near 0.06 (bv about -3): the same draws as the serial plain sweep,
    and the same bits on a replay."""
    from multinn_torch.ops import nade_cuda
    w, v, bv, bh = _sampler_inputs(dev, 64, seed=4, bias=bias)
    key = sampling.PRNGKey(5, device=dev)
    out_k = nade_cuda._launch(key, w, v, bv, bh, (64,), staged)
    out_p = nade_cuda.nade_sample_plain(key, w, v, bv, bh, (64,))
    assert int((out_k != out_p).any(dim=1).sum()) <= 1
    assert torch.equal(out_k, nade_cuda._launch(key, w, v, bv, bh, (64,),
                                                staged))
    assert 0.01 < float(out_k.mean()) < 0.5


def test_nade_sampler_misaligned_weights(dev):
    """An offset view of W (not 16-byte aligned) runs from L2 on the
    kernel and matches the plain version; the launcher refuses a staged
    plan on it rather than run another plan than it was given."""
    from multinn_torch.ops import nade_cuda
    w, v, bv, bh = _sampler_inputs(dev, 8)
    w_off = torch.empty(w.numel() + 1, device=dev)[1:].view_as(w).copy_(w)
    assert w_off.data_ptr() % 16
    key = sampling.PRNGKey(2, device=dev)
    _build.launches.clear()
    out_k = nade_cuda.nade_sample(key, w_off, v, bv, bh, (8,))
    assert _build.launches["nade_sample"] == 1
    out_p = nade_cuda.nade_sample_plain(key, w, v, bv, bh, (8,))
    assert int((out_k != out_p).any(dim=1).sum()) <= 1
    with pytest.raises(RuntimeError, match="16-byte aligned"):
        nade_cuda._launch(key, w_off, v, bv, bh, (8,), 1)


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


@pytest.mark.parametrize("mode,batch,n_steps", [
    ("feedback", 1, 64), ("feedback", 8, 32), ("feedback", 32, 16),
    ("feedback", 64, 16), ("feedback", 256, 4), ("per-track", 8, 32),
    ("joint", 1, 16)])
def test_fused_nade_depths_are_bit_identical(dev, mode, batch, n_steps):
    """The speculative sweep at depths 2 and 4 returns depth 1's roll, h
    and c bit for bit: through teams of warps where the launch's groups
    per CTA leave them (B=1 and 8: quads and pairs; B=32: two quad teams a
    CTA; B=64: pairs) and on one warp per group where they do not (B=64
    quads, B=256); the transposed butterfly's sums are warp_allsum's. The
    auto depth the launcher's plan reports: 4 where a CTA holds one
    group."""
    params = _params(multinn.MultINNConfig(**dict(NADE, mode=mode,
                                                  w_std=0.1)), dev)
    seed = (torch.rand(batch, 16, 5, 84, generator=torch.Generator()
                       .manual_seed(3)) < 0.2).float().to(dev)
    state = multinn.prime(params, multinn.init_state(params, batch), seed)
    h0 = torch.stack([c.h for c in state.decoder.cell])
    c0 = torch.stack([c.c for c in state.decoder.cell])
    key = sampling.PRNGKey(7, device=dev)
    _build.launches.clear()
    outs = [gen_fused_nade.generate_nade(key, params.decoder, h0, c0,
                                         state.decoder.v_prev, n_steps,
                                         spec=s) for s in (1, 2, 4, None)]
    assert _build.launches["gen_fused_nade"] == 4
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)
    assert 0.01 < float(outs[0][0].mean()) < 0.99
    # 22 clusters of 5 CTAs (132 of 1, joint) hold 1, 2, 3 and 12 samples
    assert gen_fused_nade.auto_depth(params.decoder, batch) == (
        4 if batch <= 8 else 1)


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


# the cluster split: K in {1, 4, 5, 8} for both families and K=12 (two
# tracks per CTA) for the RBM; per-track, hybrid and feedback modes; L=2
CLUSTER_CASES = [("rnn-rbm", 1, "per-track", 1), ("rnn-rbm", 5, "hybrid", 1),
                 ("rnn-rbm", 8, "feedback", 2), ("rnn-rbm", 12, "feedback", 1),
                 ("rnn-nade", 1, "per-track", 2),
                 ("rnn-nade", 5, "hybrid", 1), ("rnn-nade", 8, "feedback", 2),
                 ("rnn-rbm", 4, "feedback", 1), ("rnn-nade", 4, "feedback", 1)]


def _cluster_model(family, n_tracks, mode="feedback", layers=1):
    return multinn.MultINNConfig(
        n_tracks=n_tracks, n_pitches=84, mode=mode, decoder_type=family,
        n_hidden=150, n_rnn=100, rnn_layers=layers, gen_k=10, w_std=0.1)


def _primed(params, batch, dev, seed=1):
    k, d = params.cfg.n_tracks, params.cfg.n_pitches
    roll = (torch.rand(batch, 16, k, d, generator=torch.Generator()
                       .manual_seed(seed)) < 0.1).float().to(dev)
    return multinn.prime(params, multinn.init_state(params, batch), roll)


def _identical_samples(rk, rp):
    return (rk == rp).flatten(1).all(dim=1)


@pytest.mark.parametrize("family,n_tracks,mode,layers", CLUSTER_CASES)
def test_cluster_kernels_match_plain(dev, family, n_tracks, mode, layers):
    """At least 7 of 8 samples identical at T=16 (a sample diverges only
    after a last-ulp difference in a probability flips a draw) and the
    final h within 1e-4 on those."""
    params = _params(_cluster_model(family, n_tracks, mode, layers), dev)
    state = _primed(params, 8, dev)
    key = sampling.PRNGKey(5, device=dev)
    _build.launches.clear()
    fk, rk = multinn._generate_fused(params, key, state, 16, impl="cuda")
    fp, rp = multinn._generate_fused(params, key, state, 16, impl="plain")
    assert _build.launches[{"rnn-rbm": "gen_fused_rbm",
                            "rnn-nade": "gen_fused_nade"}[family]] == 1
    same = _identical_samples(rk, rp)
    assert int(same.sum()) >= 7
    for a, b in zip(fk.decoder.cell, fp.decoder.cell):
        assert float((a.h - b.h).abs()[:, same].max()) <= 1e-4
    assert 0.0 < float(rk.mean()) < 1.0


@pytest.mark.parametrize("family", ["rnn-rbm", "rnn-nade"])
def test_cluster_given_merge_matches_plain(dev, family):
    """Given tracks 1 and 3 take the given frames; the sampled tracks and
    the final state follow the plain version's."""
    params = _params(_cluster_model(family, 5), dev)
    state = _primed(params, 8, dev)
    h0 = torch.stack([c.h for c in state.decoder.cell])
    c0 = torch.stack([c.c for c in state.decoder.cell])
    given = (torch.rand(8, 16, 5, 84, generator=torch.Generator()
                        .manual_seed(2)) < 0.3).float().to(dev)
    key = sampling.PRNGKey(4, device=dev)
    fn = (gen_fused_rbm.generate_rbm if family == "rnn-rbm" else
          gen_fused_nade.generate_nade)
    extra = (10,) if family == "rnn-rbm" else ()
    out = {impl: fn(key, params.decoder, h0, c0, state.decoder.v_prev, 16,
                    *extra, impl=impl, given=given, given_tracks=(1, 3))
           for impl in ("cuda", "plain")}
    rk, hk, _ = out["cuda"]
    rp, hp, _ = out["plain"]
    assert torch.equal(rk[:, :, [1, 3]], given[:, :, [1, 3]])
    same = _identical_samples(rk, rp)
    assert int(same.sum()) >= 7
    assert float((hk - hp).abs()[:, :, same].max()) <= 1e-4


@pytest.mark.parametrize("family", ["rnn-rbm", "rnn-nade"])
def test_cluster_runs_several_samples_per_cluster(dev, family):
    """B=300 is more samples than the card holds clusters, so clusters run
    several samples each, the last cluster fewer; every sample must index
    its own state, stream and roll rows: at least 99 % of the samples
    identical to the plain version at T=8 (a fault in one sample slot
    would break about one in twelve), and the final h within 1e-4 on
    those."""
    params = _params(_cluster_model(family, 5), dev)
    state = _primed(params, 300, dev, seed=3)
    key = sampling.PRNGKey(6, device=dev)
    fk, rk = multinn._generate_fused(params, key, state, 8, impl="cuda")
    fp, rp = multinn._generate_fused(params, key, state, 8, impl="plain")
    same = _identical_samples(rk, rp)
    assert int(same.sum()) >= 297
    for a, b in zip(fk.decoder.cell, fp.decoder.cell):
        assert float((a.h - b.h).abs()[:, same].max()) <= 1e-4


@pytest.mark.parametrize("family", ["rnn-rbm", "rnn-nade"])
def test_cluster_replay_is_bit_equal(dev, family):
    """No float atomics: the same launch twice gives the same bits."""
    params = _params(_cluster_model(family, 5), dev)
    state = _primed(params, 8, dev)
    key = sampling.PRNGKey(7, device=dev)
    (f1, r1), (f2, r2) = (multinn._generate_fused(params, key, state, 32,
                                                  impl="cuda")
                          for _ in range(2))
    assert torch.equal(r1, r2)
    for a, b in zip(f1.decoder.cell, f2.decoder.cell):
        assert torch.equal(a.h, b.h) and torch.equal(a.c, b.c)


PLAN_FIELDS = ("cluster", "tpc", "w_smem", "weight_bytes", "sample_bytes",
               "max_samples", "samples", "grid", "clusters")

# (family, K, H, U; CTAs per cluster, track slots per CTA, the per-step
# weight matrices in shared memory by bit — RBM: W, Wuh, Wuv; NADE: V, W,
# Wuh, Wuv — their bytes, the most samples a CTA holds)
PLAN_CASES = [
    ("rnn-rbm", 1, 150, 100, 1, 1, 0b111, 144336, 21),
    ("rnn-rbm", 5, 150, 100, 5, 1, 0b111, 144336, 14),
    ("rnn-rbm", 8, 150, 100, 8, 1, 0b111, 144336, 11),
    ("rnn-rbm", 9, 150, 100, 8, 2, 0b101, 168672, 5),
    ("rnn-rbm", 12, 150, 100, 8, 2, 0b101, 168672, 4),
    ("rnn-rbm", 31, 150, 100, 8, 4, 0b100, 134400, 3),
    ("rnn-rbm", 5, 200, 150, 5, 1, 0b011, 187536, 6),
    ("rnn-nade", 1, 150, 100, 1, 1, 0b1111, 127200, 27),
    ("rnn-nade", 5, 150, 100, 5, 1, 0b1111, 127200, 18),
    ("rnn-nade", 8, 256, 100, 8, 1, 0b1111, 205216, 3),
    ("rnn-nade", 5, 150, 256, 5, 1, 0b0111, 204000, 2),
    ("rnn-nade", 5, 256, 400, 5, 1, 0b1011, 153216, 6)]


def _launch_plan(cfg, batch):
    """The plan the family's kernel makes at launch (csrc/gen_cluster.cuh),
    read through the gen_fused_plan op, which launches nothing."""
    k, d = gen_common._eff_dims(cfg)
    return dict(zip(PLAN_FIELDS, _build.ops().gen_fused_plan(
        int(cfg.decoder_type == "rnn-nade"), k, d, cfg.n_hidden, cfg.n_rnn,
        cfg.rnn_layers, int(cfg.cell == "lstm"), batch)))


def _gate_sample_bytes(cfg):
    """One sample's shared memory as the dispatch gate counts it."""
    from multinn_torch.models import rnn_nade, rnn_rbm
    rbm = cfg.decoder_type == "rnn-rbm"
    params = gen_common._decoder_param_shapes(cfg, rnn_rbm if rbm
                                              else rnn_nade)
    st = torch.empty((cfg.rnn_layers, cfg.n_tracks, 1, cfg.n_rnn),
                     device="meta")
    v0 = torch.empty((cfg.n_tracks, 1, cfg.n_pitches), device="meta")
    if rbm:
        return gen_fused_rbm._sample_bytes(
            gen_fused_rbm._rbm_args(params, st, st, v0))
    return gen_fused_nade._sample_bytes(
        gen_fused_nade._nade_args(params, st, st, v0))


@pytest.mark.parametrize(
    "family,n_tracks,n_hidden,n_rnn,cluster,tpc,w_smem,weight_bytes,s_max",
    PLAN_CASES)
def test_launch_plan(dev, family, n_tracks, n_hidden, n_rnn, cluster, tpc,
                     w_smem, weight_bytes, s_max):
    """C = min(K, 8) CTAs per cluster, CTA r owning tracks r, r + C, ...;
    the per-step weight matrices go to shared memory in priority order
    while they fit beside one sample's state, the rest are read from
    global memory; one sample's state is the count the dispatch gate
    makes; S = ceil(B / the clusters the card holds at once) samples per
    cluster, within what the shared memory holds, and ceil(B / S)
    clusters, so the flagship's B=256 runs in one wave."""
    cfg = multinn.MultINNConfig(
        n_tracks=n_tracks, n_pitches=84, mode="per-track",
        decoder_type=family, n_hidden=n_hidden, n_rnn=n_rnn, gen_k=10)
    limit = gen_common.SMEM_LIMIT_BYTES
    for batch in (1, 8, 64, 256, 300, 4096):
        p = _launch_plan(cfg, batch)
        assert ((p["cluster"], p["tpc"], p["w_smem"], p["weight_bytes"],
                 p["max_samples"])
                == (cluster, tpc, w_smem, weight_bytes, s_max))
        assert p["sample_bytes"] == _gate_sample_bytes(cfg)
        assert (weight_bytes + s_max * p["sample_bytes"] <= limit
                < weight_bytes + (s_max + 1) * p["sample_bytes"])
        assert p["clusters"] >= 1
        assert p["samples"] == max(1, min(s_max,
                                          -(-batch // p["clusters"])))
        assert p["grid"] == -(-batch // p["samples"])
    if (n_tracks, n_hidden, n_rnn) == (5, 150, 100):
        p = _launch_plan(cfg, 256)
        assert p["grid"] <= p["clusters"]


# the bf16 capacity modes' plans: (family, K, H, U; the matrices in shared
# memory, their bytes, the most samples a CTA holds). RBM: W at a pitch of
# 2 mod 4 elements (150 -> 150, 200 -> 202), Wuh, Wuv in bf16; NADE: Wuh
# in bf16 beside the always-bf16 V, W and Wuv.
CAPACITY_PLAN_CASES = [
    ("rnn-rbm", 5, 150, 100, 0b111, 25200 + 30000 + 16800, 26),
    ("rnn-rbm", 5, 200, 150, 0b111, 33936 + 60000 + 25200, 16),
    ("rnn-nade", 5, 150, 100, 0b1111, 25200 + 25200 + 30000 + 16800, 23)]


@pytest.mark.parametrize(
    "family,n_tracks,n_hidden,n_rnn,w_smem,weight_bytes,s_max",
    CAPACITY_PLAN_CASES)
def test_launch_plan_capacity_modes(dev, family, n_tracks, n_hidden, n_rnn,
                                    w_smem, weight_bytes, s_max):
    """In bf16 the per-step matrices take half their bytes: the Lakh
    config's three fit a CTA (only W and Wuh in f32), and every CTA holds
    more samples; one sample's state is the same count as in f32."""
    cfg = multinn.MultINNConfig(
        n_tracks=n_tracks, n_pitches=84, mode="feedback",
        decoder_type=family, n_hidden=n_hidden, n_rnn=n_rnn, gen_k=10)
    k, d = gen_common._eff_dims(cfg)
    for batch in (1, 64, 256):
        p = dict(zip(PLAN_FIELDS, _build.ops().gen_fused_plan(
            int(family == "rnn-nade"), k, d, n_hidden, n_rnn, 1, 1, batch,
            1)))
        assert (p["w_smem"], p["weight_bytes"], p["max_samples"]) == (
            w_smem, weight_bytes, s_max)
        assert p["sample_bytes"] == _gate_sample_bytes(cfg)
        assert p["max_samples"] > _launch_plan(cfg, batch)["max_samples"]


# (family, model, batch): the flagship RBM at a serving batch where the
# reference stores bf16, the Lakh config, two layers (wx_r in the NADE's
# aux mode), the NADE flagship
CAPACITY_CASES = [("rnn-rbm", FLAGSHIP, 8), ("rnn-rbm", dict(
    FLAGSHIP, n_hidden=200, n_rnn=150, gen_k=25), 8),
    ("rnn-rbm", dict(FLAGSHIP, rnn_layers=2), 8), ("rnn-nade", NADE, 8),
    ("rnn-nade", dict(NADE, rnn_layers=2), 8)]


@pytest.mark.parametrize("family,model,batch", CAPACITY_CASES)
def test_capacity_modes_match_plain(dev, family, model, batch):
    """The bf16 mode's kernel against its plain version: at least 7 of 8
    samples identical at T=16, the final h within 1e-4 on those; and the
    mode's roll is not the f32 mode's (the storage reaches the kernel)."""
    params = _params(multinn.MultINNConfig(**model), dev)
    state = _primed(params, batch, dev)
    h0 = torch.stack([c.h for c in state.decoder.cell])
    c0 = torch.stack([c.c for c in state.decoder.cell])
    key = sampling.PRNGKey(9, device=dev)
    if family == "rnn-rbm":
        def run(impl, dtype):
            return gen_fused_rbm.generate_rbm(
                key, params.decoder, h0, c0, state.decoder.v_prev, 16,
                params.cfg.gen_k, impl=impl, wdtype=dtype)
    else:
        def run(impl, dtype):
            return gen_fused_nade.generate_nade(
                key, params.decoder, h0, c0, state.decoder.v_prev, 16,
                impl=impl, aux_dtype=dtype)
    _build.launches.clear()
    rk, hk, _ = run("cuda", torch.bfloat16)
    assert sum(_build.launches.values()) == 1
    rp, hp, _ = run("plain", torch.bfloat16)
    same = _identical_samples(rk, rp)
    assert int(same.sum()) >= 7
    assert float((hk - hp).abs()[:, :, same].max()) <= 1e-4
    _, h32, _ = run("cuda", torch.float32)
    assert not torch.equal(h32, hk)


def test_capacity_mode_refuses_mixed_storage(dev):
    """A launch takes one storage per weight group: a bf16 W beside f32
    Wuv, Wuh and Wctx raises; it is never converted in silence."""
    params = _params(multinn.MultINNConfig(**FLAGSHIP), dev)
    state = _primed(params, 2, dev)
    h0 = torch.stack([c.h for c in state.decoder.cell])
    args = gen_fused_rbm._rbm_args(params.decoder, h0, h0.clone(),
                                   state.decoder.v_prev)
    args = args._replace(w=args.w.to(torch.bfloat16))
    seeds = sampling.key_to_seeds(sampling.PRNGKey(0, device=dev))
    with pytest.raises(RuntimeError, match="wuv"):
        gen_fused_rbm._generate_cuda(seeds.to(dev), args, 2, 2, True, None,
                                     (), (0, 2))


def _ll_inputs(dev, k, n, d=84, h=150, seed=4):
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(k, n, d, generator=g) < 0.1).float()
    w = 0.1 * torch.randn(k, d, h, generator=g)
    v = 0.1 * torch.randn(k, d, h, generator=g)
    bv = -1.0 + 0.5 * torch.randn(k, n, d, generator=g)
    bh = 0.5 * torch.randn(k, n, h, generator=g)
    cot = torch.randn(k, n, d, generator=g)
    return [t.to(dev) for t in (x, w, v, bv, bh, cot)]


def _within(a, b):
    """The stated backward tolerance: 1e-4 * max|ref| + 1e-5."""
    return float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-5


@pytest.mark.parametrize("k,n", [(1, 1037), (5, 1037), (5, 4096)])
def test_nade_ll_kernels_match_plain(dev, k, n):
    """Ragged N (1037 = 32 * 32 + 13) and the training shape."""
    x, w, v, bv, bh, cot = _ll_inputs(dev, k, n)
    _build.launches.clear()
    lk, ak = nade_ll.nade_ll_fwd(x, w, v, bv, bh)
    lp, ap = nade_ll.nade_ll_fwd_plain(x, w, v, bv, bh)
    assert float((lk - lp).abs().max()) <= 1e-4
    assert _within(ak, ap)
    for want_dx in (True, False):
        got = nade_ll.nade_ll_bwd(x, w, v, cot, ak, want_dx)
        want = nade_ll.nade_ll_bwd_plain(x, w, v, cot, ap, want_dx)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if b is not None:
                assert _within(a, b)
    assert _build.launches["nade_ll_fwd"] == 1
    assert _build.launches["nade_ll_bwd"] == 2


def test_nade_ll_function_on_the_card_and_replay_is_bit_equal(dev):
    """The autograd Function through the kernels equals its plain path, and
    a replay gives the same gradients bit for bit (no float atomics)."""
    x, w, v, bv, bh, cot = _ll_inputs(dev, 5, 777)

    def grads(impl):
        ts = [t.clone().requires_grad_(True) for t in (x, w, v, bv, bh)]
        out = nade_ll.nade_logits(*ts, impl=impl)
        return [out.detach()] + list(torch.autograd.grad(out, ts, cot))

    first, again, plain = grads("cuda"), grads("cuda"), grads("plain")
    for a, b, p in zip(first, again, plain):
        assert torch.equal(a, b)
        assert _within(a, p)


@pytest.mark.parametrize("d,h", [(2000, 150)])
def test_nade_ll_refused_launch_raises(dev, d, h):
    """D=2000 needs 320 KB of the backward's shared memory even with one
    hidden lane, over the card's 227 KB: the wrapper raises before any
    launch instead of returning what the output buffers held."""
    x, w, v, bv, bh, cot = _ll_inputs(dev, 1, 40, d=d, h=h)
    _, a_end = nade_ll.nade_ll_fwd(x, w, v, bv, bh)
    _build.launches.clear()
    with pytest.raises(ValueError, match="227 KB"):
        nade_ll.nade_ll_bwd(x, w, v, cot, a_end)
    assert not _build.launches["nade_ll_bwd"]


@pytest.mark.parametrize("want_dx", [True, False])
@pytest.mark.parametrize("d,h", [(84, 600), (420, 150)])
def test_nade_ll_kernels_take_wide_shapes(dev, d, h, want_dx):
    """H=600 (two backward chunks of 300 lanes, three forward chunks of
    200) and D=420 (the joint width: three backward chunks of 50 lanes) run
    on the kernels and match the plain versions: logits within 1e-4, every
    gradient within 1e-4 * max|ref| + 1e-5, and a replay bit-equal."""
    x, w, v, bv, bh, cot = _ll_inputs(dev, 2, 300, d=d, h=h, seed=7)
    _build.launches.clear()
    lk, ak = nade_ll.nade_ll_fwd(x, w, v, bv, bh)
    lp, ap = nade_ll.nade_ll_fwd_plain(x, w, v, bv, bh)
    assert float((lk - lp).abs().max()) <= 1e-4
    assert _within(ak, ap)
    got = nade_ll.nade_ll_bwd(x, w, v, cot, ak, want_dx)
    want = nade_ll.nade_ll_bwd_plain(x, w, v, cot, ap, want_dx)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            assert _within(a, b)
    again = nade_ll.nade_ll_bwd(x, w, v, cot, ak, want_dx)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(lk, nade_ll.nade_ll_fwd(x, w, v, bv, bh)[0])
    assert _build.launches["nade_ll_fwd"] == 2
    assert _build.launches["nade_ll_bwd"] == 2


@pytest.mark.parametrize("x_kind", ["zeros", "ones", "general"])
@pytest.mark.parametrize("d", [1, 84, 420])
@pytest.mark.parametrize("h", [1, 31, 150, 600])
def test_nade_ll_fwd_matches_plain(dev, h, d, x_kind):
    """The forward at ragged N (777 = 24 * 32 + 9), H from one lane to
    three chunks, D from 1 to the joint width, with x all zeros (no
    sigmoid after the first), all ones (every row refreshed at every dim)
    and non-binary (the general update read from x): logits within 1e-4,
    a_D within the stated tolerance."""
    x, w, v, bv, bh, _ = _ll_inputs(dev, 2, 777, d=d, h=h, seed=8)
    if x_kind == "zeros":
        x = torch.zeros_like(x)
    elif x_kind == "ones":
        x = torch.ones_like(x)
    else:
        x = x * torch.linspace(0.5, 2.0, d, device=dev) - 0.25 * (x == 0)
    lk, ak = nade_ll.nade_ll_fwd(x, w, v, bv, bh)
    lp, ap = nade_ll.nade_ll_fwd_plain(x, w, v, bv, bh)
    assert float((lk - lp).abs().max()) <= 1e-4
    assert _within(ak, ap)


def test_gibbs_kernel_at_the_training_shape(dev):
    """The CD-1 chain: N = B*T = 1024 rows per track, k=1."""
    g = torch.Generator().manual_seed(6)
    n, d, h = 1024, 84, 150
    v0 = (torch.rand(n, d, generator=g) < 0.06).float().to(dev)
    w = (0.1 * torch.randn(d, h, generator=g)).to(dev)
    bv = (-1.0 + 0.5 * torch.randn(n, d, generator=g)).to(dev)
    bh = (0.5 * torch.randn(n, h, generator=g)).to(dev)
    key = sampling.PRNGKey(3, device=dev)
    out_k = gibbs.gibbs_chain(key, v0, w, bv, bh, 1)
    out_p = gibbs.gibbs_chain(key, v0, w, bv, bh, 1, impl="plain")
    assert float((out_k != out_p).any(dim=1).float().mean()) <= 0.01


@pytest.mark.parametrize("model", [FLAGSHIP, NADE])
def test_training_loss_gradients_kernel_vs_plain(dev, model):
    """multinn.loss at the flagship widths (B=4, T=16): the gradients
    through the kernels equal the plain versions' (the RBM draws the same
    chain stream; a flipped draw would show as a large difference)."""
    params = _params(multinn.MultINNConfig(**model), dev)
    leaves = multinn.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    x = (torch.rand(4, 16, 5, 84, generator=torch.Generator()
                    .manual_seed(7)) < 0.06).float().to(dev)
    key = sampling.PRNGKey(9, device=dev)
    out = {}
    for impl in ("cuda", "plain"):
        loss, _ = multinn.loss(params, key, x, detailed=False, impl=impl)
        out[impl] = [loss.detach()] + list(torch.autograd.grad(loss, leaves))
    for a, b in zip(out["cuda"], out["plain"]):
        assert _within(a, b)


def _gibbs_inputs(dev, n, seed=8, d=84, h=150):
    g = torch.Generator().manual_seed(seed)
    v0 = (torch.rand(n, d, generator=g) < 0.2).float().to(dev)
    w = (0.1 * torch.randn(d, h, generator=g)).to(dev)
    bv = (-1.0 + 0.5 * torch.randn(n, d, generator=g)).to(dev)
    bh = (0.5 * torch.randn(n, h, generator=g)).to(dev)
    return v0, w, bv, bh


def _rows_differing(a, b):
    return int((a != b).any(dim=1).sum())


@pytest.mark.parametrize("k", [1, 10, 25])
@pytest.mark.parametrize("n", [1, 8, 13, 1024, 1040, 4096, 4109])
def test_gibbs_kernel_matches_plain_under_both_plans(dev, n, k):
    """Both launch plans (the latency plan up to 4 rows per SM, the
    throughput plan beyond; 4109 rows straddle a 1024-row stream block and
    end in a partial warp): at most 1 % of rows differ from the plain
    version, at most one where N <= 13 (a row differs only after a
    last-ulp difference in a probability flips a draw)."""
    args = _gibbs_inputs(dev, n)
    key = sampling.PRNGKey(n + k, device=dev)
    _build.launches.clear()
    out_k = gibbs.gibbs_chain(key, *args, k)
    out_p = gibbs.gibbs_chain(key, *args, k, impl="plain")
    assert _build.launches["gibbs_chain"] == 1
    assert out_k.shape == (n, 84)
    assert torch.isin(out_k, torch.tensor([0.0, 1.0], device=dev)).all()
    limit = 1 if n <= 13 else n // 100
    assert _rows_differing(out_k, out_p) <= limit


@pytest.mark.parametrize("plan", [gibbs_cuda.LATENCY_PLAN, (8, 256, 1, 1),
                                  (16, 256, 1, 1), (8, 256, 1, 0),
                                  (16, 256, 1, 0)])
def test_gibbs_every_plan_matches_plain(dev, plan):
    """Each plan the kernel takes, forced at one row count (600 rows, 10
    sweeps), W in shared or in device memory, draws the plain version's
    chain."""
    args = _gibbs_inputs(dev, 600, seed=9)
    key = sampling.PRNGKey(4, device=dev)
    out_k = gibbs_cuda._launch(key, *args, 10, plan)
    out_p = gibbs.gibbs_chain(key, *args, 10, impl="plain")
    assert _rows_differing(out_k, out_p) <= 6


@pytest.mark.parametrize("n,d,h", [(8, 84, 600), (64, 84, 600),
                                   (1024, 84, 600), (4096, 84, 600),
                                   (8, 168, 400), (1040, 168, 400)])
def test_gibbs_wide_rbm_matches_plain(dev, n, d, h):
    """RBMs whose W does not fit beside the rows in shared memory run (the
    device-memory plan at N=4096, (84, 600) and at (168, 400)) and draw the
    plain version's chain: at most 1 % of rows differ, one at N <= 64."""
    args = _gibbs_inputs(dev, n, seed=12, d=d, h=h)
    key = sampling.PRNGKey(6, device=dev)
    _build.launches.clear()
    out_k = gibbs.gibbs_chain(key, *args, 5)
    out_p = gibbs.gibbs_chain(key, *args, 5, impl="plain")
    assert _build.launches["gibbs_chain"] == 1
    assert _rows_differing(out_k, out_p) <= max(1, n // 100)
    assert torch.equal(out_k, gibbs.gibbs_chain(key, *args, 5))


@pytest.mark.parametrize("n", [8, 4109])
def test_gibbs_replay_is_bit_equal(dev, n):
    args = _gibbs_inputs(dev, n, seed=10)
    key = sampling.PRNGKey(11, device=dev)
    assert torch.equal(gibbs.gibbs_chain(key, *args, 25),
                       gibbs.gibbs_chain(key, *args, 25))


@pytest.mark.parametrize("want_dx", [True, False])
@pytest.mark.parametrize("k,n", [(1, 40), (5, 40), (1, 1037), (5, 1037),
                                 (1, 4096), (5, 4096), (1, 5000), (5, 5000)])
def test_nade_ll_bwd_matches_plain(dev, k, n, want_dx):
    """The persistent backward at N=40 (fewer tiles than CTA slots), ragged
    N and the training shape: every output within 1e-4 * max|ref| + 1e-5
    of the plain version, and a replay bit-equal."""
    x, w, v, bv, bh, cot = _ll_inputs(dev, k, n, seed=5)
    _, a_end = nade_ll.nade_ll_fwd_plain(x, w, v, bv, bh)
    got = nade_ll.nade_ll_bwd(x, w, v, cot, a_end, want_dx)
    want = nade_ll.nade_ll_bwd_plain(x, w, v, cot, a_end, want_dx)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            assert _within(a, b)
    again = nade_ll.nade_ll_bwd(x, w, v, cot, a_end, want_dx)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


def test_nade_ll_bwd_takes_x_that_is_not_binary(dev):
    """x outside {0, 1} takes the general downdate; the result still
    equals the plain version's."""
    x, w, v, bv, bh, cot = _ll_inputs(dev, 2, 300, seed=6)
    x = x * torch.linspace(0.5, 2.0, 84, device=dev)
    _, a_end = nade_ll.nade_ll_fwd_plain(x, w, v, bv, bh)
    got = nade_ll.nade_ll_bwd(x, w, v, cot, a_end)
    want = nade_ll.nade_ll_bwd_plain(x, w, v, cot, a_end)
    for a, b in zip(got, want):
        assert _within(a, b)


def _group_trainers(dev, model, tmp_path, n=4, mesh=None):
    """Two trainers from the same params on the card, one replaying its
    groups of n steps from a CUDA graph and one running them eagerly
    (on ``mesh``, a MeshConfig, when given)."""
    from multinn_torch.training.trainer import Trainer
    data = config.DataConfig.from_preset("synthetic", window=16, batch_size=4,
                                         synthetic_songs=12,
                                         synthetic_steps=64)
    params = _params(multinn.MultINNConfig(**model), dev)
    out = []
    for name in ("graph", "eager"):
        cfg = config.ExperimentConfig(
            data=data, model=multinn.MultINNConfig(**model),
            mesh=mesh or config.MeshConfig(),
            train=config.TrainConfig(steps_per_call=n,
                                     run_dir=str(tmp_path / name)))
        out.append(Trainer(cfg, params=params))
    out[1].capture_groups = False
    assert out[0].capture_groups
    batches = np.stack(list(out[0].dataset.batches("train", epoch=0)))
    return out, [batches[i * n:(i + 1) * n] for i in range(2)]


def _params_close(a, b):
    """Equal within 1e-6 max|p| per leaf; returns the largest difference."""
    worst = 0.0
    for x, y in zip(a._leaves, b._leaves):
        diff = float((x - y).detach().abs().max())
        assert diff <= 1e-6 * float(y.detach().abs().max()), diff
        worst = max(worst, diff)
    return worst


@pytest.mark.parametrize("model", [FLAGSHIP, NADE, DBN_NADE, DBN_RBM])
def test_graph_groups_equal_eager_groups(dev, model, tmp_path):
    """Two groups of 4 steps by replay and eagerly from the same state and
    keys: the params agree, and each replay adds 4 steps' launches."""
    (graph, eager), groups = _group_trainers(dev, model, tmp_path)
    for i, xs in enumerate(groups):
        key = sampling.PRNGKey(30 + i, device=dev)
        _build.launches.clear()
        got = graph.run_group(xs, key)
        torch.cuda.synchronize()
        replayed = dict(_build.launches)
        want = eager.run_group(xs, key)
        if i:                        # the first call also warmed up
            assert replayed == dict(graph.group_graph.launches)
        for name in ("loss", "loss_mean", "grad_norm"):
            assert torch.allclose(got[name], want[name], rtol=1e-5), name
        _params_close(graph, eager)
    kernel = ("nade_ll_bwd" if model.get("decoder_type") == "rnn-nade"
              else "gibbs_chain")
    _build.launches.clear()
    eager.train_step(eager._to_device(groups[0][0]),
                     sampling.PRNGKey(1, device=dev))
    per_replay = graph.group_graph.launches[kernel]
    assert per_replay == 4 * _build.launches[kernel] > 0
    assert int(graph.opt_state["count"]) == 8
    # a DBN encoder is frozen: bit-identical through replayed groups
    for a, b in zip(multinn.tree_leaves(graph.params.encoder),
                    multinn.tree_leaves(_params(
                        multinn.MultINNConfig(**model), dev).encoder)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model", [FLAGSHIP, NADE, DBN_NADE])
def test_restore_under_a_live_graph(dev, model, tmp_path):
    """A checkpoint restored while a graph holds the state's addresses:
    the addresses stay, and the next replay equals the eager run."""
    (graph, eager), (x1, x2) = _group_trainers(dev, model, tmp_path)
    k1, k2 = (sampling.PRNGKey(s, device=dev) for s in (40, 41))
    graph.run_group(x1, k1)
    graph.save_checkpoint()
    ptrs = [t.data_ptr() for t in graph._state_tensors()]
    graph.run_group(x2, k2)
    graph.restore()
    assert [t.data_ptr() for t in graph._state_tensors()] == ptrs
    graph.run_group(x2, k2)
    eager.run_group(x1, k1)
    eager.run_group(x2, k2)
    _params_close(graph, eager)
    assert int(graph.opt_state["count"]) == 8


@pytest.mark.parametrize("model", [DBN_NADE, DBN_RBM])
def test_dbn_fused_kernels_match_plain(dev, model):
    """The whole-generation kernels at the DBN configs' latent width (64;
    the feedback context 320 wide): at least 7 of 8 samples identical to
    the plain version at T=16, the decoded rolls binary pianorolls."""
    params = _params(multinn.MultINNConfig(**model), dev)
    seed = (torch.rand(8, 16, 5, 84, generator=torch.Generator()
                       .manual_seed(2)) < 0.1).float().to(dev)
    state = multinn.prime(params, multinn.init_state(params, 8), seed)
    key = sampling.PRNGKey(6, device=dev)
    _, rk = multinn._generate_fused(params, key, state, 16, impl="cuda")
    _, rp = multinn._generate_fused(params, key, state, 16, impl="plain")
    assert rk.shape == (8, 16, 5, 84)
    assert torch.isin(rk, torch.tensor([0.0, 1.0], device=dev)).all()
    assert int((rk == rp).flatten(1).all(dim=1).sum()) >= 7


@pytest.mark.parametrize("model", [FLAGSHIP, NADE, DBN_NADE])
def test_accompaniment_on_the_card(dev, model):
    """generate_accompaniment through the kernels' given-track merge: the
    given track passes through bit for bit, and at least 7 of 8 samples
    equal the plain version's."""
    params = _params(multinn.MultINNConfig(**dict(model, w_std=0.1)), dev)
    given = (torch.rand(8, 16, 5, 84, generator=torch.Generator()
                        .manual_seed(3)) < 0.1).float().to(dev)
    state = multinn.init_state(params, 8)
    key = sampling.PRNGKey(7, device=dev)
    _build.launches.clear()
    _, rk = multinn.generate_accompaniment(params, key, state, given, (0,))
    family = ("gen_fused_nade" if model.get("decoder_type") == "rnn-nade"
              else "gen_fused_rbm")
    assert _build.launches[family] == 1
    _, rp = multinn._generate_accomp_fused(params, key, state, given, (0,),
                                           impl="plain")
    assert torch.equal(rk[:, :, 0], given[:, :, 0])
    assert int((rk == rp).flatten(1).all(dim=1).sum()) >= 7


@pytest.mark.parametrize("n", [5120, 1024])
def test_pretraining_chain_matches_plain(dev, n):
    """CD-1 at the DBN pre-training shapes, D=84, H=64: the shared
    encoder's K*B*T rows and one track's B*T."""
    g = torch.Generator().manual_seed(n)
    v0 = (torch.rand(n, 84, generator=g) < 0.06).float().to(dev)
    w = (0.01 * torch.randn(84, 64, generator=g)).to(dev)
    bv = torch.full((84,), -4.0).to(dev)
    bh = torch.zeros(64).to(dev)
    key = sampling.PRNGKey(n, device=dev)
    out_k = gibbs.gibbs_chain(key, v0, w, bv, bh, 1)
    out_p = gibbs.gibbs_chain(key, v0, w, bv, bh, 1, impl="plain")
    assert float((out_k != out_p).any(dim=1).float().mean()) <= 0.01


SMALL_RUN = ["--config", "configs/synthetic_smoke.json", "--model.n_hidden=16",
             "--model.n_rnn=12", "--data.window=16",
             "--data.synthetic_songs=8", "--data.synthetic_steps=48",
             "--train.epochs=1"]


@pytest.mark.parametrize("decoder", ["rnn-rbm", "rnn-nade"])
def test_entry_points_on_the_card(dev, tmp_path, decoder, capsys):
    """train, generate, evaluate and serve from the command line on the
    card (no --device): the generate CLI's rolls equal Generator.generate
    with its key, the fused kernel launched; evaluate writes its report and
    launches the family's loss kernel; the HTTP service answers."""
    import http.client
    import json
    import os
    import threading

    from multinn_torch import evaluate as evaluate_cli
    from multinn_torch import generate as generate_cli
    from multinn_torch import serve as serve_cli
    from multinn_torch import train as train_cli
    from multinn_torch.training.generator import Generator
    from multinn_torch.training.trainer import Trainer

    run = str(tmp_path / "run")
    assert train_cli.main(SMALL_RUN + [f"--model.decoder_type={decoder}",
                                       f"--train.run_dir={run}"]) == 0
    fused = "gen_fused_nade" if decoder == "rnn-nade" else "gen_fused_rbm"
    _build.launches.clear()
    assert generate_cli.main(["--run", run, "--generate.n_steps=32",
                              "--generate.n_samples=4"]) == 0
    torch.cuda.synchronize()
    assert _build.launches[fused] >= 1
    with np.load(os.path.join(run, "samples", "pianorolls.npz")) as z:
        rolls = z["rolls"]
    cfg = config.load_run_config(run, None, ["generate.n_steps=32",
                                             "generate.n_samples=4"])
    t = Trainer(cfg)
    t.restore(t.ckpt.best_step())
    gen = Generator(cfg, t.params)
    seed = t.dataset.seed_windows("valid", n=4)[:, :cfg.generate.seed_steps]
    want = gen.finalize(gen.generate(
        sampling.PRNGKey(cfg.train.seed + 7, device=dev), 32, seed=seed))
    t.close()
    np.testing.assert_array_equal(rolls, want)
    _build.launches.clear()
    assert evaluate_cli.main(["--run", run, "--split", "valid",
                              "--n-gen", "4"]) == 0
    torch.cuda.synchronize()
    kernel = "nade_ll_fwd" if decoder == "rnn-nade" else "gibbs_chain"
    assert _build.launches[kernel] >= 1 and _build.launches[fused] >= 1
    with open(os.path.join(run, "eval_valid.json")) as f:
        assert "musical_generated" in json.load(f)
    capsys.readouterr()
    args, overrides = serve_cli.parse_args(["--run", run, "--port", "0",
                                            "--batch", "8"])
    ready, box = threading.Event(), []
    th = threading.Thread(target=serve_cli.serve,
                          args=(args, overrides, ready, box), daemon=True)
    th.start()
    assert ready.wait(timeout=300)
    httpd, service = box[0]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_port,
                                          timeout=120)
        conn.request("POST", "/generate", json.dumps({"format": "roll",
                                                      "n": 8}))
        resp = conn.getresponse()
        out = json.loads(resp.read())
        assert resp.status == 200 and out["shape"][0] == 8
        conn.close()
    finally:
        httpd.shutdown()
        th.join(timeout=120)
    assert not th.is_alive() and not service._drainer.is_alive()


@pytest.mark.parametrize("model", [FLAGSHIP, NADE])
def test_sparse_transport_bit_equal_to_packed_on_the_card(dev, model,
                                                          monkeypatch):
    """packed="sparse" on device tensors: the records decode to the packed
    transport's rolls, over several fetch chunks, and through the frame
    fallback when the records overflow."""
    from multinn_torch.ops import sparsebytes
    from multinn_torch.training.generator import Generator
    cfg = config.ExperimentConfig(
        model=multinn.MultINNConfig(**dict(model, w_std=0.1)),
        data=config.DataConfig(dataset="lpd5", pitch_min=24, pitch_max=107,
                               n_tracks=5))
    gen = Generator(cfg, _params(cfg.model, dev))
    key = sampling.PRNGKey(9, device=dev)
    want = gen.fetch_rolls(gen.generate_async(key, 64, 8))
    out = gen.generate_async(key, 64, 8, packed="sparse")
    assert out.sparse.is_cuda and out.count.is_cuda
    np.testing.assert_array_equal(gen.fetch_rolls(out), want)
    assert not gen.last_sparse_overflowed
    monkeypatch.setattr(sparsebytes, "FETCH_CHUNK", 64)
    monkeypatch.setattr(sparsebytes, "record_cap",
                        lambda size, chunk=64: 64 * 400)
    out = gen.generate_async(key, 64, 8, packed="sparse")
    np.testing.assert_array_equal(gen.fetch_rolls(out, size_hint=100), want)
    monkeypatch.setattr(sparsebytes, "record_cap", lambda size, chunk=0: 8)
    out = gen.generate_async(key, 64, 8, packed="sparse")
    np.testing.assert_array_equal(gen.fetch_rolls(out), want)
    assert gen.last_sparse_overflowed


@pytest.mark.parametrize("decoder,kernel", [("rnn-rbm", "gibbs_chain"),
                                            ("rnn-nade", "nade_sample")])
def test_image_summaries_launch_the_scan_kernels(dev, tmp_path, decoder,
                                                 kernel):
    """valid/sample on the card: the scan path at B=1 launches the Gibbs
    chain (RBM) or the NADE sampler at least once a step."""
    import glob

    from multinn_torch.data.datasets import Dataset
    from multinn_torch.training.trainer import Trainer
    from multinn_torch.utils import tb
    cfg = config.load_run_config(None, "configs/synthetic_smoke.json", [
        f"model.decoder_type={decoder}", "data.window=16",
        "data.synthetic_songs=8", "data.synthetic_steps=48",
        "train.image_summaries=true", f"train.run_dir={tmp_path}"])
    t = Trainer(cfg, dataset=Dataset(cfg.data))
    _build.launches.clear()
    t._log_image_summaries()
    torch.cuda.synchronize()
    assert _build.launches[kernel] >= 16
    t.close()
    (path,) = glob.glob(f"{tmp_path}/tb/events.out.tfevents.*")
    tags = {tag for e in tb.read_events(path) for tag in e["images"]}
    assert tags == {"valid/reference", "valid/sample"}


# -- joint mode (one track of K*D = 420 pitches), HF and the bf16 policy ------

JOINT_RBM = dict(FLAGSHIP, mode="joint")
JOINT_NADE = dict(NADE, mode="joint")


@pytest.mark.parametrize("model", [JOINT_RBM, JOINT_NADE])
def test_joint_fused_kernels_match_plain(dev, model):
    """Both whole-generation kernels at Keff=1, D=420 (a one-CTA cluster,
    W read from device memory): the gate admits B=1 and B=8, the kernel
    launches, and at least 7 of 8 samples equal the plain version's."""
    cfg = multinn.MultINNConfig(**dict(model, w_std=0.1))
    gate = (gen_fused_rbm.supported if cfg.decoder_type == "rnn-rbm"
            else gen_fused_nade.supported_nade)
    assert gate(cfg, 1, 1024) and gate(cfg, 8, 1024)
    params = _params(cfg, dev)
    seed = (torch.rand(8, 16, 5, 84, generator=torch.Generator()
                       .manual_seed(1)) < 0.1).float().to(dev)
    state = multinn.prime(params, multinn.init_state(params, 8), seed)
    key = sampling.PRNGKey(5, device=dev)
    _build.launches.clear()
    fk, rk = multinn.generate(params, key, state, 16)
    name = ("gen_fused_rbm" if cfg.decoder_type == "rnn-rbm"
            else "gen_fused_nade")
    assert _build.launches[name] == 1
    fp, rp = multinn._generate_fused(params, key, state, 16, impl="plain")
    assert rk.shape == (8, 16, 5, 84)
    same = (rk == rp).flatten(1).all(dim=1)
    assert int(same.sum()) >= 7
    for a, b in zip(fk.decoder.cell, fp.decoder.cell):
        assert float((a.h - b.h).abs()[:, same].max()) <= 1e-4


def test_joint_training_chain_uses_the_device_memory_plan(dev):
    """The CD-1 chain of joint training: N = B*T = 1024 rows of D=420,
    H=150, whose W (252 KB) exceeds a CTA's shared memory."""
    assert gibbs_cuda.launch_plan(1024, 132, 420, 150)[3] == 0
    args = _gibbs_inputs(dev, 1024, seed=13, d=420, h=150)
    key = sampling.PRNGKey(8, device=dev)
    out_k = gibbs.gibbs_chain(key, *args, 1)
    out_p = gibbs.gibbs_chain(key, *args, 1, impl="plain")
    assert _rows_differing(out_k, out_p) <= 10


def test_joint_nade_sampler_and_likelihood(dev):
    """The sampler on 8 rows of D=420 (the joint scan path) and the
    likelihood pair at K=1, N=4096, D=420 (joint training)."""
    w, v, bv, bh = _sampler_inputs(dev, 8, 420, 150)
    key = sampling.PRNGKey(2, device=dev)
    out_k = nade_ops.nade_sample(key, w, v, bv, bh, (8,))
    out_p = nade_ops.nade_sample(key, w, v, bv, bh, (8,), impl="plain")
    assert _rows_differing(out_k, out_p) <= 1
    x, w, v, bv, bh, cot = _ll_inputs(dev, 1, 4096, d=420)
    lk, ak = nade_ll.nade_ll_fwd(x, w, v, bv, bh)
    lp, ap = nade_ll.nade_ll_fwd_plain(x, w, v, bv, bh)
    assert float((lk - lp).abs().max()) <= 1e-4
    for a, b in zip(nade_ll.nade_ll_bwd(x, w, v, cot, ak, True),
                    nade_ll.nade_ll_bwd_plain(x, w, v, cot, ap, True)):
        assert _within(a, b)


@pytest.mark.parametrize("model", [JOINT_RBM, JOINT_NADE,
                                   dict(FLAGSHIP, matmul_dtype="bf16"),
                                   dict(NADE, matmul_dtype="bf16")])
def test_joint_and_bf16_graph_groups_equal_eager(dev, model, tmp_path):
    """Captured groups of 4 steps against eager ones in joint mode and
    under the bf16 policy."""
    (graph, eager), groups = _group_trainers(dev, model, tmp_path)
    for i, xs in enumerate(groups):
        key = sampling.PRNGKey(50 + i, device=dev)
        got = graph.run_group(xs, key)
        want = eager.run_group(xs, key)
        assert torch.allclose(got["loss_mean"], want["loss_mean"],
                              rtol=1e-5)
        _params_close(graph, eager)


def test_bf16_mm_on_the_card_equals_the_upcast_product(dev):
    """torch.mm / bmm with out_dtype=float32 on bf16 feeds against the
    CPU route (upcast, f32 product): the same sums in another order."""
    from multinn_torch.ops import precision
    g = torch.Generator().manual_seed(0)
    for a_shape, b_shape in (((64, 16, 400), (400, 600)),
                             ((64, 5, 16, 184), (5, 184, 400))):
        a, b = torch.randn(a_shape, generator=g), torch.randn(b_shape,
                                                              generator=g)
        with precision.matmul_precision("bf16"):
            got = precision.mm(a.to(dev), b.to(dev))
            want = precision.mm(a, b)
        assert got.dtype == torch.float32
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale


def test_hf_group_on_the_card_equals_eager(dev, tmp_path):
    """Hessian-free macro-steps (NADE flagship, cg_iters=3) in a captured
    group of 2 against eager ones: the same accepts and lambda, the
    params within 1e-6 max|p|."""
    from multinn_torch.training.trainer import Trainer
    data = config.DataConfig.from_preset("synthetic", window=16, batch_size=4,
                                         synthetic_songs=12,
                                         synthetic_steps=64)
    params = _params(multinn.MultINNConfig(**NADE), dev)
    trainers = []
    for name in ("graph", "eager"):
        cfg = config.ExperimentConfig(
            data=data, model=multinn.MultINNConfig(**NADE),
            train=config.TrainConfig(steps_per_call=2, optimizer="hf",
                                     hf_cg_iters=3,
                                     run_dir=str(tmp_path / name)))
        trainers.append(Trainer(cfg, params=params))
    graph, eager = trainers
    eager.capture_groups = False
    xs = np.stack(list(graph.dataset.batches("train", epoch=0))[:2])
    key = sampling.PRNGKey(3, device=dev)
    _build.launches.clear()
    got = graph.run_group(xs, key)
    want = eager.run_group(xs, key)
    assert _build.launches["nade_ll_fwd"] > 0
    assert torch.equal(got["hf_accepted"], want["hf_accepted"])
    assert float(graph.opt_state.lam) == float(eager.opt_state.lam)
    _params_close(graph, eager)


# -- the row map (b0, B_global) of a data shard -------------------------------

def _rows_differ(a, b):
    return float((a != b).reshape(a.shape[0], -1).any(dim=1).float().mean())


@pytest.mark.parametrize("lead,b", [((64,), 16), ((), 8)])
def test_row_map_gibbs_on_the_card(dev, lead, b):
    """A shard's rows (b0, B) of the training shape (T=64, B=16) and of the
    scan path's 8 rows: the kernel on the shard equals its plain version
    and the whole launch's rows (the rows that may differ: a last-ulp flip,
    at most 1 % / 1 of 8); the default row map is bit for bit the launch
    without one."""
    g = torch.Generator().manual_seed(9)
    d, h = 84, 150
    v0 = (torch.rand(*lead, b, d, generator=g) < 0.2).float().to(dev)
    w = (0.1 * torch.randn(d, h, generator=g)).to(dev)
    bv = (0.5 * torch.randn(*lead, b, d, generator=g)).to(dev)
    bh = (0.5 * torch.randn(*lead, b, h, generator=g)).to(dev)
    key = sampling.PRNGKey(3, device=dev)
    full = gibbs_cuda.gibbs_chain(key, v0, w, bv, bh, 10)
    assert torch.equal(full, gibbs_cuda.gibbs_chain(key, v0, w, bv, bh, 10,
                                                    rows=(0, b)))
    limit = 0.01 if lead else 1 / 8
    for b0 in (0, b // 2):
        sl = slice(b0, b0 + b // 2)
        args = (v0[..., sl, :], w, bv[..., sl, :], bh[..., sl, :], 10)
        part = gibbs_cuda.gibbs_chain(key, *args, rows=(b0, b))
        plain = gibbs_cuda.gibbs_chain_plain(key, *args, rows=(b0, b))
        flat = lambda t: t.reshape(-1, d)
        assert _rows_differ(flat(part), flat(plain)) <= limit
        assert _rows_differ(flat(part), flat(full[..., sl, :])) <= limit


def test_row_map_nade_sampler_on_the_card(dev):
    g = torch.Generator().manual_seed(10)
    d, h, b = 84, 150, 8
    w = (0.1 * torch.randn(d, h, generator=g)).to(dev)
    v = (0.1 * torch.randn(d, h, generator=g)).to(dev)
    bv = (-1.0 + 0.5 * torch.randn(b, d, generator=g)).to(dev)
    bh = (0.5 * torch.randn(b, h, generator=g)).to(dev)
    key = sampling.PRNGKey(4, device=dev)
    full = nade_ops.nade_sample(key, w, v, bv, bh, (b,))
    assert torch.equal(full, nade_ops.nade_sample(key, w, v, bv, bh, (b,),
                                                  rows=(0, b)))
    for b0 in (0, 4):
        args = (w, v, bv[b0:b0 + 4], bh[b0:b0 + 4], (4,))
        part = nade_ops.nade_sample(key, *args, rows=(b0, b))
        plain = nade_ops.nade_sample(key, *args, impl="plain", rows=(b0, b))
        assert _rows_differ(part, plain) <= 1 / 4
        assert _rows_differ(part, full[b0:b0 + 4]) <= 1 / 4


@pytest.mark.parametrize("family", ["rnn-rbm", "rnn-nade"])
def test_row_map_fused_kernels_on_the_card(dev, family):
    """The whole-generation kernels on half the batch with the row map:
    the samples equal the whole launch's (at least 7 of 8 over both
    halves) and the plain version's; the default row map is bit for bit
    the launch without one."""
    params = _params(multinn.MultINNConfig(**dict(
        FLAGSHIP, decoder_type=family, w_std=0.1)), dev)
    state = _primed(params, 8, dev)
    dstate = state.decoder
    h0 = torch.stack([s.h for s in dstate.cell])
    c0 = torch.stack([s.c for s in dstate.cell])
    key = sampling.PRNGKey(5, device=dev)

    def run(sl, rows, impl="cuda"):
        args = (key, params.decoder, h0[:, :, sl], c0[:, :, sl],
                dstate.v_prev[:, sl], 16)
        if family == "rnn-rbm":
            return gen_fused_rbm.generate_rbm(*args, 10, impl=impl,
                                              rows=rows)[0]
        return gen_fused_nade.generate_nade(*args, impl=impl, rows=rows)[0]

    full = run(slice(None), None)
    assert torch.equal(full, run(slice(None), (0, 8)))
    same = 0
    for b0 in (0, 4):
        part = run(slice(b0, b0 + 4), (b0, 8))
        plain = run(slice(b0, b0 + 4), (b0, 8), impl="plain")
        same += int(_identical_samples(part, full[b0:b0 + 4]).sum())
        assert int(_identical_samples(part, plain).sum()) >= 3
    assert same >= 7


# -- meshes on the card -------------------------------------------------------

def test_nccl_world_one_dp_step(dev, tmp_path):
    """A world of one NCCL rank: an all-reduce through NCCL, and a gspmd
    data=1 step bit-equal to the step without a mesh."""
    import torch.distributed as dist

    from multinn_torch.parallel import mesh as mesh_mod
    from multinn_torch.training.trainer import Trainer
    backend = mesh_mod.init_distributed(f"file://{tmp_path}/store", 1, 0)
    try:
        assert backend == "nccl" and dist.get_backend() == "nccl"
        probe = torch.arange(3.0, device=dev)
        dist.all_reduce(probe)
        assert probe.tolist() == [0.0, 1.0, 2.0]
        x = (np.random.default_rng(0).random((8, 16, 5, 84)) < 0.06).astype(
            np.uint8)
        out = []
        for name, mesh in (("mesh", config.MeshConfig(use_mesh=True)),
                           ("one", config.MeshConfig())):
            cfg = config.ExperimentConfig(
                model=multinn.MultINNConfig(**NADE), mesh=mesh,
                train=config.TrainConfig(run_dir=str(tmp_path / name)))
            t = Trainer(cfg, params=_params(cfg.model, dev))
            m = t.train_step(t._put_batch(x), sampling.PRNGKey(1, device=dev))
            out.append((float(m["loss"]), [p.detach().clone()
                                           for p in t._all_leaves]))
            t.close()
        assert out[0][0] == out[1][0]
        assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    finally:
        dist.destroy_process_group()


def test_nccl_world_one_captured_mesh_group(dev, tmp_path):
    """A world of one NCCL rank: a gspmd data=1 Trainer captures its groups
    (the capture rule of an NCCL mesh, in ``thread_local`` mode); two
    replayed groups of 4 steps equal the eager groups, each replay adding
    4 eager steps' launches. Every group of one rank is the identity: the
    capture path under a mesh, not an NCCL collective inside a graph."""
    import torch.distributed as dist

    from multinn_torch.parallel import mesh as mesh_mod
    backend = mesh_mod.init_distributed(f"file://{tmp_path}/store", 1, 0)
    try:
        assert backend == "nccl"
        (graph, eager), groups = _group_trainers(
            dev, NADE, tmp_path, mesh=config.MeshConfig(use_mesh=True))
        assert graph.mesh.backend == "nccl"
        assert graph._new_graph().capture_error_mode == "thread_local"
        for i, xs in enumerate(groups):
            key = sampling.PRNGKey(40 + i, device=dev)
            _build.launches.clear()
            graph.run_group(xs, key)
            torch.cuda.synchronize()
            replayed = dict(_build.launches)
            eager.run_group(xs, key)
            if i:                        # the first call also warmed up
                assert replayed == dict(graph.group_graph.launches)
            _params_close(graph, eager)
        _build.launches.clear()
        eager.train_step(eager._put_batch(groups[0][0]), key)
        torch.cuda.synchronize()
        for k in ("nade_ll_fwd", "nade_ll_bwd"):
            assert graph.group_graph.launches[k] == 4 * _build.launches[k]
        graph.close()
        eager.close()
    finally:
        dist.destroy_process_group()


def test_frame_counts_capture(dev):
    """A gspmd step on a data split returns its frame counts for the
    trainer's reduction inside the captured step, so nothing in them may
    come from the host: captured, with and without a mask, the counts
    equal the eager ones."""
    from multinn_torch.training.metrics import frame_counts
    g = torch.Generator().manual_seed(0)
    pred = torch.rand(64, 8, 84, generator=g).to(dev)
    target = (torch.rand(64, 8, 84, generator=g) < 0.1).float().to(dev)
    for mask in (None, torch.ones(64, 8, device=dev)):
        want = frame_counts(pred, target, mask=mask)
        graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            frame_counts(pred, target, mask=mask)
        torch.cuda.current_stream().wait_stream(stream)
        with torch.cuda.graph(graph):
            got = frame_counts(pred, target, mask=mask)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_nccl_two_cards_captured_group_equals_eager(tmp_path):
    """Two ranks, a card each, on NCCL: each gspmd data=2 Trainer captures
    its groups with their NCCL collectives inside; two replayed groups of 4
    steps per family equal the eager mesh groups (params within 1e-6
    max|p|) on both ranks, each replay adding 4 eager steps' launches."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL runs one rank a card")
    import torch_mesh_ranks as ranks
    ranks.run_world(tmp_path, 2, "cards2", timeout=300, backend="nccl")
    for dec in ("rnn-nade", "rnn-rbm"):
        for r in range(2):
            a = ranks.load(tmp_path, f"cards2_{dec}", r)
            assert str(a["backend"]) == "nccl"
            assert str(a["device"]) == f"cuda:{r}"
            assert a["captures"] == 1.0
            assert (a["diffs"] <= 1e-6).all(), a["diffs"]
            assert a["one_step"] >= 1
            assert a["recorded"] == 4 * a["one_step"]
            # the first call also ran the warm-up's two eager steps
            assert a["replays"][1] == a["recorded"]


def test_nccl_two_cards_captured_track_group_equals_eager(tmp_path):
    """Two ranks, a card each, on NCCL: a gspmd data=1 x track=2 Trainer
    (K=2, feedback, tiny widths: one track a card) of each family
    captures its groups with the track group's collectives inside (the
    context's all-gather and its backward); two replayed groups of 4
    steps equal the eager mesh groups (params within 1e-6 max|p|) on both
    ranks, each replay adding 4 eager steps' launches."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL runs one rank a card")
    import torch_mesh_ranks as ranks
    ranks.run_world(tmp_path, 2, "cards2_track", timeout=300,
                    backend="nccl")
    for dec in ("rnn-nade", "rnn-rbm"):
        for r in range(2):
            a = ranks.load(tmp_path, f"cards2t_{dec}", r)
            assert str(a["backend"]) == "nccl"
            assert str(a["device"]) == f"cuda:{r}"
            assert a["captures"] == 1.0 and a["local_k"] == 1.0
            assert (a["diffs"] <= 1e-6).all(), a["diffs"]
            assert a["one_step"] >= 1
            assert a["recorded"] == 4 * a["one_step"]
            assert a["replays"][1] == a["recorded"]


@pytest.mark.parametrize("model", [FLAGSHIP, NADE])
def test_remat_graph_group_equals_eager(dev, model, tmp_path):
    """model.remat checkpoints each recurrence step without stashing the
    RNG state, so a group of steps still captures: two groups by replay
    equal the eager groups."""
    (graph, eager), groups = _group_trainers(dev, dict(model, remat=True),
                                             tmp_path)
    assert graph.cfg.model.remat
    for i, xs in enumerate(groups):
        key = sampling.PRNGKey(50 + i, device=dev)
        got = graph.run_group(xs, key)
        want = eager.run_group(xs, key)
        for name in ("loss", "loss_mean", "grad_norm"):
            assert torch.allclose(got[name], want[name], rtol=1e-5), name
        _params_close(graph, eager)


def test_timers_wait_for_the_card(dev):
    """utils/profiling on the card: ``force`` waits for a tree's CUDA
    tensors, ``timeit`` times by CUDA events, ``cuda_ms`` / ``graph_ms``
    read positive device times of a matmul."""
    from multinn_torch.utils import profiling
    a = torch.randn(2048, 2048, device=dev)
    out = {"p": [a @ a], "q": (a.sum(), None)}
    profiling.force(out)
    assert torch.cuda.current_stream(dev).query()
    r = profiling.timeit(lambda x: x @ x, a, iters=3, warmup=1)
    assert r["iters"] == 3 and 0 < r["min_s"] <= r["mean_s"]
    assert profiling.cuda_ms(lambda: a @ a, 3) > 0
    assert profiling.graph_ms(lambda: a @ a, 3) > 0
    timer = profiling.StepTimer()
    timer.start()
    timer.lap(a @ a)
    timer.lap(a @ a)
    assert timer.mean > 0 and timer.rate(1.0) > 0
