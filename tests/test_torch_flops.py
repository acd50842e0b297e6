"""multinn_torch.utils.flops on the CPU:

* MODEL counts equal multinn_tpu.utils.flops's integers exactly at B=2,
  T=3 for the six shipped configs, joint mode, a vanilla cell, a DBN
  encoder and two RNN layers, for both decoder families;
* EXECUTED counts describe the CUDA kernels: the RBM's equal the model's
  at a dense frame and fall with the density, the NADE's count the
  sweep's register lanes and, at depths 2 and 4, its branch work;
  hand-worked values at one small shape;
* every ``*_work`` function returns a hand-worked (bytes, operations) at
  one small shape; ``bound`` names what bounds it; the H100 peaks and
  ``mfu``; no TPU constant is left.
"""

import glob
import json
import os

import pytest
import torch

from multinn_torch.models import multinn
from multinn_torch.utils import flops
from multinn_tpu.models.multinn import MultINNConfig as JaxConfig
from multinn_tpu.utils import flops as jax_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = dict(n_tracks=5, n_pitches=84, mode="feedback",
                decoder_type="rnn-rbm", n_hidden=150, n_rnn=100, cd_k=1,
                gen_k=10)


def _shipped():
    out = {}
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*.json"))):
        with open(path) as f:
            model = json.load(f)["model"]
        model["encoder_hidden"] = tuple(model["encoder_hidden"])
        out[os.path.basename(path)[:-5]] = model
    return out


CASES = dict(_shipped())
assert len(CASES) == 6
CASES.update({
    "joint": dict(FLAGSHIP, mode="joint"),
    "joint_nade": dict(FLAGSHIP, mode="joint", decoder_type="rnn-nade"),
    "vanilla": dict(FLAGSHIP, cell="vanilla"),
    "dbn_encoder": dict(FLAGSHIP, encoder_hidden=(64,)),
    "two_layers": dict(FLAGSHIP, rnn_layers=2),
    "two_layers_nade_vanilla": dict(FLAGSHIP, rnn_layers=2, cell="vanilla",
                                    decoder_type="rnn-nade"),
})


def _cfgs(model):
    return multinn.MultINNConfig(**model), JaxConfig(**model)


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_counts_equal_the_jax_package(name):
    for family in ("rnn-rbm", "rnn-nade"):
        cfg, jcfg = _cfgs(dict(CASES[name], decoder_type=family))
        got = flops.train_step_flops(cfg, 2, 3)
        assert got == jax_flops.train_step_flops(jcfg, 2, 3)
        assert isinstance(got, int) and got > 0
        assert (flops.gen_step_flops_rbm(cfg, 2)["model"]
                == jax_flops.gen_step_flops_rbm(jcfg, 2)["model"])
        assert (flops.gen_step_flops_rbm(cfg, 2, gen_k=3)["model"]
                == jax_flops.gen_step_flops_rbm(jcfg, 2, gen_k=3)["model"])
        assert (flops.gen_step_flops_nade(cfg, 2)["model"]
                == jax_flops.gen_step_flops_nade(jcfg, 2)["model"])
        assert flops._dims(cfg) == jax_flops._dims(jcfg)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rbm_executed_counts(name):
    """The RBM kernel runs no padding: at a dense frame it multiplies the
    model's work; its cell stack gathers only the frames' nonzero
    entries, so less at a musical density."""
    cfg, _ = _cfgs(CASES[name])
    dense = flops.gen_step_flops_rbm(cfg, 2)
    assert dense["executed"] >= dense["model"]
    assert dense["executed"] == dense["model"]
    sparse = flops.gen_step_flops_rbm(cfg, 2, density=0.06)
    assert sparse["model"] == dense["model"]
    assert sparse["executed"] < dense["executed"]


def test_executed_counts_hand_worked():
    # K=2, D=4, H=3, U=2 (G=8), feedback (ctx = 8), one LSTM layer, at a
    # frame density of 0.5; per track and sample:
    cfg = multinn.MultINNConfig(n_tracks=2, n_pitches=4, mode="feedback",
                                n_hidden=3, n_rnn=2, gen_k=5)
    # biases 2*2*(4+3) = 28; cell: gathers 2*0.5*(4+8)*8 = 96, recurrence
    # 2*2*8 = 32, elementwise 12*2 = 24
    cell = 96 + 32 + 24
    # RBM: 5 sweeps of 4*4*3 = 240
    assert flops.gen_step_flops_rbm(cfg, 1, density=0.5) == {
        "model": 2 * (240 + 28 + 2 * (4 + 8 + 2) * 8 + 24),
        "executed": 2 * (240 + 28 + cell)}
    # NADE at depth 1: per dim 256 lanes x 2, 7 x 32 lane ops, 0.5 x (3
    # adds + 3 sigmoids)
    nade = flops.gen_step_flops_nade(cfg, 1, density=0.5, spec=1)
    assert nade["executed"] == 2 * (28 + 4 * (512 + 224 + 3) + cell)
    assert nade["model"] == 2 * (6 * 4 * 3 + 2 * 4 * 4 * 2 + 248)
    # at depth 2, pairs in teams of 2 warps: per warp and pair, over the
    # one live round of 32 lanes, 2 x 2 fmafs, 1 branch add and 1 sigmoid
    # (32 x 6), 32 x (1 + 4 butterfly adds, 2 selects, 2, 1 chain select)
    # lane ops and the realized update 3 x 0.5 x 2 adds; two pairs
    pair = flops.gen_step_flops_nade(cfg, 1, density=0.5, spec=2)
    assert pair["executed"] == 2 * (28 + 2 * 2 * (192 + 320 + 3) + cell)
    assert pair["model"] == nade["model"]
    # D=4: the auto depth is 4
    assert (flops.gen_step_flops_nade(cfg, 1, density=0.5)
            == flops.gen_step_flops_nade(cfg, 1, density=0.5, spec=4))
    # at H = 3 the padded lanes exceed the model's work; at the flagship
    # the model's dense grid and its second Wx product exceed the
    # sequential sweep's, and depth 4's eight warps a quad exceed them
    assert nade["executed"] > nade["model"]
    big, _ = _cfgs(dict(FLAGSHIP, decoder_type="rnn-nade"))
    flag = flops.gen_step_flops_nade(big, 1, spec=1)
    assert flag["executed"] < flag["model"]
    assert flops.gen_step_flops_nade(big, 1)["executed"] > flag["model"]


@pytest.mark.parametrize("spec", [1, 2, 4])
def test_gen_step_flops_nade_takes_the_speculation_depth(spec):
    """The model count is the JAX package's at every depth; the executed
    count bills the branch work, so it grows with the depth."""
    cfg, jcfg = _cfgs(dict(FLAGSHIP, decoder_type="rnn-nade"))
    got = flops.gen_step_flops_nade(cfg, 3, spec=spec)
    assert got["model"] == jax_flops.gen_step_flops_nade(jcfg, 3,
                                                         spec)["model"]
    if spec > 1:
        shallower = flops.gen_step_flops_nade(cfg, 3, spec=spec // 2)
        assert got["executed"] > shallower["executed"]
    else:
        assert got["executed"] < got["model"]


def test_work_functions_hand_worked():
    assert flops.threefry_work(1) == (24, 80)
    assert flops.threefry_work(10) == (8 + 160, 800)
    out = torch.zeros(2, 4)
    out[0, :3] = 1
    out[1, 1:3] = 1                                  # 5 ones
    # gibbs n=2 k=3 d=4 h=3: 4*(3*2*4 + 4*3 + 2*3) bytes;
    # 2*3*3*5 + 80*2*3*7 operations
    assert flops.gibbs_work(2, 3, out, 4, 3) == (168, 90 + 3360)
    # sampler n=2 d=4 h=3: 4*(2*4*3 + 2*4*2 + 2*3); 2*2*4*3 + 3*5
    assert flops.nade_sample_work(2, 4, 3, out) == (184, 48 + 15)
    x = torch.zeros(2, 3, 4)
    x.view(-1)[:7] = 1                               # 7 ones
    # likelihood k=2 n=3 d=4 h=5
    assert flops.nade_ll_fwd_work(2, 3, 4, 5, x) == (
        4 * (72 + 60 + 80), 240 + 35)
    assert flops.nade_ll_bwd_work(2, 3, 4, 5, x) == (
        4 * (48 + 60 + 160), 480 + 70)


def test_lstm_scan_work_hand_worked():
    # k=2 tracks x n=3 rows, u=4 units, t=5 steps, in floats: xz in and z
    # out (or z in and dz out) 2 * 5*2*3*16; Wh 2*4*16; h0, c0 (dh0, dc0)
    # 2 * 2*3*4; hbuf, cbuf (cbuf, one carry's cotangent) 2 * 6*2*3*4.
    # Operations: 5*2*3 rows a step of 2 * 4 * 16 (the h Wh product)
    want = (4 * (960 + 128 + 48 + 288), 30 * 128)
    assert flops.lstm_scan_fwd_work(2, 3, 4, 5) == want
    assert flops.lstm_scan_bwd_work(2, 3, 4, 5) == want


@pytest.mark.parametrize("family", ["rnn-rbm", "rnn-nade"])
def test_fused_work_hand_worked(family):
    cfg = multinn.MultINNConfig(n_tracks=2, n_pitches=4, mode="feedback",
                                decoder_type=family, n_hidden=3, n_rnn=2)
    params = multinn.init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    leaves = multinn.tree_leaves(params.decoder)
    # w 2*4*3, bv 2*4, bh 2*3, wuv 2*2*4, wuh 2*2*3, Wx 2*12*8, Wh 2*2*8,
    # b 2*8; the NADE adds V 2*4*3
    numel = 306 + (24 if family == "rnn-nade" else 0)
    assert sum(t.numel() for t in leaves) == numel
    roll = torch.zeros(1, 2, 2, 4)                   # B=1, T=2
    roll[0, 0, 0, 0] = roll[0, 1, 0, 1] = roll[0, 1, 1, 2] = 1
    v0 = torch.zeros(2, 1, 4)
    v0[0, 0, :2] = 1
    # steps 4, nnz 3, previous frames' nnz 2 + 1, ctx 2*8*3 = 48, dense
    # 4*((4+3)*2 + 8*2) = 120; state and roll bytes 4*(16 + 16 + 8)
    if family == "rnn-rbm":
        want = (4 * numel + 160, 2 * (120 + 5 * 3 * 3 + 8 * 3 + 48))
    else:
        half = 24 + 24 + 16 + 192                    # bf16: W, V, Wuv, Wx
        want = (2 * half + 4 * (numel - half) + 160,
                2 * (120 + 4 * 12 + 48) + 3 * 3 + 8 * 3)
    assert flops.fused_work(params, roll, v0, 5) == want
    assert flops.fused_work(params, roll, v0, 5, torch.float32) == want
    # the bf16 capacity modes: the RBM's W, Wuv, Wuh and the context rows
    # of Wx (2*8*8); the NADE's Wuh and Wh beside its five
    half = (24 + 16 + 12 + 128 if family == "rnn-rbm"
            else 24 + 24 + 16 + 192 + 12 + 32)
    assert flops.fused_work(params, roll, v0, 5, torch.bfloat16) == (
        2 * half + 4 * (numel - half) + 160, want[1])


def test_bound_names_what_bounds_it():
    ms, by = flops.bound(3.35e9, 1.0)       # 3.35 GB at 3.35 TB/s
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = flops.bound(1.0, 67e9)         # 67 GFLOP at 67 TFLOP/s
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = flops.bound(3.35e9, 2 * 67e9)
    assert by == "operations" and ms == pytest.approx(2.0)


def test_h100_peaks_and_mfu():
    assert flops.peak_for("f32") is flops.H100_SXM_F32
    assert flops.H100_SXM_F32.flops_per_s == 67e12
    assert flops.peak_for("f32", allow_tf32=True).flops_per_s == 494.7e12
    assert flops.peak_for("bf16").flops_per_s == 989.4e12
    assert flops.peak_for("bf16", allow_tf32=True) is flops.H100_SXM_BF16
    assert all("H100" in p.name for p in (
        flops.H100_SXM_F32, flops.H100_SXM_TF32, flops.H100_SXM_BF16))
    with pytest.raises(ValueError):
        flops.peak_for("fp8")
    assert flops.mfu(67e12, 1.0, flops.H100_SXM_F32) == pytest.approx(1.0)
    assert flops.mfu(9.19e9, 5.08e-3, flops.H100_SXM_F32) == pytest.approx(
        0.027, abs=1e-3)
    assert flops.mfu(1.0, 0.0, flops.H100_SXM_F32) == 0.0
    with pytest.raises(TypeError):
        flops.mfu(1.0, 1.0)                  # no default peak
    assert flops.H100_SXM_HBM_BYTES_PER_S == 3.35e12


def test_no_tpu_constant_in_the_port():
    src = open(flops.__file__).read()
    for tpu in ("V5E", "197e12", "819e9", "v5e", "MXU"):
        assert tpu not in src
    assert not [n for n in dir(flops) if "V5" in n.upper()]
