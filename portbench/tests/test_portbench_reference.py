"""The plain reference against the program's plain paths at a tiny size
on the CPU, and the control at a cell's own size on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import control
from portbench import weights as weights_mod
from portbench.reference import model as ref
from portbench.reference import threefry

from .conftest import TINY_MODEL


def _cfg(decoder):
    from multinn_torch.models.multinn import MultINNConfig
    return MultINNConfig(mode="feedback", decoder_type=decoder, cd_k=1,
                         **TINY_MODEL)


def test_threefry_keys_equal_the_programs():
    from multinn_torch.ops import sampling
    key = sampling.PRNGKey(1234567, device="cpu")
    words = lambda k: tuple(int(x) & threefry.MASK
                            for x in k.view(torch.int32))
    base = threefry.prng_key(1234567)
    assert words(sampling.fold_in(key, 77)) == threefry.fold_in(base, 77)
    split = sampling.split(key, 5)
    assert all(words(split[i]) == threefry.split(base, i) for i in range(5))


@pytest.mark.parametrize("decoder", ["rnn-rbm", "rnn-nade"])
def test_replay_reproduces_the_programs_generation(decoder):
    """Songs from the program's whole-generation path (its plain version
    on the CPU) replay to the same frames; a flipped note does not."""
    from multinn_torch.models import multinn
    from multinn_torch.ops import sampling
    cfg = _cfg(decoder)
    wts = weights_mod.draw(cfg, 5, 1.0, "cpu")
    params = weights_mod.port_params(cfg, wts)
    batch, steps, seed, bi = 8, 12, 99, 3
    key = sampling.fold_in(sampling.PRNGKey(seed, device="cpu"), bi)
    _, roll = multinn.generate(params, key, multinn.init_state(params, batch),
                               steps, fused=True)
    rows = [1, 4, 6]
    keys = [threefry.fold_in(threefry.prng_key(seed), bi)] * len(rows)
    rolls = roll[rows].float()
    replay = (lambda r: ref.rbm_replay(wts, r, keys, rows, batch, cfg.gen_k)
              if decoder == "rnn-rbm"
              else ref.nade_replay(wts, r, keys, rows, batch))
    out = replay(rolls)
    assert out["frames"].sum() == 0 and out["margin"].max() == 0
    flipped = rolls.clone()
    flipped[1, 5, 0, 3] = 1 - flipped[1, 5, 0, 3]
    bad = replay(flipped)
    assert bad["frames"][1] >= 1 and bad["margin"][1] > 0


def test_cd1_loss_and_steps_equal_the_programs(tmp_path):
    """The reference's CD-1 loss, gradients and Adam steps against the
    program's Trainer on its CPU path."""
    from multinn_torch.training.trainer import Trainer
    from multinn_torch.utils.config import (DataConfig, ExperimentConfig,
                                            TrainConfig)

    class Data:
        def n_batches(self, split="train"):
            return 1

    cfg = _cfg("rnn-rbm")
    wts = weights_mod.draw(cfg, 8, 1.0, "cpu")
    x = (torch.rand((3, 4, 6, 2, 8), generator=torch.Generator()
                    .manual_seed(2)) < 0.2).to(torch.uint8)
    exp = ExperimentConfig(
        data=DataConfig(n_tracks=2, pitch_min=60, pitch_max=67),
        model=cfg, train=TrainConfig(steps_per_call=3, seed=4,
                                     log_every_steps=2 ** 30,
                                     ckpt_every_steps=0,
                                     run_dir=str(tmp_path)))
    tr = Trainer(exp, dataset=Data(),
                 params=weights_mod.port_params(cfg, wts), device="cpu")
    key = torch.tensor([12345, 678], dtype=torch.int32).view(torch.uint32)
    out = tr.run_group(x.numpy(), key)
    names = weights_mod.leaf_names(tr.params.decoder)
    prog = dict(zip(names, tr._leaves))
    keys = [threefry.split((12345, 678), i) for i in range(3)]
    after, _, losses, norms = ref.rbm_train(wts, list(x.float()), keys,
                                            1e-3, 5.0)
    assert np.isclose(float(out["loss"]), losses[-1], rtol=1e-5, atol=1e-7)
    assert np.isclose(float(out["grad_norm"]), norms[-1], rtol=1e-5)
    for n in names:
        assert torch.allclose(prog[n], after[n], rtol=1e-5, atol=1e-7), n


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["rbm_flagship.serve", "nade_flagship.serve",
                                  "rbm_flagship.train"])
def test_the_control_is_not_correct_on_the_card(cell):
    """The program one precision below the configuration's, at the cell's
    own size and a short window, fails the output check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = control.run(cell, 31337, 5.0, "control")
    assert not out["correct"], out["checks"]
