"""multinn_torch's checkpoints (``training/checkpoint.py``) and the trainer's
use of them, on the CPU: the reference's retention policy (the last N plus
the best by ``valid_loss``, metric-less saves never kept as best), a
duplicate step refused, a torn temporary ignored, and the epoch-end save
with metrics winning over a periodic save at the same step (as the JAX
package's ``tests/test_train_e2e.py`` holds for orbax). Restores are exact:
the tensors compare equal."""

import json
import os

import pytest
import torch

from multinn_torch.models import multinn
from multinn_torch.training.checkpoint import Checkpointer
from multinn_torch.training.trainer import Trainer
from multinn_torch.utils import config

torch.set_num_threads(1)


def _state(v):
    return {"x": torch.full((3,), float(v)), "step": v}


@pytest.mark.parametrize("keep_last,keep_best,want,best", [
    (2, True, {1, 4, 5}, 1), (2, False, {4, 5}, None),
    (1, True, {1, 5}, 1), (5, True, {1, 2, 3, 4, 5}, 1)])
def test_retention_is_last_n_plus_best(tmp_path, keep_last, keep_best, want,
                                       best):
    ck = Checkpointer(str(tmp_path / "ck"), keep_last=keep_last,
                      keep_best=keep_best)
    ck.save(1, _state(1), metrics={"valid_loss": 0.5})     # the best
    ck.save(2, _state(2))                                  # periodic
    ck.save(3, _state(3), metrics={"valid_loss": 1.0})
    ck.save(4, _state(4))                                  # periodic
    ck.save(5, _state(5), metrics={"valid_loss": 2.0})
    assert set(ck.all_steps()) == want
    assert ck.best_step() == best
    assert ck.latest_step() == 5
    state, at = ck.restore()
    assert at == 5 and state["step"] == 5
    assert torch.equal(state["x"], torch.full((3,), 5.0))
    state, at = ck.restore(1 if 1 in want else 5)
    assert state["step"] == at
    with pytest.raises(FileNotFoundError):
        ck.restore(6)


def test_metric_less_saves_are_never_best(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), keep_last=1)
    for step in (1, 2, 3):
        ck.save(step, _state(step))
    assert ck.best_step() is None and ck.all_steps() == [3]
    assert Checkpointer(str(tmp_path / "empty")).latest_step() is None
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore()


def test_a_duplicate_step_is_refused(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    assert ck.save(7, _state(7))
    assert not ck.save(7, _state(8), metrics={"valid_loss": 0.0})
    state, _ = ck.restore(7)
    assert state["step"] == 7 and ck.best_step() is None


def test_a_torn_temporary_is_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(4, _state(4), metrics={"valid_loss": 1.0})
    # a save killed mid-write: a temporary directory with a torn file, and
    # a step directory with no state file
    torn = tmp_path / "ck" / ".tmp-9-123"
    torn.mkdir()
    (torn / "state.pt").write_bytes(b"\x80\x02torn")
    (tmp_path / "ck" / "12").mkdir()
    again = Checkpointer(str(tmp_path / "ck"))
    assert again.all_steps() == [4] and again.latest_step() == 4
    assert again.restore()[0]["step"] == 4
    assert again.save(9, _state(9))                  # the temporary is reused
    assert again.all_steps() == [4, 9]


SMALL = dict(n_tracks=2, n_pitches=24, mode="per-track",
             decoder_type="rnn-nade", n_hidden=8, n_rnn=6)


def _cfg(tmp_path, **train):
    data = config.DataConfig.from_preset(
        "synthetic", n_tracks=2, pitch_min=40, pitch_max=63, window=16,
        batch_size=4, synthetic_songs=8, synthetic_steps=64)
    return config.ExperimentConfig(
        name="ck", data=data, model=multinn.MultINNConfig(**SMALL),
        train=config.TrainConfig(**dict(dict(
            epochs=2, lr=3e-3, log_every_steps=5, ckpt_every_steps=0,
            run_dir=str(tmp_path / "run")), **train))).validate()


def test_epoch_end_metric_save_wins_over_periodic(tmp_path):
    """8 songs x 4 windows x 0.8 = 24 train windows / 4 = 6 steps an epoch;
    ckpt_every_steps=3 meets the epoch's end at step 6 and 12."""
    cfg = _cfg(tmp_path, ckpt_every_steps=3)
    tr = Trainer(cfg, device="cpu")
    assert tr.dataset.n_batches("train") == 6
    tr.train()
    assert tr.ckpt.best_step() in (6, 12)
    for step in (6, 12):
        with open(tmp_path / "run" / "ckpt" / str(step) / "metrics.json") as f:
            assert "valid_loss" in json.load(f)
    assert set(tr.ckpt.all_steps()) >= {9, 12}
    tr.close()


def test_restore_copies_into_the_trainer_tensors(tmp_path):
    """A fresh trainer restores the latest checkpoint into its own tensors
    (the addresses a captured graph holds stay), with the step, epoch,
    cursor and rng of the run."""
    cfg = _cfg(tmp_path, epochs=1)
    tr = Trainer(cfg, device="cpu")
    tr.train()
    fresh = Trainer(cfg, device="cpu")
    ptrs = [t.data_ptr() for t in fresh._state_tensors()]
    assert fresh.maybe_resume()
    assert [t.data_ptr() for t in fresh._state_tensors()] == ptrs
    assert (fresh.step, fresh.epoch, fresh.epoch_step0) == (tr.step, 1,
                                                            tr.step)
    assert torch.equal(fresh.rng, tr.rng)
    # the epoch-end save precedes the epoch's own best update, as in the
    # reference: the first epoch's checkpoint still holds inf
    assert fresh.best_valid == float("inf") > tr.best_valid
    for a, b in zip(fresh._state_tensors(), tr._state_tensors()):
        assert torch.equal(a, b)
    assert int(fresh.opt_state["count"]) == tr.step
    assert not Trainer(_cfg(tmp_path / "other"), device="cpu").maybe_resume()
    assert {"ckpt", "metrics.jsonl", "tb"} <= set(
        os.listdir(tmp_path / "run"))
    tr.close()
    fresh.close()
