"""The port's train entry point, ``python -m multinn_torch.train``, on the
CPU (``--device cpu``), and the run files it writes.

* ``main`` on ``configs/synthetic_smoke.json`` with small overrides writes
  ``config.json`` (which loads back into the JAX package's config),
  ``metrics.jsonl`` with the reference's record fields, TensorBoard events
  and checkpoints under the retention policy; a second call resumes from
  the latest checkpoint and trains only the epochs left.
* Unknown override paths raise as the JAX CLI's do; the preset path keeps
  ``model.n_pitches`` in step with the data's frame width.
* ``--profile-steps`` writes a trace and leaves the training unperturbed.
* The TensorBoard writer's files read back in the JAX package's reader and
  the other way round; a flipped CRC bit is detected (the flip always
  changes the byte, unlike writing 0xFF over it).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from multinn_tpu.utils import config as jax_config
from multinn_tpu.utils import tb as jax_tb
from multinn_torch import train as train_cli
from multinn_torch.utils import config, tb
from multinn_torch.utils.logging import MetricsLogger, format_metrics

torch.set_num_threads(1)
SMALL = ["--config", "configs/synthetic_smoke.json", "--device", "cpu",
         "--model.n_hidden=8", "--model.n_rnn=6", "--data.window=16",
         "--data.synthetic_songs=8", "--data.synthetic_steps=48",
         "--train.log_every_steps=2", "--train.keep_last=1"]


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    run = str(tmp_path / "run")
    assert train_cli.main(SMALL + [f"--train.run_dir={run}"]) == 0
    cfg = config.load_json(os.path.join(run, "config.json"))
    assert cfg.train.run_dir == run and cfg.model.n_hidden == 8
    assert jax_config.load_json(os.path.join(run, "config.json")).validate()
    rows = _records(run)
    assert {r["split"] for r in rows} == {"train", "valid"}
    for r in rows:
        assert {"step", "time", "split", "loss"} <= set(r)
    n_batches = 2                      # 8 songs x 3 windows x 0.8 / 8
    assert [r["step"] for r in rows if r["split"] == "valid"] == [2, 4]
    events = glob.glob(os.path.join(run, "tb", "events.out.tfevents.*"))
    assert len(events) == 1
    tags = set().union(*(e["scalars"] for e in tb.read_events(events[0])))
    assert {"train/loss", "valid/loss", "valid/ll_per_frame"} <= tags
    ckpts = sorted(os.listdir(os.path.join(run, "ckpt")))
    assert ckpts[-1] == str(2 * n_batches)     # keep_last=1 plus the best
    assert 1 <= len(ckpts) <= 2
    # the run's config as the generate / evaluate CLIs resolve it
    again = config.load_run_config(run, None, ["train.lr=0.01"])
    assert again.train.run_dir == run and again.train.lr == 0.01
    with pytest.raises(FileNotFoundError):
        config.load_run_config(str(tmp_path / "none"), None, [])
    # a second call resumes: only the third epoch is left
    assert train_cli.main(SMALL + [f"--train.run_dir={run}",
                                   "--train.epochs=3"]) == 0
    rows = _records(run)
    assert [r["step"] for r in rows if r["split"] == "valid"] == [2, 4, 6]
    assert str(3 * n_batches) in os.listdir(os.path.join(run, "ckpt"))
    # --no-resume starts over in the same run dir: the step-2 save exists
    # only if it was kept, so the duplicate refusal is logged, not raised
    assert train_cli.main(SMALL + [f"--train.run_dir={run}",
                                   "--train.epochs=1", "--no-resume"]) == 0


def test_unknown_override_raises_like_the_jax_cli(tmp_path):
    for bad in (["--train.nonexistent=1"], ["--nosuch.lr=1"],
                ["--train.lr"]):
        with pytest.raises(ValueError):
            train_cli.main(SMALL + [f"--train.run_dir={tmp_path}"] + bad)
    with pytest.raises(ValueError, match="unknown config path"):
        config.apply_overrides(config.ExperimentConfig(),
                               ["train.nonexistent=1"])
    with pytest.raises(ValueError, match="n_tracks"):
        train_cli.main(SMALL + ["--model.n_tracks=2"])


def test_preset_path_syncs_the_model_width():
    args, ovs = train_cli.parse_args(["--preset", "synthetic",
                                      "--data.encoding=onset_hold",
                                      "--data.n_tracks=2",
                                      "--model.n_tracks=2"])
    cfg = train_cli.build_config(args, ovs)
    assert cfg.model.n_pitches == cfg.data.frame_dim == 168
    assert cfg.data.transpose_exclude == (0,)


def test_profile_steps_writes_a_trace_and_leaves_training(tmp_path):
    run = str(tmp_path / "prof")
    assert train_cli.main(SMALL + [f"--train.run_dir={run}",
                                   "--train.epochs=1", "--profile-steps=2"]
                          ) == 0
    assert os.path.exists(os.path.join(run, "trace", "trace.json"))
    plain = str(tmp_path / "plain")
    assert train_cli.main(SMALL + [f"--train.run_dir={plain}",
                                   "--train.epochs=1"]) == 0
    a = torch.load(os.path.join(run, "ckpt", "2", "state.pt"))
    b = torch.load(os.path.join(plain, "ckpt", "2", "state.pt"))
    for x, y in zip(a["params"], b["params"]):
        assert torch.equal(x, y)


def test_event_files_read_in_both_packages(tmp_path):
    ours = tb.EventWriter(str(tmp_path / "a"))
    ours.add_scalars([("train/loss", 1.5), ("train/f1", 0.25)], 3)
    ours.add_scalar("valid/loss", -2.0, 7)
    ours.close()
    theirs = jax_tb.EventWriter(str(tmp_path / "b"))
    theirs.add_scalars([("train/loss", 1.5), ("train/f1", 0.25)], 3)
    theirs.add_scalar("valid/loss", -2.0, 7)
    theirs.close()
    strip = lambda evs: [(e["step"], e.get("file_version"), e["scalars"])
                         for e in evs]
    want = strip(jax_tb.read_events(theirs.path))
    assert strip(jax_tb.read_events(ours.path)) == want
    assert strip(tb.read_events(theirs.path)) == want
    assert want[1:] == [(3, None, {"train/loss": 1.5, "train/f1": 0.25}),
                        (7, None, {"valid/loss": -2.0})]


@pytest.mark.parametrize("where", ["length_crc", "record_crc", "torn"])
def test_corrupt_event_files_are_detected(tmp_path, where):
    w = tb.EventWriter(str(tmp_path))
    w.add_scalar("x", 1.0, 1)
    w.close()
    data = bytearray(open(w.path, "rb").read())
    if where == "torn":
        data = data[:-3]
    else:
        # the second frame: 12 header bytes, then the record and its crc
        first = 16 + int.from_bytes(data[:8], "little")
        at = first + 8 if where == "length_crc" else len(data) - 1
        data[at] ^= 0x01                   # a flipped bit always differs
    with open(w.path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError):
        list(tb.read_events(w.path))


def test_metrics_logger_records(tmp_path):
    log = MetricsLogger(str(tmp_path), tensorboard=False)
    log.log(5, {"loss": np.float32(2.0), "per_track": np.arange(3.0)},
            "valid")
    log.close()
    (row,) = _records(str(tmp_path))
    assert row["step"] == 5 and row["split"] == "valid"
    assert row["loss"] == 2.0 and row["per_track"] == [0.0, 1.0, 2.0]
    assert format_metrics({"loss": 2.0, "v": np.ones(2), "f1": 0.5},
                          ("loss", "v")) == "loss=2.0000"
