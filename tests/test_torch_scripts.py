"""The port's scripts (``multinn_torch/scripts``) on the CPU, at tiny sizes:

* ``prepare_dataset``: every subcommand's output equals the JAX script's
  (``scripts/prepare_dataset.py``, run as a subprocess) — the same arrays
  in the ``.npz``, the same cache-directory files byte for byte, the same
  ``.mid`` bytes, the same pickle, the same ``stats`` numbers;
* ``serve_loadtest --device cpu``: direct, open-loop, HTTP and a 1 s soak
  each answer every request and print the JAX script's JSON keys;
  ``soak_report``'s arithmetic and the refusal of ``--http --soak``;
* ``scale_stress`` at H=16, U=8, B=2, T=4, two steps: a finite MFU;
* ``ingest_bench`` and the drill's synthetic stand-in at the JAX tests'
  sizes (``tests/test_images_and_scripts.py``).
"""

import ast
import filecmp
import json
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from multinn_torch.scripts import (ingest_bench, prepare_dataset,
                                   real_corpus_drill, scale_stress,
                                   serve_loadtest)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model.n_hidden=16", "--model.n_rnn=8", "--model.gen_k=2"]


def _jax_prepare(argv, cwd):
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts/prepare_dataset.py")]
        + argv, capture_output=True, text=True, cwd=cwd, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    return r.stdout


def _port_prepare(argv, capsys):
    capsys.readouterr()
    assert prepare_dataset.main(argv) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def midi_dirs(tmp_path_factory):
    """``synth`` by each package into its own directory."""
    root = tmp_path_factory.mktemp("synth")
    _jax_prepare(["synth", "--out", str(root / "jax"), "--songs", "3"],
                 str(root))
    assert prepare_dataset.main(
        ["synth", "--out", str(root / "port"), "--songs", "3"]) == 0
    return root


def test_synth_writes_the_jax_scripts_midi_bytes(midi_dirs):
    names = sorted(os.listdir(midi_dirs / "jax"))
    assert names == [f"synth_{i:04d}.mid" for i in range(3)]
    assert sorted(os.listdir(midi_dirs / "port")) == names
    for n in names:
        assert ((midi_dirs / "port" / n).read_bytes()
                == (midi_dirs / "jax" / n).read_bytes())


@pytest.mark.parametrize("source", ["synthetic", "midi_dir"])
def test_cache_npz_equals_the_jax_scripts(midi_dirs, tmp_path, capsys,
                                          source):
    args = (["--songs", "6"] if source == "synthetic" else
            ["--preset", "lpd5", "--source", "midi_dir", "--path",
             str(midi_dirs / "jax"), "--window", "32"])
    want = _jax_prepare(["cache", "--out", str(tmp_path / "j.npz")] + args,
                        str(tmp_path))
    got = _port_prepare(["cache", "--out", str(tmp_path / "p.npz")] + args,
                        capsys)
    assert got.replace("p.npz", "j.npz") == want
    j, p = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p.npz")
    assert sorted(p.files) == sorted(j.files) == [
        "rolls_test", "rolls_train", "rolls_valid"]
    assert sum(len(j[k]) for k in j.files) > 0
    for k in j.files:
        assert p[k].dtype == j[k].dtype
        np.testing.assert_array_equal(p[k], j[k])


@pytest.mark.parametrize("source", ["synthetic", "midi_dir", "pickle"])
def test_cachedir_files_equal_the_jax_scripts(midi_dirs, tmp_path, capsys,
                                              source):
    if source == "synthetic":
        args = ["--songs", "6"]
    elif source == "midi_dir":
        args = ["--source", "midi_dir", "--path", str(midi_dirs / "jax"),
                "--window", "32"]
    else:
        pkl = tmp_path / "c.pkl"
        _jax_prepare(["synthpickle", "--out", str(pkl), "--songs", "10"],
                     str(tmp_path))
        args = ["--preset", "jsb", "--source", "pickle", "--path", str(pkl),
                "--window", "16"]
    want = _jax_prepare(["cachedir", "--out", str(tmp_path / "j")] + args,
                        str(tmp_path))
    got = _port_prepare(["cachedir", "--out", str(tmp_path / "p")] + args,
                        capsys)
    assert got.replace(str(tmp_path / "p"), str(tmp_path / "j")) == want
    names = sorted(os.listdir(tmp_path / "j"))
    assert "manifest.json" in names and "train.npy" in names
    assert sorted(os.listdir(tmp_path / "p")) == names
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "j", tmp_path / "p", names, shallow=False)
    assert (mismatch, errors) == ([], [])


def test_synthpickle_equals_the_jax_scripts(tmp_path, capsys):
    want = _jax_prepare(["synthpickle", "--out", str(tmp_path / "j.pkl"),
                         "--songs", "10"], str(tmp_path))
    got = _port_prepare(["synthpickle", "--out", str(tmp_path / "p.pkl"),
                         "--songs", "10"], capsys)
    assert got.replace("p.pkl", "j.pkl") == want
    with open(tmp_path / "j.pkl", "rb") as f:
        j = pickle.load(f)
    with open(tmp_path / "p.pkl", "rb") as f:
        p = pickle.load(f)
    assert p == j
    assert [len(j[s]) for s in ("train", "valid", "test")] == [8, 1, 1]


@pytest.mark.parametrize("args", [
    ["--songs", "4"],
    ["--preset", "lpd5", "--source", "synthetic", "--songs", "3",
     "--window", "32"],
])
def test_stats_prints_the_jax_scripts_numbers(tmp_path, capsys, args):
    want = json.loads(_jax_prepare(["stats"] + args, str(tmp_path)))
    got = json.loads(_port_prepare(["stats"] + args, capsys))
    assert got == want
    assert got["train"]["windows"] > 0 and "musical_train" in got


def _json_keys(path, var):
    """The keys a script puts in the dict it prints: the dict literal bound
    to ``var`` plus every ``var["..."] = `` assignment."""
    keys = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        t = node.targets[0]
        if (isinstance(t, ast.Name) and t.id == var
                and isinstance(node.value, ast.Dict)):
            keys |= {k.value for k in node.value.keys}
        elif (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
              and t.value.id == var and isinstance(t.slice, ast.Constant)):
            keys.add(t.slice.value)
    return keys


JAX_LOADTEST_KEYS = _json_keys(
    os.path.join(REPO, "scripts/serve_loadtest.py"), "out")


@pytest.mark.parametrize("mode,extra", [
    ("direct", ["--requests", "6", "--clients", "3"]),
    ("open-loop", ["--open-loop", "--requests", "6"]),
    ("http", ["--http", "--requests", "4", "--clients", "2"]),
    ("soak", ["--soak", "1"]),
])
def test_loadtest_answers_every_request_with_the_jax_keys(capfd, mode,
                                                          extra):
    rc = serve_loadtest.main(
        ["--config", os.path.join(REPO, "configs/synthetic_smoke.json"),
         "--device", "cpu", "--batch", "2", "--n-steps", "4"] + TINY
        + extra)
    assert rc == 0
    out = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == mode
    assert out["failed"] == 0 and out["errors"] == 0
    assert out["completed"] > 0 and out["songs_per_s"] > 0
    if mode != "soak":
        assert out["completed"] == out["requests"]
    assert (out["batch"], out["n_steps"]) == (2, 4)
    assert set(out["latency_ms"]) == {"p50", "p95", "p99"}
    want = JAX_LOADTEST_KEYS - {"bulk_n"} - ({"soak"} if mode != "soak"
                                             else set())
    assert set(out) == want
    assert _json_keys(serve_loadtest.__file__, "out") == JAX_LOADTEST_KEYS
    if mode == "soak":
        assert out["soak"]["samples"] >= 2


def test_soak_report_math():
    """RSS growth after the first sample window, latency drift = the
    last quarter's mean over the first's."""
    samples = [{"t_s": 0.0, "rss_mb": 300.0, "fds": 12, "done": 0},
               {"t_s": 2.0, "rss_mb": 320.0, "fds": 12, "done": 10},
               {"t_s": 4.0, "rss_mb": 321.0, "fds": 13, "done": 30}]
    lat = [0.1] * 8 + [0.2] * 8
    rep = serve_loadtest.soak_report(lat, samples)
    assert rep["rss_growth_after_warmup_mb"] == 1.0   # 321 - 320, not -300
    assert rep["fds_first"] == 12 and rep["fds_last"] == 13
    assert rep["latency_drift_last_vs_first_quarter"] == 2.0
    rep = serve_loadtest.soak_report([0.1], samples[:1])
    assert rep["latency_drift_last_vs_first_quarter"] == 1.0
    assert rep["rss_growth_after_warmup_mb"] == 0.0


def test_loadtest_rejects_http_soak():
    assert serve_loadtest.main(["--http", "--soak", "5"]) == 2


def test_scale_stress_reports_a_finite_mfu(capsys):
    assert scale_stress.main(["--h", "16", "--u", "8", "--batch", "2",
                              "--t", "4", "--iters", "2",
                              "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["loss_finite"] is True and out["device"] == "cpu"
    assert out["step_ms"] > 0 and out["frames_per_sec_per_chip"] > 0
    assert math.isfinite(out["mfu"]) and out["mfu"] >= 0
    assert out["peak"] == "H100 SXM f32 (outside the tensor cores)"
    assert out["gibbs_plan"] == "plain"
    assert out["config"]["H"] == 16 and out["config"]["matmul_dtype"] == "f32"


def test_ingest_bench_reports_sane_rates(capsys):
    assert ingest_bench.main(["--files", "64", "--python-files", "16"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["files"] == 64
    assert out["native_files_per_sec"] > out["python_files_per_sec"] > 0
    want = _json_keys(os.path.join(REPO, "scripts/ingest_bench.py"),
                      "result")
    assert want and set(out) == want


def test_real_corpus_drill_standin(tmp_path, capsys):
    """The stand-in drill trains (in batches of 8: the shipped 32 would
    make no full batch of the stand-in's 30 windows) and evaluates the
    shipped JSB config on the CPU and writes the anchor report; no data is an actionable skip (exit
    3); an explicit missing path and a run dir trained on other data
    refuse."""
    run_root = str(tmp_path / "runs")
    rc = real_corpus_drill.main([
        "--corpus", "jsb", "--data-root", str(tmp_path / "data"),
        "--synthetic-standin", "--run-root", run_root, "--device", "cpu",
        "--model.n_hidden=16", "--model.n_rnn=12", "--model.gen_k=2",
        "--train.epochs=1", "--train.steps_per_call=2",
        "--train.ckpt_every_steps=0", "--data.batch_size=8",
        "--generate.n_steps=48", "--generate.seed_steps=8",
    ])
    assert rc == 0
    # 30 training windows in batches of 8: the epoch takes 3 steps
    with open(os.path.join(run_root, "drill_jsb_rnnrbm_standin",
                           "eval_test.json")) as f:
        assert json.load(f)["step"] == 3
    with open(os.path.join(run_root, "drill_report.json")) as f:
        rep = json.load(f)
    row = rep["jsb_rnnrbm_standin"]
    assert row["synthetic_standin"] is True
    assert np.isfinite(row["ll_per_frame"])
    assert row["paper_anchor"]["test_ll_per_frame_2012"] == -6.27
    assert set(row["note_density"]) == {"generated", "corpus"}

    rc = real_corpus_drill.main(["--corpus", "nottingham",
                                 "--data-root", str(tmp_path / "empty"),
                                 "--run-root", run_root, "--device", "cpu"])
    assert rc == 3
    with pytest.raises(SystemExit, match="does not exist"):
        real_corpus_drill.main(["--corpus", "jsb", "--jsb",
                                str(tmp_path / "nope.pkl"),
                                "--run-root", run_root, "--device", "cpu"])
    other = tmp_path / "data" / "other.pkl"
    other.write_bytes((tmp_path / "data" / "jsb_synth.pkl").read_bytes())
    with pytest.raises(SystemExit, match="remove it or pass"):
        real_corpus_drill.main(["--corpus", "jsb", "--jsb", str(other),
                                "--run-root", run_root, "--device", "cpu",
                                "--synthetic-standin", "--train.epochs=1"])
