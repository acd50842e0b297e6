"""The harness on the CPU: parts found by name, the metric arithmetic, the
output check against sound runs and planted faults, and the rules of a
run (no JAX, no card no result)."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import control, run, spec, trace, yardstick
from portbench.traffic import serve_closed

from .conftest import REPO

SEED = 2 ** 31 + 11          # past 32 signed bits, as the driver's may be


def _run(root, cell, seed=SEED, seconds=1.5):
    return run.run_cell(cell, seed, seconds, False, device="cpu",
                        t0=time.perf_counter(), root=root)


# -- parts found by name -------------------------------------------------------

NEW_KIND = '''
def run(ctx):
    n = ctx.mix["songs"]
    return {"e2e": {"songs_per_s": n / ctx.seconds,
                    "song_latency_p95_ms": 1.0, "setup_s": 0.5},
            "records": {"kind": "echo", "songs": n},
            "checks": {"echoed": (0.0, 1.0)}, "correct": True,
            "attempted": n, "failed": 0, "memory_peak_bytes": 0}
'''

NEW_METRIC = '''
def read(rec):
    return rec["songs"] * 2.0 if rec.get("kind") == "echo" else None
'''


def test_new_files_are_found_without_editing_any(fresh_root):
    """A configuration, a cell, a traffic mix and kind, and a per-layer
    metric added as new files run with no file of the harness edited."""
    before = {p: p.read_bytes() for p in fresh_root.rglob("*.py")}
    (fresh_root / "configs" / "echo_cfg.json").write_text(json.dumps(
        {"name": "echo_cfg"}))
    (fresh_root / "traffic" / "echo_kind.py").write_text(NEW_KIND)
    (fresh_root / "traffic" / "echo_mix.json").write_text(json.dumps(
        {"kind": "echo_kind", "songs": 6}))
    (fresh_root / "workloads" / "echo_cfg.echo.json").write_text(json.dumps(
        {"config": "echo_cfg", "traffic": "echo_mix", "chips": 1,
         "limits": {}}))
    (fresh_root / "metrics" / "echo.doubled.py").write_text(NEW_METRIC)
    bench_path = fresh_root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"].startswith("song"):
            m["workloads"].append("echo_cfg.echo")
    bench["per_layer"].append({"name": "echo.doubled", "unit": "songs",
                               "better": "higher", "source": "program_counter",
                               "layer": "echo", "moves": "songs_per_s",
                               "workloads": ["echo_cfg.echo"]})
    bench_path.write_text(json.dumps(bench))

    e2e, per_layer = spec.metrics_of("echo_cfg.echo", fresh_root)
    assert set(e2e) == {"songs_per_s", "song_latency_p95_ms", "setup_s"}
    assert per_layer == ["echo.doubled"]
    assert spec.metric_reader("echo.doubled", fresh_root).read(
        {"kind": "echo", "songs": 6}) == 12.0
    line = _run(fresh_root, "echo_cfg.echo", seconds=2.0)
    assert line["correct"] and line["metrics"]["songs_per_s"]["value"] == 3.0
    assert list(line)[-1] == "checks"
    assert {p: p.read_bytes() for p in before} == before


def test_every_named_part_of_the_benchmark_exists():
    bench = spec.benchmark()
    for cfg in bench["configs"]:
        assert (REPO / cfg["file"]).is_file()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        spec.traffic_kind(cell["mix"]["kind"])
    for m in bench["per_layer"]:
        spec.metric_reader(m["name"])


# -- metric arithmetic ---------------------------------------------------------

def test_busy_is_the_union_of_intervals_never_their_sum():
    ops = [("a", 0, 50), ("b", 10, 40), ("a", 60, 70), ("c", 95, 130)]
    host = [("stage", 48, 62), ("drain", 68, 96)]
    s = trace.summary(ops, host, (0, 100))
    assert math.isclose(s["busy_s"], 65e-6)       # 50 + 10 + 5, inside
    assert math.isclose(s["window_s"], 100e-6)
    assert math.isclose(s["op_s"]["a"], 60e-6)
    assert s["op_whole"]["a"][0] == 2 and "c" not in s["op_whole"]
    assert math.isclose(s["op_whole"]["a"][1], 60e-6)
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert math.isclose(gaps["drain"], 25e-6)      # 70 .. 95
    assert math.isclose(gaps["gaps under 20 us between device operations"],
                        10e-6)                     # 50 .. 60
    assert s["breakdown"]["device_ops"][0][0] == "a"


def test_window_tail_and_rate_cover_every_request_in_the_window():
    t_end, seconds = 10.0, 10.0
    done = [(0.0, 0.1 * i, 0.0) for i in range(1, 101)]   # 0.1 .. 10.0 s
    done.append((9.9, 10.5, 0.0))                         # after the window
    rate, p95 = serve_closed.window_metrics(done, t_end, seconds)
    assert rate == 10.0
    assert math.isclose(p95, np.percentile([100.0 * i for i in
                                            range(1, 101)], 95))


def test_readers_on_synthetic_records():
    dims = yardstick.Dims(5, 84, 150, 100)
    rec = {"kind": "serve", "decoder": "rnn-rbm", "dims": dims, "gen_k": 10,
           "n_steps": 1024, "batch": 256, "window_s": 30.0, "songs": 600,
           "queue_s": [0.001, 0.003, 0.002], "batches": 10,
           "padded_rows": 256, "density": 0.06,
           "trace": {"busy_s": 27.0, "window_s": 30.0,
                     "op_whole": {"void gen_fused_rbm_kernel<true>": (4, 1.6)}}}
    read = lambda name: spec.metric_reader(name).read(rec)
    assert math.isclose(read("serve.queue_wait_p50_ms"), 2.0)
    assert math.isclose(read("serve.batch_fill"), 90.0)
    assert math.isclose(read("device_idle.serve"), 10.0)
    assert read("device_idle.train") is None
    assert read("gen_fused_nade_roofline") is None
    bound = yardstick.bound_s(*yardstick.fused_work(
        dims, "rnn-rbm", 256, 1024, 0.06 * 256 * 1024 * 5 * 84))
    assert math.isclose(read("gen_fused_rbm_roofline"), 100 * bound / 0.4)
    flops = yardstick.gen_frame_flops(dims, "rnn-rbm") * 1024 * 600
    assert math.isclose(read("serve_mfu"), 100 * flops / (30 * 67e12))


def test_train_readers_on_synthetic_records():
    dims = yardstick.Dims(5, 84, 150, 100)
    rec = {"kind": "train", "decoder": "rnn-rbm", "dims": dims, "batch": 64,
           "window": 64, "rows_per_launch": 1024, "chips": 4, "steps": 240,
           "window_s": 2.0, "group_host_s": [0.004, 0.002, 0.003],
           "density": 0.06, "cd_k": 1, "idle_by_rank": [0.1, 0.25],
           "trace": {"op_whole": {"void gibbs_rows_kernel<2, true>(float)":
                                  (20, 2e-4)}}}
    read = lambda name: spec.metric_reader(name).read(rec)
    assert math.isclose(read("train.group_host_ms"), 3.0)
    assert math.isclose(read("device_idle.train"), 25.0)
    flops = yardstick.train_step_flops(dims, "rnn-rbm", 64, 64) * 240
    assert math.isclose(read("train_mfu"), 100 * flops / (2.0 * 67e12 * 4))
    bound = yardstick.bound_s(*yardstick.gibbs_cd1_work(
        1024, 0.06 * 1024 * 84, 84, 150))
    assert math.isclose(read("gibbs_chain_roofline"), 100 * 20 * bound / 2e-4)
    assert read("serve_mfu") is None and read("device_idle.serve") is None


def test_frozen_counts_equal_the_programs_at_the_flagship():
    from multinn_torch.models.multinn import MultINNConfig
    from multinn_torch.utils import flops
    dims = yardstick.Dims(5, 84, 150, 100)
    for dec in ("rnn-rbm", "rnn-nade"):
        cfg = MultINNConfig(n_tracks=5, n_pitches=84, mode="feedback",
                            decoder_type=dec)
        assert yardstick.train_step_flops(dims, dec, 16, 64) == \
            flops.train_step_flops(cfg, 16, 64)
        gen = (flops.gen_step_flops_rbm if dec == "rnn-rbm"
               else flops.gen_step_flops_nade)(cfg, 1)["model"]
        assert yardstick.gen_frame_flops(dims, dec) == gen


# -- the output check ----------------------------------------------------------

@pytest.mark.parametrize("cell", ["tiny_rbm.serve", "tiny_nade.serve",
                                  "tiny_rbm.train", "tiny_rbm.train_data4"])
def test_a_sound_run_is_correct(tiny_root, cell):
    line = _run(tiny_root, cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("tiny_rbm.serve", "token_altered"), ("tiny_nade.serve", "token_altered"),
    ("tiny_rbm.train", "state_unchanged"), ("tiny_rbm.train", "half_batch"),
    ("tiny_rbm.train_data4", "no_exchange"),
    ("tiny_rbm.train_data4", "half_batch")])
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    out = control.run(cell, SEED, 1.5, fault, device="cpu", root=tiny_root)
    assert not out["correct"], out["checks"]


def test_lower_precision_rounds_each_leaf_one_step_down():
    import torch
    w = {"w": torch.linspace(-0.03, 0.03, 101), "wh": torch.full((3,), 0.1)}
    low = control.lower_precision(w, "rnn-nade")
    assert torch.equal(low["wh"], w["wh"].bfloat16().float())
    assert not torch.equal(low["w"], w["w"].bfloat16().float())
    assert torch.equal(low["w"].bfloat16().float(), low["w"])   # fp8 in bf16
    rbm = control.lower_precision(w, "rnn-rbm")
    assert torch.equal(rbm["w"], w["w"].bfloat16().float())


# -- rules of a run --------------------------------------------------------------

def test_no_jax_is_loaded():
    code = ("import sys, portbench.run, portbench.control, "
            "portbench.reference.model, portbench.traffic.serve_closed, "
            "portbench.traffic.train_groups; "
            "import multinn_torch.serving.service, "
            "multinn_torch.training.trainer; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    names = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not names & {"jax", "jaxlib", "flax", "multinn_tpu"}


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "rbm_flagship.serve", "--seed", "1", "--seconds", "1"],
        cwd=REPO, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
