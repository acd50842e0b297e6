"""Fixtures of the benchmark's tests: a copy of the benchmark with tiny
cells beside the real ones, run on the CPU through the program's plain
paths (the harness's look for a card is skipped by calling
``run.run_cell`` directly)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY_MODEL = dict(n_tracks=2, n_pitches=8, n_hidden=6, n_rnn=4, gen_k=2)


def _tiny_copy(dst: Path) -> Path:
    """``dst``/portbench with the cells ``tiny_rbm.serve``,
    ``tiny_nade.serve`` and ``tiny_rbm.train``: the flagships' files at
    tiny widths, held to the real cells' limits."""
    root = dst / "portbench"
    shutil.copytree(REPO / "portbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    load = lambda p: json.loads((root / p).read_text())
    save = lambda p, obj: (root / p).write_text(json.dumps(obj, indent=1))
    for fam in ("rbm", "nade"):
        c = load(f"configs/{fam}_flagship.json")
        c["name"] = f"tiny_{fam}"
        c["model"].update(TINY_MODEL)
        c["pitches"] = [60, 67]
        c["train"].update(batch_size=4, window=8, steps_per_call=3)
        c["bv_shift"] = 1.0
        save(f"configs/tiny_{fam}.json", c)
        cell = load(f"workloads/{fam}_flagship.serve.json")
        save(f"workloads/tiny_{fam}.serve.json",
             dict(cell, config=f"tiny_{fam}", traffic="tiny_closed"))
    save("workloads/tiny_rbm.train.json",
         dict(load("workloads/rbm_flagship.train.json"), config="tiny_rbm",
              traffic="tiny_windows"))
    save("workloads/tiny_rbm.train_data4.json",
         dict(load("workloads/rbm_flagship.train.json"), config="tiny_rbm",
              traffic="tiny_windows", chips=4,
              mesh={"data": 4, "style": "gspmd"}))
    save("traffic/tiny_closed.json",
         dict(load("traffic/closed_64bar.json"), n_steps=16, batch=8,
              check_songs=4))
    save("traffic/tiny_windows.json",
         dict(load("traffic/bernoulli_windows.json"), pool_windows=64))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        for w in list(m.get("workloads", ())):
            m["workloads"].append(w.replace("rbm_flagship", "tiny_rbm")
                                  .replace("nade_flagship", "tiny_nade"))
            if w == "rbm_flagship.train":
                m["workloads"].append("tiny_rbm.train_data4")
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return _tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def fresh_root(tmp_path) -> Path:
    return _tiny_copy(tmp_path)
