"""Where the benchmark finds its parts, by name, so that a cell, a
configuration, a traffic mix, a traffic kind or a per-layer metric is
added as a new file and nothing that exists is edited:

  * a cell: ``workloads/<cell>.json`` with its ``config``, ``traffic``
    and ``chips``, and the limits of its output check (``limits``);
  * a configuration: ``configs/<config>.json``;
  * a traffic mix: ``traffic/<traffic>.json``, the parameters of one
    traffic ``kind``;
  * a traffic kind: ``traffic/<kind>.py``, whose ``run(ctx)`` sets the
    cell up, measures its window and checks its output;
  * a per-layer metric: ``metrics/<metric>.py``, whose ``read(records)``
    returns the metric's value, or None where the run has nothing for it
    to read.

``BENCHMARK.json`` beside this package says which end-to-end and
per-layer metrics each cell reports.
"""

from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration and traffic mix loaded
    (``cfg``, ``mix``)."""
    c = dict(_json(root / "workloads" / f"{name}.json"), name=name)
    c["cfg"] = _json(root / "configs" / f"{c['config']}.json")
    c["mix"] = _json(root / "traffic" / f"{c['traffic']}.json")
    return c


def traffic_kind(kind: str, root: Path = ROOT):
    return _module(root / "traffic" / f"{kind}.py",
                   f"portbench_traffic_{kind}")


def metric_reader(name: str, root: Path = ROOT):
    return _module(root / "metrics" / f"{name}.py",
                   "portbench_metric_" + name.replace(".", "_"))


def benchmark(root: Path = ROOT) -> dict:
    return _json(root.parent / "BENCHMARK.json")


def _applies(entry: dict, cell_name: str, e2e_names) -> bool:
    if "workloads" in entry:
        return cell_name in entry["workloads"]
    return entry.get("moves", entry["name"]) in e2e_names


def metrics_of(cell_name: str, root: Path = ROOT):
    """(end-to-end names, per-layer names) that ``BENCHMARK.json`` gives
    the cell."""
    bench = benchmark(root)
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if _applies(m, cell_name, e2e)]
    return e2e, per_layer


def units(root: Path = ROOT) -> dict:
    bench = benchmark(root)
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}


def scratch_dir() -> str:
    """A directory for a run's temporary files, under the run's TMPDIR."""
    import tempfile
    return tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
