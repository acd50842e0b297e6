"""Checkpoints — port of multinn_tpu/training/checkpoint.py with torch state
dicts in place of orbax.

A checkpoint is one directory ``<dir>/<step>/`` holding ``state.pt`` (the
trainer's state dict: tensors on the CPU, ints and floats, loaded with
``weights_only=True``) and ``metrics.json`` (the save's metrics, or null).
Each save is written into a temporary directory ``.tmp-<step>-<pid>`` and
moved into place with one ``os.replace``, so a crash leaves the step whole
or absent; leftover temporaries are never listed as steps.

Retention is the reference's policy: the last ``keep_last`` steps plus,
with ``keep_best``, the one with the least ``valid_loss``; a save without
metrics is never kept as best, so periodic saves fall out of the window. A
step that already exists is refused and ``save`` returns False. Saves are
synchronous: ``wait`` and ``close`` exist for the reference's interface.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

_STATE, _METRICS = "state.pt", "metrics.json"


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3,
                 keep_best: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last = keep_last
        self.keep_best = keep_best

    def _path(self, step: int, name: str = "") -> str:
        return os.path.join(self.directory, str(step), name)

    def all_steps(self) -> List[int]:
        """The complete checkpoints' steps, ascending."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.exists(self._path(int(n), _STATE)))

    def _metrics(self, step: int) -> Optional[Dict[str, float]]:
        try:
            with open(self._path(step, _METRICS)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def save(self, step: int, state: Dict[str, Any],
             metrics: Optional[Dict[str, float]] = None) -> bool:
        """Write ``state`` as step ``step``; False when the step exists."""
        if os.path.exists(self._path(step)):
            return False
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, _STATE))
        with open(os.path.join(tmp, _METRICS), "w") as f:
            json.dump(metrics, f)
        os.replace(tmp, self._path(step))
        self._collect()
        return True

    def _collect(self) -> None:
        steps = self.all_steps()
        keep = set(steps[-self.keep_last:] if self.keep_last > 0 else ())
        best = self.best_step()
        if best is not None:
            keep.add(best)
        for step in steps:
            if step not in keep:
                shutil.rmtree(self._path(step), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The step with the least ``valid_loss`` (the latest of equals, as
        orbax picks); None without ``keep_best`` or without a save that has
        metrics."""
        if not self.keep_best:
            return None
        scored = [(m["valid_loss"], -step) for step in self.all_steps()
                  for m in [self._metrics(step)]
                  if m and "valid_loss" in m]
        return -min(scored)[1] if scored else None

    def restore(self, step: Optional[int] = None
                ) -> Tuple[Dict[str, Any], int]:
        """The state dict of ``step`` (the latest when None), on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = self._path(step, _STATE)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint at step {step} in "
                                    f"{self.directory}")
        return torch.load(path, map_location="cpu", weights_only=True), step

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass
