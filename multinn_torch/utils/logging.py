"""Metrics sinks — the port's own copy of multinn_tpu/utils/logging.py.

The host side writes each logged step's metrics to (a) a JSONL ledger in
the run dir, one record per line with the reference's fields (``step``,
``time``, ``split`` and the metrics; vectors as lists), (b) Python logging
to the console and ``<run_dir>/train.log``, and (c) TensorBoard scalar
events through the first-party writer in utils/tb.py.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np


def setup_logger(name: str = "multinn_torch",
                 run_dir: Optional[str] = None) -> logging.Logger:
    """The package's logger: stderr, plus ``<run_dir>/train.log`` for the
    first run dir it is set up with (a process-wide logger, as in the
    reference)."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if run_dir:
        os.makedirs(run_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(run_dir, "train.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def _scalarize(v: Any):
    a = np.asarray(v)
    if a.ndim == 0:
        return float(a)
    return [float(x) for x in a.ravel()]


class MetricsLogger:
    """JSONL ledger plus TensorBoard scalars (``<run_dir>/tb``); vector
    metrics go to the JSONL only."""

    def __init__(self, run_dir: str, filename: str = "metrics.jsonl",
                 tensorboard: bool = True):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, filename)
        self._file = open(self.path, "a", buffering=1)
        self._tb = None
        if tensorboard:
            from multinn_torch.utils.tb import EventWriter
            self._tb = EventWriter(os.path.join(run_dir, "tb"))

    def log(self, step: int, metrics: Dict[str, Any],
            prefix: str = "train") -> None:
        record = {"step": int(step), "time": time.time(), "split": prefix}
        for k, v in metrics.items():
            record[k] = _scalarize(v)
        self._file.write(json.dumps(record) + "\n")
        if self._tb is not None:
            scalars = [(f"{prefix}/{k}", v) for k, v in record.items()
                       if isinstance(v, float) and k != "time"]
            if scalars:
                self._tb.add_scalars(scalars, step)

    def log_image(self, tag: str, image, step: int) -> bool:
        """A pianoroll image summary. ``image`` is an RGB uint8 (H, W, 3)
        array or a binary pianoroll ((T, K, D) / (T, D)), rendered by
        utils/images. Returns False (and writes nothing) when TensorBoard
        output is off; the JSONL ledger stays scalars-only."""
        if self._tb is None:
            return False
        from multinn_torch.utils.images import encode_png, render_pianoroll
        img = np.asarray(image)
        if not (img.ndim == 3 and img.shape[-1] == 3
                and img.dtype == np.uint8):
            img = render_pianoroll(img)
        self._tb.add_image(tag, encode_png(img), img.shape[0], img.shape[1],
                           step)
        return True

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()


def format_metrics(metrics: Dict[str, Any], keys=None) -> str:
    parts = []
    for k, v in metrics.items():
        if keys and k not in keys:
            continue
        a = np.asarray(v)
        if a.ndim == 0:
            parts.append(f"{k}={float(a):.4f}")
    return " ".join(parts)
