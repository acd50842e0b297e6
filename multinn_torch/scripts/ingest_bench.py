"""Corpus-scale MIDI ingest rate — the port's counterpart of
``scripts/ingest_bench.py``, over ``multinn_torch.data.native`` and
``multinn_torch.data.midi``.

Writes N distinct .mid files once (first-party writer), then measures
file -> pianoroll throughput for the native C++ reader
(native/midi_fast.cpp through ctypes) and for the pure-Python reader.
Lakh holds about 10^5 files; the full corpus's cost at the measured native
rate is reported as an ingest budget.

    python -m multinn_torch.scripts.ingest_bench [--files 10000] \\
        [--python-files 300]

Prints one JSON line with the JAX script's keys. Host only: ingest feeds
the batcher, not the card, so there is no ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from multinn_torch.data import midi, native, pianoroll as pr
from multinn_torch.data.datasets import synthetic_corpus
from multinn_torch.utils.config import DataConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, allow_abbrev=False,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--files", type=int, default=10000)
    ap.add_argument("--python-files", type=int, default=300,
                    help="subset for the (slow) pure-Python rate")
    ap.add_argument("--steps", type=int, default=256,
                    help="grid steps per synthetic song (~4x a JSB chorale)")
    ap.add_argument("--keep-dir", default=None,
                    help="write files here and keep them (default: tmp)")
    args = ap.parse_args(argv)

    if not native.available():
        print(json.dumps({"error": "native library unavailable"}))
        return 1

    out_dir = args.keep_dir or tempfile.mkdtemp(prefix="ingest_bench_")
    os.makedirs(out_dir, exist_ok=True)
    try:
        cfg = DataConfig.from_preset("lpd5", synthetic_songs=64,
                                     synthetic_steps=args.steps)
        spec = cfg.spec()
        # 64 distinct songs cycled under distinct file names: the parse cost
        # is per file, and the variety defeats any warm-path shortcut
        blobs = [midi.dumps(pr.roll_to_midi(r, spec))
                 for r in synthetic_corpus(cfg)]
        t0 = time.perf_counter()
        paths = []
        for i in range(args.files):
            p = os.path.join(out_dir, f"s{i:06d}.mid")
            with open(p, "wb") as f:
                f.write(blobs[i % len(blobs)])
            paths.append(p)
        write_s = time.perf_counter() - t0
        total_bytes = sum(len(blobs[i % len(blobs)])
                          for i in range(args.files))

        # native path: parse and quantize each file
        t0 = time.perf_counter()
        n_notes = 0
        for p in paths:
            n_notes += int(native.midi_file_to_roll(p, spec).sum())
        native_s = time.perf_counter() - t0
        native_fps = len(paths) / native_s

        # the Python reader on a subset
        sub = paths[:min(args.python_files, len(paths))]
        t0 = time.perf_counter()
        for p in sub:
            pr.midi_to_roll(midi.load(p), spec)
        py_s = time.perf_counter() - t0
        py_fps = len(sub) / py_s if sub else 0.0
    finally:
        if args.keep_dir is None:
            shutil.rmtree(out_dir, ignore_errors=True)

    print(json.dumps({
        "files": len(paths),
        "grid_steps_per_file": args.steps,
        "native_files_per_sec": round(native_fps, 1),
        "python_files_per_sec": round(py_fps, 1),
        "native_speedup": round(native_fps / py_fps, 1) if py_fps else None,
        "native_total_s": round(native_s, 2),
        "mb_per_sec_native": round(total_bytes / native_s / 1e6, 1),
        "lakh_100k_files_est_min": round(1e5 / native_fps / 60, 1),
        "write_files_per_sec": round(len(paths) / write_s, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
