"""Out-of-core window cache — the port's own copy of
multinn_tpu/data/cache.py, byte-compatible with it: a cache written by
either package loads in the other.

A cache directory holds one plain ``.npy`` per split — ``{split}.npy``
uint8 (N, window, K, D) and ``{split}_mask.npy`` uint8 (N, window) — and
``manifest.json`` with the roll spec and encoding. Plain ``.npy`` because
``np.load(mmap_mode="r")`` maps it: an epoch touches only the pages its
batches index, so the corpus is bounded by disk, not RAM.

The writer streams: songs are encoded and chopped one at a time and their
windows appended to per-split ``.part`` spools, real ``.npy`` files whose
header has a fixed-width row count patched in place at the end; each spool
``os.replace``s into place once the corpus is known usable, and the
manifest is written last, so a crash mid-rebuild leaves the old cache or a
loudly rejected directory. ``load_cache`` checks every array's shape
against the manifest and the manifest against the DataConfig.

Split assignment is ``datasets.assign_splits`` over the song list, the
fractions and minimums of ``Dataset``'s in-memory split.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np

from multinn_torch.data import pianoroll as pr

MANIFEST = "manifest.json"
SPLITS = ("train", "valid", "test")
_VERSION = 1


def _manifest_of(cfg) -> dict:
    return {
        "version": _VERSION,
        "window": cfg.window,
        "n_tracks": cfg.n_tracks,
        "frame_dim": cfg.frame_dim,
        "encoding": cfg.encoding,
        "pitch_min": cfg.pitch_min,
        "pitch_max": cfg.pitch_max,
        "steps_per_quarter": cfg.steps_per_quarter,
    }


def song_windows(roll: np.ndarray, cfg) -> Tuple[np.ndarray, np.ndarray]:
    """One song's (windows, masks) in MODEL space — the same encode-then-chop
    the in-memory Dataset applies (encode on the full roll: hold channels
    need the true previous frame)."""
    if cfg.encoding == "onset_hold":
        roll = pr.encode_onset_hold(roll)
    return pr.chop_windows_masked(roll, cfg.window)


def _npy_header(n: int, tail_shape: Tuple[int, ...]) -> bytes:
    """A v1.0 .npy header whose ROW COUNT is a fixed-width (space-padded)
    decimal field, so the header for any count of up to 20 digits is the
    same byte length — writable up-front with n=0 and patched in place
    (seek 0) at finalize. ast.literal_eval (numpy's header parser) accepts
    the padding spaces."""
    dic = ("{'descr': '|u1', 'fortran_order': False, 'shape': (%20d, %s), }"
           % (n, ", ".join(str(d) for d in tail_shape)))
    # v1.0 framing: magic(6) + version(2) + header_len(u16 LE) + text,
    # space-padded so the total is a multiple of 64, '\n'-terminated
    base = 6 + 2 + 2
    pad = (-(base + len(dic) + 1)) % 64
    text = (dic + " " * pad + "\n").encode("latin1")
    return b"\x93NUMPY\x01\x00" + struct.pack("<H", len(text)) + text


class _SplitSpool:
    """Append-only .npy spool for one split: header written up-front with a
    patchable count, rows streamed behind it, count patched + atomically
    renamed into place at finalize."""

    def __init__(self, out_dir: str, split: str,
                 tail_shapes: Tuple[Tuple[int, ...], Tuple[int, ...]]):
        self.split = split
        self.n = 0
        self._tails = tail_shapes
        self.paths = (os.path.join(out_dir, f"{split}.npy"),
                      os.path.join(out_dir, f"{split}_mask.npy"))
        self._tmp = tuple(p + ".part" for p in self.paths)
        self._files = tuple(open(t, "wb") for t in self._tmp)
        for f, tail in zip(self._files, self._tails):
            f.write(_npy_header(0, tail))

    def append(self, windows: np.ndarray, masks: np.ndarray) -> None:
        self._files[0].write(np.ascontiguousarray(windows, np.uint8))
        self._files[1].write(np.ascontiguousarray(masks, np.uint8))
        self.n += len(windows)

    def finalize(self) -> None:
        """Patch the row count and move into place (os.replace = atomic)."""
        for f, tmp, path, tail in zip(self._files, self._tmp, self.paths,
                                      self._tails):
            header = _npy_header(self.n, tail)
            f.seek(0)
            f.write(header)
            f.close()
            os.replace(tmp, path)

    def abort(self) -> None:
        for f, tmp in zip(self._files, self._tmp):
            f.close()
            if os.path.exists(tmp):
                os.remove(tmp)


def write_cache(out_dir: str, cfg,
                songs: Iterable[Tuple[str, np.ndarray]]) -> Dict[str, int]:
    """Stream (split, frame-space roll) pairs into a cache directory.
    Returns {split: n_windows}. O(one song) peak memory; a failed rebuild
    leaves any pre-existing cache untouched (spools are .part files and the
    usability check runs BEFORE anything replaces the old artifacts)."""
    os.makedirs(out_dir, exist_ok=True)
    tails = ((cfg.window, cfg.n_tracks, cfg.frame_dim), (cfg.window,))
    spools = {s: _SplitSpool(out_dir, s, tails) for s in SPLITS}
    try:
        for split, roll in songs:
            w, m = song_windows(roll, cfg)
            if len(w):
                spools[split].append(w, m)
        if spools["train"].n == 0:
            raise ValueError(f"window cache {out_dir!r}: no train windows "
                             "(empty/unusable corpus)")
    except BaseException:
        for spool in spools.values():
            spool.abort()
        raise
    for spool in spools.values():
        spool.finalize()
    counts = {s: sp.n for s, sp in spools.items()}
    # manifest LAST, atomically: its presence certifies a complete cache
    mf_tmp = os.path.join(out_dir, MANIFEST + ".part")
    with open(mf_tmp, "w") as f:
        json.dump(dict(_manifest_of(cfg), n_windows=counts), f, indent=2)
    os.replace(mf_tmp, os.path.join(out_dir, MANIFEST))
    return counts


def write_cache_from_dataset(ds, out_dir: str) -> Dict[str, int]:
    """Exact dump of an already-built in-memory Dataset (fits-in-RAM corpora
    and pre-split pickle sources): preserves its split assignment and window
    contents bit-for-bit."""
    cfg = ds.cfg
    os.makedirs(out_dir, exist_ok=True)
    counts = {}
    for split in SPLITS:
        w = np.ascontiguousarray(ds.windows[split], np.uint8)
        m = np.ascontiguousarray(ds.masks[split], np.uint8)
        np.save(os.path.join(out_dir, f"{split}.npy"), w)
        np.save(os.path.join(out_dir, f"{split}_mask.npy"), m)
        counts[split] = len(w)
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(dict(_manifest_of(cfg), n_windows=counts), f, indent=2)
    return counts


def iter_midi_dir(cfg, use_native=None) -> Iterator[Tuple[str, np.ndarray]]:
    """(split, roll) stream over a MIDI directory, one file in memory at a
    time (native C++ fast path when buildable; file list, parser dispatch
    and corrupt-skip set are SHARED with the in-memory load_midi_dir).
    Corrupt files are skipped — their pre-assigned split slot simply yields
    nothing, so corruption never reshuffles other songs between splits."""
    from multinn_torch.data import native
    from multinn_torch.data.datasets import (assign_splits, list_midi_files,
                                             parse_midi_file)
    if use_native is None:
        use_native = native.available()
    spec = cfg.spec()
    files = list_midi_files(cfg.path)
    if not files:
        raise ValueError(f"no .mid/.midi files under {cfg.path!r}")
    splits = assign_splits(len(files), cfg.splits, cfg.seed)
    for f, split in zip(files, splits):
        roll = parse_midi_file(f, spec, use_native)
        if roll is not None:
            yield split, roll


def iter_synthetic(cfg) -> Iterator[Tuple[str, np.ndarray]]:
    from multinn_torch.data.datasets import assign_splits, synthetic_song
    rng = np.random.default_rng(cfg.seed)
    splits = assign_splits(cfg.synthetic_songs, cfg.splits, cfg.seed)
    for i in range(cfg.synthetic_songs):
        # draw in index order so song i is identical to synthetic_corpus's
        yield splits[i], synthetic_song(rng, cfg.synthetic_steps,
                                        cfg.n_tracks, cfg.n_pitches)


def load_cache(path: str, cfg) -> Tuple[Dict[str, np.ndarray],
                                        Dict[str, np.ndarray]]:
    """Memory-map a cache directory; validates the manifest against the
    DataConfig LOUDLY (a silently mismatched window/encoding/pitch-range
    would train on garbage)."""
    mf_path = os.path.join(path, MANIFEST)
    if not os.path.exists(mf_path):
        raise ValueError(f"{path!r} is not a window cache (no {MANIFEST}; "
                         "build one with scripts/prepare_dataset.py cachedir)")
    with open(mf_path) as f:
        manifest = json.load(f)
    if manifest.get("version") != _VERSION:
        raise ValueError(f"window cache {path!r} has version "
                         f"{manifest.get('version')}, expected {_VERSION}")
    want = _manifest_of(cfg)
    mismatch = {k: (manifest.get(k), v) for k, v in want.items()
                if k != "version" and manifest.get(k) != v}
    if mismatch:
        raise ValueError(
            f"window cache {path!r} does not match data config: "
            + ", ".join(f"{k}: cache={a!r} config={b!r}"
                        for k, (a, b) in sorted(mismatch.items())))
    windows, masks = {}, {}
    n_windows = manifest.get("n_windows", {})
    for split in SPLITS:
        windows[split] = np.load(os.path.join(path, f"{split}.npy"),
                                 mmap_mode="r")
        masks[split] = np.load(os.path.join(path, f"{split}_mask.npy"),
                               mmap_mode="r")
        # arrays must agree with the manifest — a crash mid-rebuild can
        # leave fresh .npy files beside a stale manifest; reject loudly
        # instead of training on silently mismatched windows
        n = n_windows.get(split)
        want_w = (n, cfg.window, cfg.n_tracks, cfg.frame_dim)
        want_m = (n, cfg.window)
        if windows[split].shape != want_w or masks[split].shape != want_m:
            raise ValueError(
                f"window cache {path!r} split '{split}' is inconsistent "
                f"with its manifest: arrays {windows[split].shape}/"
                f"{masks[split].shape}, manifest expects {want_w}/{want_m} "
                "(interrupted rebuild? re-run prepare_dataset.py cachedir)")
    if not len(windows["train"]):
        raise ValueError(f"window cache {path!r} has no train windows")
    return windows, masks
