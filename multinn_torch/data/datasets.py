"""Dataset loaders and the batcher — the port's own copy of
multinn_tpu/data/datasets.py: the same sources, splits, windows, masks,
shuffles and transpositions, so both packages yield the same uint8 batches
byte for byte.

Sources:

  * ``midi_dir``  — a directory of .mid files through the first-party
                    reader (the native one where its library loads).
  * ``npz``       — an .npz of pianorolls (key 'rolls': an object array or
                    one stacked array, (T, K, D) or (T, D) each; per-split
                    keys 'rolls_train' etc. keep their split).
  * ``pickle``    — the Boulanger-Lewandowski corpus pickle:
                    {'train'|'valid'|'test': [sequence = [tuple of active
                    MIDI pitches per step]]}, its split respected.
  * ``synthetic`` — a deterministic in-memory corpus from ``data.seed``.
  * ``cache_dir`` — a memory-mapped window cache (data/cache.py), the
                    out-of-core path for corpora beyond host RAM.

The batcher chops every roll into fixed windows (stateless truncated BPTT),
splits train / valid / test and yields uint8 host batches; the trainer
moves them to the card and casts there (1 byte a cell over PCIe, not 4).
``DataConfig`` and the corpus ``PRESETS`` live in utils/config.py.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from multinn_torch.data import midi as midi_mod
from multinn_torch.data import pianoroll as pr
from multinn_torch.utils.config import DataConfig

# ---------------------------------------------------------------------------
# synthetic corpus
# ---------------------------------------------------------------------------

_MAJOR = np.array([0, 2, 4, 5, 7, 9, 11])


def synthetic_song(rng: np.random.Generator, n_steps: int, n_tracks: int,
                   n_pitches: int) -> np.ndarray:
    """A deterministic musical-ish multitrack roll: drum grid, walking bass,
    block chords, scale melody. Enough temporal/inter-track structure for
    models to measurably learn."""
    roll = np.zeros((n_steps, n_tracks, n_pitches), np.uint8)
    root = int(rng.integers(2, 14))
    scale = (root + _MAJOR[None, :] + 12 * np.arange(6)[:, None]).ravel()
    scale = scale[scale < n_pitches]

    def put(t, k, p):
        if 0 <= p < n_pitches:
            roll[t, k % n_tracks, p] = 1

    melody = int(rng.integers(len(scale) // 2, len(scale) - 1))
    for t in range(n_steps):
        if n_tracks >= 5:
            # drums: kick every 4, snare off-beat, hats every 2
            if t % 4 == 0:
                put(t, 0, 4)
            if t % 8 == 4:
                put(t, 0, 8)
            if t % 2 == 0:
                put(t, 0, 18)
            # bass: roots on beats, walking
            if t % 4 == 0:
                put(t, 3, int(scale[(t // 4) % 4]))
            # piano: block chord every bar (16 steps), held 8
            c = (t // 16) % 3
            if t % 16 < 8:
                for off in (0, 2, 4):
                    put(t, 1, int(scale[(c + off) % len(scale)]))
            # guitar: arpeggio
            put(t, 2, int(scale[(c + (t % 4)) % len(scale)]))
        # melody (track last, or the only track): random scale walk, 8th notes
        if t % 2 == 0:
            melody = int(np.clip(melody + rng.integers(-2, 3),
                                 0, len(scale) - 1))
            put(t, n_tracks - 1, int(scale[melody]))
            if n_tracks == 1 and t % 16 == 0:    # chorale-ish: add a 3rd+5th
                put(t, 0, int(scale[max(0, melody - 2)]))
                put(t, 0, int(scale[max(0, melody - 4)]))
    return roll


def synthetic_corpus(cfg: DataConfig) -> List[np.ndarray]:
    rng = np.random.default_rng(cfg.seed)
    return [synthetic_song(rng, cfg.synthetic_steps, cfg.n_tracks,
                           cfg.n_pitches)
            for _ in range(cfg.synthetic_songs)]


# ---------------------------------------------------------------------------
# file loaders
# ---------------------------------------------------------------------------

def list_midi_files(path: str) -> List[str]:
    """The corpus file list, sorted — ONE definition shared by the in-memory
    loader and the streaming cache writer so both see the same song set."""
    return sorted(glob.glob(os.path.join(path, "**", "*.mid"),
                            recursive=True)
                  + glob.glob(os.path.join(path, "**", "*.midi"),
                              recursive=True))


def parse_midi_file(f: str, spec: pr.RollSpec,
                    use_native: bool) -> Optional[np.ndarray]:
    """One file -> roll, or None for corrupt/unparseable files (the shared
    skip set — C++ and Python agree on accept/reject, test_native.py)."""
    from multinn_torch.data import native
    try:
        if use_native:
            return native.midi_file_to_roll(f, spec)
        return pr.midi_to_roll(midi_mod.load(f), spec)
    except (midi_mod.MidiParseError, ValueError, OSError, IndexError):
        return None


def load_midi_dir(path: str, spec: pr.RollSpec,
                  use_native: Optional[bool] = None) -> List[np.ndarray]:
    """Parse every .mid under ``path``. Uses the native C++ fast path
    (data/native.py, bit-exact with the Python reader) when the shared
    library loads; ``use_native=False`` forces pure Python."""
    from multinn_torch.data import native
    if use_native is None:
        use_native = native.available()
    rolls = []
    for f in list_midi_files(path):
        roll = parse_midi_file(f, spec, use_native)
        if roll is not None:
            rolls.append(roll)
    return rolls


def assign_splits(n: int, splits, seed: int) -> List[str]:
    """Seeded permutation split assignment over n songs: the fractions and
    minimums of Dataset.__init__'s in-memory split below (keep the two in
    sync; Dataset keeps its own id order because the window concatenation
    order fixes the batch stream)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    n_train = max(1, int(splits[0] * n))
    n_valid = max(1, int(splits[1] * n)) if n > 2 else 0
    out = [""] * n
    for rank, idx in enumerate(order):
        out[idx] = ("train" if rank < n_train
                    else "valid" if rank < n_train + n_valid else "test")
    return out


def _check_rolls(arrs, spec: pr.RollSpec) -> List[np.ndarray]:
    out = []
    for a in arrs:
        a = np.asarray(a)
        if a.ndim == 2:
            a = a[:, None, :]
        if a.shape[-1] != spec.n_pitches:
            raise ValueError(f"npz roll pitch dim {a.shape[-1]} != spec "
                             f"{spec.n_pitches}")
        out.append((a > 0).astype(np.uint8))
    return out


def load_npz(path: str, spec: pr.RollSpec):
    """Load pianorolls from .npz. Returns either a flat list of rolls (keys
    'rolls' or arbitrary arrays — gets re-split downstream) or, when the
    per-split keys written by ``scripts/prepare_dataset.py cache`` are
    present ('rolls_train' etc.), a {split: [rolls]} dict whose original
    split assignment is preserved."""
    data = np.load(path, allow_pickle=True)
    split_keys = [k for k in data.files if k.startswith("rolls_")]
    if split_keys:
        return {k[len("rolls_"):]: _check_rolls(list(data[k]), spec)
                for k in split_keys}
    if "rolls" in data:
        arrs = list(data["rolls"])
    else:
        arrs = [data[k] for k in sorted(data.files)]
    return _check_rolls(arrs, spec)


def _tuples_to_roll(seq, spec: pr.RollSpec) -> np.ndarray:
    roll = np.zeros((len(seq), 1, spec.n_pitches), np.uint8)
    for t, active in enumerate(seq):
        for pitch in active:
            p = int(pitch) - spec.pitch_min
            if 0 <= p < spec.n_pitches:
                roll[t, 0, p] = 1
    return roll


def load_pickle(path: str, spec: pr.RollSpec) -> Dict[str, List[np.ndarray]]:
    """Boulanger-Lewandowski corpus pickle with its OWN train/valid/test
    split (respected rather than re-split)."""
    with open(path, "rb") as f:
        raw = pickle.load(f, encoding="latin-1")
    return {split: [_tuples_to_roll(s, spec) for s in raw[split]]
            for split in ("train", "valid", "test") if split in raw}


# ---------------------------------------------------------------------------
# Dataset: windows + splits + batching
# ---------------------------------------------------------------------------

class Dataset:
    """Windowed pianoroll dataset with train/valid/test splits.

    windows[split]: (N, window, K, D) uint8.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        spec = cfg.spec()
        presplit: Optional[Dict[str, List[np.ndarray]]] = None
        if cfg.source != "synthetic":
            # Loud failure, not a silent fallback: an empty path would glob
            # the CWD (midi_dir) or crash confusingly (npz/pickle), silently
            # training on whatever .mid files happen to be lying around.
            if not cfg.path:
                raise ValueError(
                    f"data source '{cfg.source}' (dataset "
                    f"'{cfg.dataset}') requires data.path — none given")
            if not os.path.exists(cfg.path):
                raise ValueError(
                    f"data.path {cfg.path!r} does not exist "
                    f"(source '{cfg.source}', dataset '{cfg.dataset}')")
        if cfg.source == "cache_dir":
            # out-of-core: splits stay memory-mapped on disk; batches()
            # fancy-indexes them, materializing only the sampled windows
            from multinn_torch.data import cache as cache_mod
            self.windows, self.masks = cache_mod.load_cache(cfg.path, cfg)
            self._fill_empty_splits()
            return
        if cfg.source == "synthetic":
            rolls = synthetic_corpus(cfg)
        elif cfg.source == "midi_dir":
            rolls = load_midi_dir(cfg.path, spec)
        elif cfg.source == "npz":
            loaded = load_npz(cfg.path, spec)
            if isinstance(loaded, dict):        # pre-split cache
                presplit = loaded
                rolls = []
            else:
                rolls = loaded
        elif cfg.source == "pickle":
            presplit = load_pickle(cfg.path, spec)
            rolls = []
        else:
            raise ValueError(f"unknown source '{cfg.source}'")

        self.masks: Dict[str, np.ndarray] = {}

        def windows_of(rs: Sequence[np.ndarray], split: Optional[str] = None):
            ws, ms = [], []
            for r in rs:
                if cfg.encoding == "onset_hold":
                    # encode on the FULL roll (hold needs the true previous
                    # frame), then window — first-frame holds at a window
                    # boundary lose their cross-window note, same truncation
                    # the stateless-BPTT windowing already applies (§5.7)
                    r = pr.encode_onset_hold(r)
                w, m = pr.chop_windows_masked(r, cfg.window)
                if len(w):
                    ws.append(w)
                    ms.append(m)
            if not ws:
                empty = np.zeros(
                    (0, cfg.window, cfg.n_tracks, cfg.frame_dim), np.uint8)
                if split is not None:
                    self.masks[split] = np.zeros((0, cfg.window), np.uint8)
                return empty
            if split is not None:
                self.masks[split] = np.concatenate(ms)
            return np.concatenate(ws)

        if presplit is not None:
            # corpus pickles carry their own canonical split — respect it
            self.windows = {k: windows_of(v, split=k)
                            for k, v in presplit.items()}
            if "train" not in self.windows:
                raise ValueError(
                    f"pre-split source {cfg.path!r} has no 'train' split "
                    f"(found: {sorted(self.windows)})")
            if "valid" not in self.windows:
                self.windows["valid"] = self.windows.get(
                    "test", windows_of([], "valid"))
                self.masks["valid"] = self.masks.get(
                    "test", self.masks.get("valid",
                                           np.zeros((0, cfg.window),
                                                    np.uint8)))
            if "test" not in self.windows:
                self.windows["test"] = self.windows["valid"]
                self.masks["test"] = self.masks["valid"]
        else:
            if not rolls:
                raise ValueError(
                    f"no usable rolls from source={cfg.source} "
                    f"path={cfg.path!r}")
            # the fractions and minimums of assign_splits (the streamed
            # cache must partition alike); ids stay in permutation order
            # because the window concatenation order fixes the batch stream
            rng = np.random.default_rng(cfg.seed)
            order = rng.permutation(len(rolls))
            n = len(rolls)
            n_train = max(1, int(cfg.splits[0] * n))
            n_valid = max(1, int(cfg.splits[1] * n)) if n > 2 else 0
            train_ids = order[:n_train]
            valid_ids = order[n_train:n_train + n_valid]
            test_ids = order[n_train + n_valid:]
            self.windows = {
                "train": windows_of([rolls[i] for i in train_ids], "train"),
                "valid": windows_of([rolls[i] for i in valid_ids], "valid"),
                "test": windows_of([rolls[i] for i in test_ids], "test"),
            }
            self._fill_empty_splits()

    def _fill_empty_splits(self) -> None:
        """Empty valid falls back to one train window; empty test to valid
        (tiny corpora / fresh caches must still evaluate)."""
        if not len(self.windows["valid"]):
            self.windows["valid"] = self.windows["train"][:1]
            self.masks["valid"] = self.masks["train"][:1]
        if not len(self.windows["test"]):
            self.windows["test"] = self.windows["valid"]
            self.masks["test"] = self.masks["valid"]

    @property
    def n_pitches(self) -> int:
        return self.cfg.n_pitches

    @property
    def frame_dim(self) -> int:
        return self.cfg.frame_dim

    @property
    def n_tracks(self) -> int:
        return self.cfg.n_tracks

    def decode(self, rolls: np.ndarray) -> np.ndarray:
        """Model-space rolls (windows or generated) -> frame-space
        pianorolls per cfg.encoding (no-op for 'frame')."""
        return pr.decode_rolls(rolls, self.cfg.encoding)

    def n_batches(self, split: str = "train") -> int:
        return max(1, len(self.windows[split]) // self.cfg.batch_size)

    def batches(self, split: str = "train", epoch: int = 0,
                shuffle: bool = True,
                drop_remainder: bool = True,
                with_masks: bool = False,
                augment: bool = False) -> Iterator[np.ndarray]:
        """Yield (batch, window, K, D) uint8 host arrays, in a deterministic
        order per (seed, epoch). The short final batch is dropped when
        training (static shapes: a captured step group needs them); with
        drop_remainder=False the tail is yielded short, never zero-padded
        (fabricated windows would bias evaluation metrics). ``augment`` opts
        in to train-time transposition: only the training loops ask for it,
        so evaluating the train split measures the true corpus."""
        data = self.windows[split]
        bs = self.cfg.batch_size
        idx = np.arange(len(data))
        if shuffle:
            rng = np.random.default_rng((self.cfg.seed, epoch))
            rng.shuffle(idx)
        # train-time transposition augmentation (host-side, uint8 — cheap
        # next to the device step); caller-opt-in, see docstring
        aug_rng = (np.random.default_rng((self.cfg.seed, epoch, 0xA46))
                   if self.cfg.transpose_range > 0 and augment
                   else None)
        masks = self.masks.get(split) if with_masks else None

        def emit(sel):
            batch = data[sel]
            if aug_rng is not None:
                batch = self._transpose_batch(batch, aug_rng)
            return (batch, masks[sel]) if with_masks else batch
        n_full = len(data) // bs
        for i in range(n_full):
            yield emit(idx[i * bs:(i + 1) * bs])
        if not drop_remainder and len(data) % bs:
            yield emit(idx[n_full * bs:])

    def _transpose_batch(self, batch: np.ndarray,
                         rng: np.random.Generator) -> np.ndarray:
        """Per-window uniform shift in [-R, R] semitones (R =
        cfg.transpose_range), grouped by shift value so each distinct shift
        is one vectorized pianoroll.transpose_roll pass."""
        r = self.cfg.transpose_range
        shifts = rng.integers(-r, r + 1, size=len(batch))
        out = batch.copy()
        for s in np.unique(shifts):
            if s == 0:
                continue
            m = shifts == s
            out[m] = pr.transpose_roll(batch[m], int(s), self.cfg.n_pitches,
                                       exclude=self.cfg.transpose_exclude)
        return out

    def seed_windows(self, split: str = "valid", n: int = 1) -> np.ndarray:
        """Seed pianorolls for the generator (priming)."""
        data = self.windows[split]
        if not len(data):
            data = self.windows["train"]
        if n <= len(data):
            # slice, don't concatenate — keeps cache_dir splits out-of-core
            # (only the n requested windows materialize from the mmap).
            # np.array COPIES: callers may mutate seeds, and a writable view
            # into the dataset would corrupt eval windows in place.
            return np.array(data[:n])
        reps = -(-n // len(data))
        return np.concatenate([np.asarray(data)] * reps)[:n]
