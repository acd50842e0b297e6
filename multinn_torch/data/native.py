"""ctypes binding of the native MIDI reader (native/midi_fast.cpp) — the
port's own, with the contract of multinn_tpu/data/native.py: SMF parsing
and pianoroll quantization in C++, bit-exact with the Python reader
(``data/midi.py`` + ``pianoroll.midi_to_roll``).

``available()`` loads ``native/libmultinn_native.so``, building it with
``make -C native`` where it is missing; where neither works the data layer
uses the Python reader. Host code: it feeds the batcher, not the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libmultinn_native.so")

NOTE_DTYPE = np.dtype([
    ("start_tick", np.int32), ("end_tick", np.int32),
    ("pitch", np.uint8), ("velocity", np.uint8),
    ("program", np.uint8), ("is_drum", np.uint8),
])


class _ParseResult(ctypes.Structure):
    _fields_ = [("notes", ctypes.c_void_p),
                ("n_notes", ctypes.c_int64),
                ("ticks_per_quarter", ctypes.c_int32),
                ("tempo_us_per_quarter", ctypes.c_int32)]


_lib: Optional[ctypes.CDLL] = None


def build(quiet: bool = True) -> bool:
    """Compile the shared library in its source directory."""
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR],
                       check=True, capture_output=quiet)
        return os.path.exists(_SO_PATH)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH) and not build():
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    lib.midi_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.POINTER(_ParseResult)]
    lib.midi_parse.restype = ctypes.c_int
    lib.midi_free_result.argtypes = [ctypes.POINTER(_ParseResult)]
    lib.notes_to_roll.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    lib.notes_to_roll.restype = ctypes.c_int
    lib.roll_end_tick.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.roll_end_tick.restype = ctypes.c_int64
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native MIDI library unavailable "
                           "(build with `make -C native`)")
    return lib


def parse_bytes(data: bytes):
    """SMF bytes -> (notes structured array, ticks per quarter, tempo us).
    Raises ValueError on malformed input, as ``midi.MidiParseError``."""
    lib = _require()
    res = _ParseResult()
    rc = lib.midi_parse(data, len(data), ctypes.byref(res))
    if rc != 0:
        raise ValueError(f"native MIDI parse failed (code {rc})")
    try:
        n = res.n_notes
        notes = np.zeros(n, NOTE_DTYPE)
        if n:
            ctypes.memmove(notes.ctypes.data, res.notes,
                           n * NOTE_DTYPE.itemsize)
        return notes, res.ticks_per_quarter, res.tempo_us_per_quarter
    finally:
        lib.midi_free_result(ctypes.byref(res))


def midi_file_to_roll(path: str, spec) -> np.ndarray:
    """``pianoroll.midi_to_roll(midi.load(path), spec)`` in C++."""
    lib = _require()
    with open(path, "rb") as f:
        data = f.read()
    notes, tpqn, _ = parse_bytes(data)
    ticks_per_step = tpqn / spec.steps_per_quarter
    end_tick = (int(lib.roll_end_tick(notes.ctypes.data, len(notes)))
                if len(notes) else 0)
    # Python's round (to even), as midi_to_roll
    n_steps = max(1, int(round(end_tick / ticks_per_step)))
    roll = np.zeros((n_steps, spec.n_tracks, spec.n_pitches), np.uint8)
    if len(notes):
        lib.notes_to_roll(notes.ctypes.data, len(notes),
                          ctypes.c_double(ticks_per_step), n_steps,
                          spec.n_tracks, spec.pitch_min, spec.pitch_max,
                          roll.ctypes.data)
    return roll
