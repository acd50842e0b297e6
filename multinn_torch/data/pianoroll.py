"""Pianoroll encodings and generation clean-up — the port's own copy of the
numpy helpers of multinn_tpu/data/pianoroll.py that generation and serving
use (the port imports nothing of the JAX package).

``onset_hold`` makes note continuation an explicit symbol: each pitch
becomes two channels, onset (first sounding frame) and hold (continuation
frame). Decoding re-joins a note as an onset followed by its maximal hold
run; holds with no live note behind them are dropped, so sampling noise in
the hold channel can only end a note early. ``postprocess_roll`` is the
opt-in gap-fill / minimum-note-length clean-up of generated frame rolls.
"""

from __future__ import annotations

import numpy as np


def encode_onset_hold(roll: np.ndarray) -> np.ndarray:
    """(T, K, D) binary frame roll -> (T, K, 2D) uint8: [onset | hold].

    onset_t = v_t AND NOT v_{t-1};  hold_t = v_t AND v_{t-1}  (v_{-1} = 0).
    Exact inverse: decode_onset_hold(encode_onset_hold(r)) == r.
    """
    roll = np.asarray(roll).astype(np.uint8)
    prev = np.zeros_like(roll)
    prev[1:] = roll[:-1]
    return np.concatenate([roll & ~prev & 1, roll & prev], axis=-1)


def decode_onset_hold(oh: np.ndarray) -> np.ndarray:
    """(..., T, K, 2D) onset/hold roll -> (..., T, K, D) frame roll.

    f_t = onset_t OR (hold_t AND f_{t-1}); orphan holds (no sounding frame
    at t-1) decode to silence. A T-step loop of whole-array ops.
    """
    oh = np.asarray(oh)
    d2 = oh.shape[-1]
    if d2 % 2:
        raise ValueError(f"onset/hold roll last dim {d2} is odd")
    d = d2 // 2
    onset, hold = oh[..., :d], oh[..., d:]
    out = np.zeros(onset.shape, np.uint8)
    t_axis = oh.ndim - 3                      # (..., T, K, 2D)
    prev = np.zeros(onset.shape[:t_axis] + onset.shape[t_axis + 1:],
                    np.uint8)
    idx = [slice(None)] * onset.ndim
    for t in range(oh.shape[t_axis]):
        idx[t_axis] = t
        frame = (onset[tuple(idx)] | (hold[tuple(idx)] & prev)).astype(
            np.uint8)
        out[tuple(idx)] = frame
        prev = frame
    return out


def decode_rolls(rolls: np.ndarray, encoding: str) -> np.ndarray:
    """Model-space rolls -> frame-space pianorolls per ``data.encoding``."""
    if encoding == "frame":
        return np.asarray(rolls)
    if encoding == "onset_hold":
        return decode_onset_hold(rolls)
    raise ValueError(f"unknown encoding '{encoding}'")


def encode_rolls(rolls: np.ndarray, encoding: str) -> np.ndarray:
    """Frame-space pianoroll (T, K, D) -> model-space per ``data.encoding``
    (the inverse of decode_rolls; serving's priming seeds enter the model
    through it)."""
    if encoding == "frame":
        return np.asarray(rolls)
    if encoding == "onset_hold":
        return encode_onset_hold(rolls)
    raise ValueError(f"unknown encoding '{encoding}'")


def postprocess_roll(roll: np.ndarray, gap_fill_steps: int = 0,
                     min_note_steps: int = 0) -> np.ndarray:
    """Opt-in clean-up of a generated FRAME roll (..., T, K, D):
    ``gap_fill_steps`` closes silent gaps of at most that many steps inside
    a note, then ``min_note_steps`` drops notes shorter than that many
    steps. Off (0) by default: both change the sample distribution."""
    roll = np.asarray(roll).astype(np.uint8)
    t_axis = roll.ndim - 3
    t_len = roll.shape[t_axis]
    moved = np.moveaxis(roll, t_axis, 0)      # (T, ...)
    if gap_fill_steps > 0:
        # a gap of g steps at t..t+g-1 is filled iff the pitch is on at t-1
        # and on again at t+g with all-off between, g <= gap_fill_steps
        flat = moved.reshape(t_len, -1)
        out = flat.copy()
        for c in range(flat.shape[1]):
            on = np.flatnonzero(flat[:, c])
            if len(on) < 2:
                continue
            gaps = np.diff(on)                # gap g means diff == g+1
            for i in np.flatnonzero((gaps > 1)
                                    & (gaps <= gap_fill_steps + 1)):
                out[on[i] + 1:on[i + 1], c] = 1
        moved = out.reshape(moved.shape)
    if min_note_steps > 1:
        flat = moved.reshape(t_len, -1)
        padded = np.concatenate(
            [np.zeros((1, flat.shape[1]), np.int8),
             flat.astype(np.int8),
             np.zeros((1, flat.shape[1]), np.int8)])
        diff = np.diff(padded, axis=0)
        out = flat.copy()
        for c in range(flat.shape[1]):
            starts = np.flatnonzero(diff[:, c] == 1)
            ends = np.flatnonzero(diff[:, c] == -1)
            for s, e in zip(starts, ends):
                if e - s < min_note_steps:
                    out[s:e, c] = 0
        moved = out.reshape(moved.shape)
    return np.moveaxis(moved, 0, t_axis).astype(np.uint8)
