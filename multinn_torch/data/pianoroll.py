"""Pianoroll quantization, encodings, windows and generation clean-up — the
port's own copy of multinn_tpu/data/pianoroll.py (the port imports nothing
of the JAX package).

``midi_to_roll`` quantizes and binarizes a MidiFile onto a fixed musical
grid (``RollSpec``: steps per quarter, an inclusive pitch range, 1 track or
the LPD-5 split by program range with the drum channels merged);
``roll_to_midi`` is its inverse. ``onset_hold`` makes note continuation an
explicit symbol: each pitch becomes two channels, onset (first sounding
frame) and hold (continuation frame); decoding re-joins a note as an onset
followed by its maximal hold run, and holds with no live note behind them
are dropped. ``chop_windows`` / ``chop_windows_masked`` cut rolls into the
fixed training windows (with masks of the real frames);
``transpose_roll`` is the pitch-shift augmentation; ``postprocess_roll``
the opt-in gap-fill / minimum-note-length clean-up of generated rolls.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from multinn_torch.data import midi as midi_mod

# Canonical LPD-5 track set with MuseGAN-style program-range mapping:
# drums = drum channels; piano 0–7; guitar 24–31; bass 32–39; everything
# else -> strings.
LPD5_TRACKS = ("drums", "piano", "guitar", "bass", "strings")


def lpd5_track_index(program: int, is_drum: bool) -> int:
    if is_drum:
        return 0
    if 0 <= program <= 7:
        return 1
    if 24 <= program <= 31:
        return 2
    if 32 <= program <= 39:
        return 3
    return 4


@dataclasses.dataclass(frozen=True)
class RollSpec:
    """Grid/pitch spec for quantization.

    steps_per_quarter: 4 = 16th-note grid, 2 = 8th, 1 = quarter.
    pitch_min/pitch_max: inclusive clip range; (21, 108) = the 88-key range.
    n_tracks: 1 = merge everything; 5 = LPD-5 split.
    """

    steps_per_quarter: int = 4
    pitch_min: int = 21
    pitch_max: int = 108
    n_tracks: int = 1

    @property
    def n_pitches(self) -> int:
        return self.pitch_max - self.pitch_min + 1


def grid_steps(mid: midi_mod.MidiFile, spec: RollSpec) -> int:
    """The grid length ``midi_to_roll`` gives ``mid`` when uncapped."""
    ticks_per_step = mid.ticks_per_quarter / spec.steps_per_quarter
    return max(1, int(round(mid.end_tick() / ticks_per_step)))


def midi_to_roll(mid: midi_mod.MidiFile, spec: RollSpec,
                 max_steps: Optional[int] = None) -> np.ndarray:
    """Quantize+binarize a MidiFile to (T, K, D) uint8.

    A note sounding in [start, end) ticks activates every grid step whose
    center falls inside it, with onset rounding to the nearest step — short
    notes always light at least their onset step.

    ``max_steps`` bounds the grid length: a crafted (or merely huge) file
    whose delta-time varints sum to billions of ticks would otherwise
    allocate an arbitrarily large roll — callers quantizing UNTRUSTED
    input (the HTTP serving payload path) must cap at what they will
    actually consume. Notes entirely beyond the cap are dropped (not
    clamped onto the final step).
    """
    ticks_per_step = mid.ticks_per_quarter / spec.steps_per_quarter
    n_steps = grid_steps(mid, spec)
    if max_steps is not None:
        n_steps = min(n_steps, max(1, int(max_steps)))
    roll = np.zeros((n_steps, spec.n_tracks, spec.n_pitches), np.uint8)
    for ins in mid.instruments:
        k = (lpd5_track_index(ins.program, ins.is_drum)
             if spec.n_tracks == 5 else 0)
        if k >= spec.n_tracks:
            k = spec.n_tracks - 1
        for note in ins.notes:
            if not (spec.pitch_min <= note.pitch <= spec.pitch_max):
                continue
            s = int(round(note.start / ticks_per_step))
            if s >= n_steps and max_steps is not None:
                continue                     # beyond the cap — drop
            e = int(round(note.end / ticks_per_step))
            e = max(e, s + 1)
            s, e = min(s, n_steps - 1), min(e, n_steps)
            roll[s:e, k, note.pitch - spec.pitch_min] = 1
    return roll


def roll_to_midi(roll: np.ndarray, spec: RollSpec,
                 ticks_per_quarter: int = 480,
                 bpm: float = 120.0,
                 velocity: int = 100,
                 track_programs: Optional[Sequence[int]] = None
                 ) -> midi_mod.MidiFile:
    """Inverse of midi_to_roll: (T, K, D) binary -> MidiFile.
    Consecutive active steps of one pitch merge into one note."""
    roll = np.asarray(roll)
    if roll.ndim == 2:
        roll = roll[:, None, :]
    t_len, k_tracks, d = roll.shape
    if d != spec.n_pitches:
        raise ValueError(f"roll pitch dim {d} != spec {spec.n_pitches}")
    ticks_per_step = int(round(ticks_per_quarter / spec.steps_per_quarter))
    if track_programs is None:
        # LPD-5 defaults: drums(any), acoustic piano, guitar, bass, strings
        track_programs = ([0, 0, 24, 32, 48][:k_tracks] if k_tracks == 5
                          else [0] * k_tracks)
    mid = midi_mod.MidiFile(
        ticks_per_quarter=ticks_per_quarter,
        tempo_us_per_quarter=int(round(6e7 / bpm)))
    for k in range(k_tracks):
        is_drum = (k_tracks == 5 and k == 0)
        ins = midi_mod.Instrument(program=int(track_programs[k]),
                                  is_drum=is_drum,
                                  name=LPD5_TRACKS[k] if k_tracks == 5 else "")
        track = roll[:, k, :]
        # pad with a zero row so note-offs at the end resolve
        padded = np.concatenate([track, np.zeros((1, d), track.dtype)])
        diff = np.diff(padded.astype(np.int8), axis=0)
        for p in range(d):
            onsets = np.nonzero(diff[:, p] == 1)[0] + 1
            offsets = np.nonzero(diff[:, p] == -1)[0] + 1
            if track[0, p]:
                onsets = np.concatenate([[0], onsets])
            for s, e in zip(onsets, offsets):
                ins.notes.append(midi_mod.Note(
                    pitch=p + spec.pitch_min, velocity=velocity,
                    start=int(s) * ticks_per_step,
                    end=int(e) * ticks_per_step))
        if ins.notes:
            ins.notes.sort(key=lambda n: (n.start, n.pitch))
            mid.instruments.append(ins)
    return mid


def encode_onset_hold(roll: np.ndarray) -> np.ndarray:
    """(T, K, D) binary frame roll -> (T, K, 2D) uint8: [onset | hold].

    onset_t = v_t AND NOT v_{t-1};  hold_t = v_t AND v_{t-1}  (v_{-1} = 0).
    Exact inverse: decode_onset_hold(encode_onset_hold(r)) == r.
    """
    roll = np.asarray(roll).astype(np.uint8)
    prev = np.zeros_like(roll)
    prev[1:] = roll[:-1]
    return np.concatenate([roll & ~prev & 1, roll & prev], axis=-1)


def transpose_roll(roll: np.ndarray, shift: int, n_pitches: int,
                   exclude: tuple = ()) -> np.ndarray:
    """Shift the pitch axis of a (..., K, F) roll by ``shift`` semitones,
    zero-filling — notes shifted outside [0, n_pitches) are DROPPED (the
    standard symbolic-music transposition augmentation). F may be
    ``n_pitches`` (frame encoding) or a multiple (onset_hold's [onset|hold]
    blocks): each n_pitches-wide block shifts independently, which is exact
    because the onset/hold encoding is pointwise per pitch. Track indices
    in ``exclude`` are returned UNSHIFTED — drum tracks' "pitch" axis
    indexes percussion instruments, not semitones (lpd5_track_index puts
    drums at track 0)."""
    roll = np.asarray(roll)
    f = roll.shape[-1]
    if f % n_pitches:
        raise ValueError(f"roll last dim {f} not a multiple of {n_pitches}")
    if abs(shift) >= n_pitches:
        raise ValueError(f"|shift|={abs(shift)} >= n_pitches={n_pitches}")
    if shift == 0:
        return roll
    out = np.zeros_like(roll)
    for b0 in range(0, f, n_pitches):
        if shift > 0:
            out[..., b0 + shift:b0 + n_pitches] = (
                roll[..., b0:b0 + n_pitches - shift])
        else:
            out[..., b0:b0 + n_pitches + shift] = (
                roll[..., b0 - shift:b0 + n_pitches])
    for k in exclude:
        out[..., k, :] = roll[..., k, :]
    return out


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


def chop_windows_masked(roll: np.ndarray, window: int,
                        hop: Optional[int] = None):
    """Like chop_windows(pad=True) but also returns the validity mask
    (N, window) uint8 marking REAL frames (0 = zero-padded tail frame).
    Evaluation uses the mask so per-frame likelihoods are computed over real
    music only (padded silence is trivially easy and biases eval)."""
    t = roll.shape[0]
    hop = hop or window
    windows = chop_windows(roll, window, hop=hop, pad=True)
    masks = np.zeros((len(windows), window), np.uint8)
    for i in range(len(windows)):
        real = max(0, min(window, t - i * hop))
        masks[i, :real] = 1
    return windows, masks


def chop_windows(roll: np.ndarray, window: int, hop: Optional[int] = None,
                 pad: bool = False) -> np.ndarray:
    """Chop a (T, K, D) roll into fixed windows (N, window, K, D), the
    stateless truncated-BPTT windowing. ``hop`` defaults to ``window``
    (non-overlapping); ``pad`` zero-pads the tail."""
    hop = hop or window
    t = roll.shape[0]
    if pad and t % hop:
        pad_len = hop - (t % hop)
        roll = np.concatenate(
            [roll, np.zeros((pad_len, *roll.shape[1:]), roll.dtype)])
        t = roll.shape[0]
    if t < window:
        if not pad:
            return np.zeros((0, window, *roll.shape[1:]), roll.dtype)
        roll = np.concatenate(
            [roll, np.zeros((window - t, *roll.shape[1:]), roll.dtype)])
        t = window
    starts = range(0, t - window + 1, hop)
    return np.stack([roll[s:s + window] for s in starts])
