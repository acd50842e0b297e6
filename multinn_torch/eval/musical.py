"""Musical evaluation metrics — the port's own copy of
multinn_tpu/eval/musical.py (numpy on the host, results identical).

Pianoroll-quality statistics in the MuseGAN/BinaryMuseGAN family
(arXiv:1804.09399 §V): empty-bar ratio, used pitch classes per bar,
qualified-note ratio, drum-pattern ratio, and tonal distance between tracks
(Harte et al. 2006 tonal-centroid distance). Plus polyphony rate and note
density as general health stats.

All functions take binary pianorolls as numpy arrays (N, T, K, D) (or
(T, K, D)) on the host. ``multinn_torch.evaluate`` compares
generated-sample statistics to training-corpus statistics.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _ensure_4d(rolls: np.ndarray) -> np.ndarray:
    rolls = np.asarray(rolls)
    if rolls.ndim == 3:
        rolls = rolls[None]
    if rolls.ndim != 4:
        raise ValueError(f"expected (N, T, K, D) rolls, got {rolls.shape}")
    return (rolls > 0).astype(np.uint8)


def _bars(rolls: np.ndarray, steps_per_bar: int) -> np.ndarray:
    """(N, T, K, D) -> (N, n_bars, steps_per_bar, K, D), truncating the tail."""
    n, t, k, d = rolls.shape
    n_bars = t // steps_per_bar
    return rolls[:, :n_bars * steps_per_bar].reshape(
        n, n_bars, steps_per_bar, k, d)


def empty_bar_ratio(rolls: np.ndarray, steps_per_bar: int = 16) -> np.ndarray:
    """EB: fraction of bars with zero active cells, per track. Returns (K,)."""
    bars = _bars(_ensure_4d(rolls), steps_per_bar)
    active = bars.sum(axis=(2, 4)) > 0                  # (N, n_bars, K)
    return 1.0 - active.mean(axis=(0, 1))


def used_pitch_classes_per_bar(rolls: np.ndarray, steps_per_bar: int = 16,
                               pitch_min: int = 0) -> np.ndarray:
    """UPC: mean number of distinct pitch classes per NON-EMPTY bar, per
    track. Returns (K,). (Meaningless for drums — mask upstream.)"""
    bars = _bars(_ensure_4d(rolls), steps_per_bar)      # (N,B,S,K,D)
    n, b, s, k, d = bars.shape
    pc = (np.arange(d) + pitch_min) % 12
    pc_onehot = np.eye(12, dtype=np.uint8)[pc]          # (D, 12)
    # any activation of pitch class c in bar
    used = np.einsum("nbskd,dc->nbkc", bars.astype(np.int32),
                     pc_onehot.astype(np.int32)) > 0      # (N,B,K,12)
    counts = used.sum(-1).astype(np.float64)            # (N,B,K)
    nonempty = bars.sum(axis=(2, 4)) > 0
    out = np.zeros(k)
    for ki in range(k):
        m = nonempty[:, :, ki]
        out[ki] = counts[:, :, ki][m].mean() if m.any() else 0.0
    return out


def _note_lengths(track_roll: np.ndarray):
    """All note run-lengths in a (T, D) binary roll."""
    t, d = track_roll.shape
    padded = np.zeros((t + 2, d), np.int8)
    padded[1:-1] = track_roll
    diff = np.diff(padded, axis=0)
    lengths = []
    for p in range(d):
        on = np.nonzero(diff[:, p] == 1)[0]
        off = np.nonzero(diff[:, p] == -1)[0]
        lengths.extend((off - on).tolist())
    return lengths


def qualified_note_ratio(rolls: np.ndarray, min_steps: int = 3) -> np.ndarray:
    """QN: fraction of notes lasting >= min_steps grid steps (MuseGAN uses a
    32th-note threshold; at 16th-note resolution min_steps≈2-3). Returns (K,)."""
    rolls = _ensure_4d(rolls)
    n, t, k, d = rolls.shape
    out = np.zeros(k)
    for ki in range(k):
        lengths = []
        for ni in range(n):
            lengths.extend(_note_lengths(rolls[ni, :, ki]))
        if lengths:
            arr = np.asarray(lengths)
            out[ki] = float((arr >= min_steps).mean())
    return out


def drum_pattern_ratio(rolls: np.ndarray, drum_track: int = 0,
                       steps_per_bar: int = 16) -> float:
    """DP: fraction of drum onsets lying on the 8th-note grid (every 2nd step
    at 16th-note resolution) — rhythmic regularity of the drum track."""
    rolls = _ensure_4d(rolls)
    drum = rolls[:, :, drum_track]                      # (N, T, D)
    prev = np.zeros_like(drum)
    prev[:, 1:] = drum[:, :-1]
    onsets = (drum == 1) & (prev == 0)
    total = onsets.sum()
    if total == 0:
        return 0.0
    grid = (np.arange(rolls.shape[1]) % 2) == 0
    on_grid = onsets[:, grid].sum()
    return float(on_grid / total)


_PC_ANGLES = 2 * np.pi * np.arange(12) / 12.0


def _tonal_centroid(pc_hist: np.ndarray) -> np.ndarray:
    """Harte et al. 2006 6-D tonal centroid of a pitch-class distribution.
    pc_hist: (..., 12) nonnegative. Returns (..., 6)."""
    pc = pc_hist / np.maximum(pc_hist.sum(-1, keepdims=True), 1e-9)
    # circles: fifths (7 semitones), minor thirds (3), major thirds (4)
    out = []
    for interval, r in ((7, 1.0), (3, 1.0), (4, 0.5)):
        ang = _PC_ANGLES * interval
        out.append(r * (pc * np.sin(ang)).sum(-1))
        out.append(r * (pc * np.cos(ang)).sum(-1))
    return np.stack(out, axis=-1)


def tonal_distance(rolls: np.ndarray, track_a: int, track_b: int,
                   steps_per_bar: int = 16, pitch_min: int = 0) -> float:
    """TD: mean tonal-centroid distance between two tracks' per-bar pitch
    class histograms (lower = more harmonically aligned) [P:1804.09399 §V]."""
    bars = _bars(_ensure_4d(rolls), steps_per_bar)      # (N,B,S,K,D)
    n, b, s, k, d = bars.shape
    pc = (np.arange(d) + pitch_min) % 12
    pc_onehot = np.eye(12)[pc]                          # (D, 12)
    ha = np.einsum("nbsd,dc->nbc", bars[:, :, :, track_a].astype(np.float64),
                   pc_onehot)
    hb = np.einsum("nbsd,dc->nbc", bars[:, :, :, track_b].astype(np.float64),
                   pc_onehot)
    mask = (ha.sum(-1) > 0) & (hb.sum(-1) > 0)
    if not mask.any():
        return 0.0
    ca, cb = _tonal_centroid(ha[mask]), _tonal_centroid(hb[mask])
    return float(np.linalg.norm(ca - cb, axis=-1).mean())


def polyphony_rate(rolls: np.ndarray, threshold: int = 2) -> np.ndarray:
    """Fraction of active time steps with >= threshold simultaneous pitches,
    per track. Returns (K,)."""
    rolls = _ensure_4d(rolls)
    counts = rolls.sum(-1)                              # (N, T, K)
    active = counts > 0
    out = np.zeros(rolls.shape[2])
    for ki in range(rolls.shape[2]):
        m = active[:, :, ki]
        out[ki] = float((counts[:, :, ki][m] >= threshold).mean()) \
            if m.any() else 0.0
    return out


def note_density(rolls: np.ndarray) -> np.ndarray:
    """Mean active cells per step, per track. Returns (K,)."""
    rolls = _ensure_4d(rolls)
    return rolls.mean(axis=(0, 1, 3)) * rolls.shape[3]


def per_sample_stats(rolls: np.ndarray, steps_per_bar: int = 16,
                     pitch_min: int = 0, drum_track: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
    """Per-SAMPLE metric values (each song/window is one observation) —
    the sampling unit for the significance summary below. Returns
    {metric: (N,) array} with per-track metrics averaged over tracks
    (drums excluded from UPC, which is pitch-class-meaningless there)."""
    rolls = _ensure_4d(rolls)
    n, _, k, _ = rolls.shape
    melodic = [i for i in range(k) if i != drum_track]
    out: Dict[str, list] = {m: [] for m in
                            ("empty_bar_ratio", "used_pitch_classes",
                             "qualified_note_ratio", "polyphony_rate",
                             "note_density")}
    if drum_track is not None:
        out["drum_pattern_ratio"] = []
    if not melodic:
        # drums-only roll set: UPC is pitch-class-meaningless everywhere —
        # drop the metric (compare_rolls skips one-sided metrics) instead
        # of letting an empty-slice mean produce NaN + RuntimeWarnings
        del out["used_pitch_classes"]
    for i in range(n):
        r = rolls[i:i + 1]
        out["empty_bar_ratio"].append(
            empty_bar_ratio(r, steps_per_bar).mean())
        if melodic:
            out["used_pitch_classes"].append(used_pitch_classes_per_bar(
                r, steps_per_bar, pitch_min)[melodic].mean())
        out["qualified_note_ratio"].append(qualified_note_ratio(r).mean())
        out["polyphony_rate"].append(polyphony_rate(r).mean())
        out["note_density"].append(note_density(r).mean())
        if drum_track is not None:
            out["drum_pattern_ratio"].append(
                drum_pattern_ratio(r, drum_track, steps_per_bar))
    return {m: np.asarray(v, np.float64) for m, v in out.items()}


def _norm_sf(z: float) -> float:
    """Two-sided normal tail probability (scipy-free)."""
    import math
    return float(math.erfc(abs(z) / math.sqrt(2.0)))


def compare_rolls(gen_rolls: np.ndarray, corpus_rolls: np.ndarray,
                  steps_per_bar: int = 16, pitch_min: int = 0,
                  drum_track: Optional[int] = None) -> Dict[str, object]:
    """Significance summary: generated vs corpus per-sample statistics.

    For each metric: means on both sides, Cohen's-d effect size against the
    corpus spread, and a Welch two-sample statistic with a normal-
    approximation p-value (small sample sizes make this approximate —
    treat |d| as the primary signal, p as a rough guide)."""
    gs = per_sample_stats(gen_rolls, steps_per_bar, pitch_min, drum_track)
    cs = per_sample_stats(corpus_rolls, steps_per_bar, pitch_min, drum_track)
    out: Dict[str, object] = {}
    for m in gs:
        if m not in cs:       # metric undefined on one side (drums-only set)
            continue
        g, c = gs[m], cs[m]
        mg, mc = float(g.mean()), float(c.mean())
        vg = float(g.var(ddof=1)) if len(g) > 1 else 0.0
        vc = float(c.var(ddof=1)) if len(c) > 1 else 0.0
        pooled = np.sqrt((vg + vc) / 2.0)
        d = (mg - mc) / pooled if pooled > 1e-12 else 0.0
        se = np.sqrt(vg / max(len(g), 1) + vc / max(len(c), 1))
        t = (mg - mc) / se if se > 1e-12 else 0.0
        out[m] = {"generated_mean": round(mg, 4),
                  "corpus_mean": round(mc, 4),
                  "effect_size_d": round(float(d), 3),
                  "welch_t": round(float(t), 3),
                  "p_normal_approx": round(_norm_sf(float(t)), 4),
                  "n": [int(len(g)), int(len(c))]}
    return out


def evaluate_rolls(rolls: np.ndarray, steps_per_bar: int = 16,
                   pitch_min: int = 0, drum_track: Optional[int] = None
                   ) -> Dict[str, object]:
    """All C16 statistics for a set of pianorolls. drum_track: index of the
    drum track (None = no drums; 5-track LPD sets use 0)."""
    rolls = _ensure_4d(rolls)
    k = rolls.shape[2]
    res: Dict[str, object] = {
        "empty_bar_ratio": empty_bar_ratio(rolls, steps_per_bar).tolist(),
        "used_pitch_classes": used_pitch_classes_per_bar(
            rolls, steps_per_bar, pitch_min).tolist(),
        "qualified_note_ratio": qualified_note_ratio(rolls).tolist(),
        "polyphony_rate": polyphony_rate(rolls).tolist(),
        "note_density": note_density(rolls).tolist(),
    }
    if drum_track is not None:
        res["drum_pattern_ratio"] = drum_pattern_ratio(
            rolls, drum_track, steps_per_bar)
    melodic = [i for i in range(k) if i != drum_track]
    tds = {}
    for i, a in enumerate(melodic):
        for b in melodic[i + 1:]:
            tds[f"{a}-{b}"] = tonal_distance(rolls, a, b, steps_per_bar,
                                             pitch_min)
    if tds:
        res["tonal_distance"] = tds
    return res
