"""The port's musical metrics (``multinn_torch/eval/musical.py``) against
the JAX package's on seeded rolls: every function returns the identical
value (exact equality; both are the same numpy on the host), with and
without a drum track, for (N, T, K, D) and (T, K, D) rolls, a drums-only
set and empty rolls."""

import numpy as np
import pytest

from multinn_tpu.eval import musical as jax_musical
from multinn_torch.eval import musical

K, D, T = 3, 16, 32


def _rolls(n=4, t=T, k=K, d=D, seed=0, density=0.15):
    rng = np.random.default_rng(seed)
    return (rng.random((n, t, k, d)) < density).astype(np.uint8)


def _same(got, want):
    """Exact equality through nested dicts, lists and arrays."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for name in want:
            _same(got[name], want[name])
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


CALLS = [
    ("empty_bar_ratio", lambda m, r: m.empty_bar_ratio(r, 8)),
    ("used_pitch_classes_per_bar",
     lambda m, r: m.used_pitch_classes_per_bar(r, 8, pitch_min=5)),
    ("qualified_note_ratio", lambda m, r: m.qualified_note_ratio(r, 2)),
    ("drum_pattern_ratio", lambda m, r: m.drum_pattern_ratio(r, 0, 8)),
    ("tonal_distance", lambda m, r: m.tonal_distance(r, 1, 2, 8, 3)),
    ("polyphony_rate", lambda m, r: m.polyphony_rate(r)),
    ("note_density", lambda m, r: m.note_density(r)),
    ("per_sample_stats", lambda m, r: m.per_sample_stats(r, 8, 0, 0)),
    ("per_sample_stats_no_drums",
     lambda m, r: m.per_sample_stats(r, 8, 0, None)),
    ("evaluate_rolls", lambda m, r: m.evaluate_rolls(r, 8, 2, 0)),
    ("evaluate_rolls_no_drums",
     lambda m, r: m.evaluate_rolls(r, 8, 2, None)),
    ("compare_rolls",
     lambda m, r: m.compare_rolls(r, _rolls(6, seed=9, density=0.3), 8, 0,
                                  0)),
    ("compare_rolls_no_drums",
     lambda m, r: m.compare_rolls(r, _rolls(6, seed=9, density=0.3), 8, 0,
                                  None)),
]


@pytest.mark.parametrize("name,call", CALLS, ids=[c[0] for c in CALLS])
@pytest.mark.parametrize("density", [0.05, 0.4])
def test_every_metric_equals_the_jax_one(name, call, density):
    rolls = _rolls(density=density)
    _same(call(musical, rolls), call(jax_musical, rolls))


def test_three_dim_rolls_empty_rolls_and_a_drums_only_set():
    one = _rolls(1)[0]                               # (T, K, D)
    _same(musical.evaluate_rolls(one, 16, 0, 0),
          jax_musical.evaluate_rolls(one, 16, 0, 0))
    empty = np.zeros((2, T, K, D), np.uint8)
    _same(musical.compare_rolls(empty, _rolls(), 16, 0, 0),
          jax_musical.compare_rolls(empty, _rolls(), 16, 0, 0))
    drums = _rolls(k=1)
    got = musical.per_sample_stats(drums, 16, 0, 0)
    assert "used_pitch_classes" not in got
    _same(got, jax_musical.per_sample_stats(drums, 16, 0, 0))
    _same(musical.compare_rolls(drums, _rolls(k=1, seed=3), 16, 0, 0),
          jax_musical.compare_rolls(drums, _rolls(k=1, seed=3), 16, 0, 0))
    with pytest.raises(ValueError, match="expected"):
        musical.evaluate_rolls(np.zeros((T, D)))
