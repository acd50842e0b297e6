"""multinn_torch's data layer against the JAX package's, byte for byte.

The port's ``Dataset`` (``multinn_torch/data/datasets.py``) and the JAX
``Dataset`` are built from the same DataConfig fields for every source —
``synthetic``, ``pickle`` on ``data/jsb_synth.pkl``, ``npz``, ``midi_dir``
and ``cache_dir`` written under ``tmp_path`` — and must hold the same
uint8 windows and masks in every split and yield the same batches: the
shuffle of epoch e, the transposition of epoch e (augmented batches),
masked short tails, ``n_batches`` and ``seed_windows``. A window cache
written by either package loads in the other; the port's MIDI writer's
files read back alike in both readers; the native reader (where its
library loads) agrees with the Python one. Every comparison is exact: the
data layer is integer host code."""

import dataclasses

import numpy as np
import pytest

from multinn_tpu.data import cache as jax_cache
from multinn_tpu.data import datasets as jax_datasets
from multinn_tpu.data import midi as jax_midi
from multinn_tpu.data import pianoroll as jax_pr
from multinn_torch.data import cache, datasets, midi, native, pianoroll
from multinn_torch.utils import config

SMALL = dict(dataset="synthetic", source="synthetic", n_tracks=3,
             pitch_min=40, pitch_max=63, window=16, batch_size=3,
             synthetic_songs=10, synthetic_steps=56, transpose_range=2,
             transpose_exclude=(0,))


def _pair(**kw):
    fields = {f.name for f in dataclasses.fields(config.DataConfig)}
    assert fields == {f.name for f in dataclasses.fields(
        jax_datasets.DataConfig)}
    return (datasets.Dataset(config.DataConfig(**kw)),
            jax_datasets.Dataset(jax_datasets.DataConfig(**kw)))


def _same_dataset(ours, theirs, epochs=(0, 1)):
    assert set(ours.windows) == set(theirs.windows) == {"train", "valid",
                                                         "test"}
    for split in ours.windows:
        a, b = np.asarray(ours.windows[split]), np.asarray(
            theirs.windows[split])
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(ours.masks[split]),
                                      np.asarray(theirs.masks[split]))
        assert ours.n_batches(split) == theirs.n_batches(split)
        for n in (1, 3, 2 * len(a) + 1):
            np.testing.assert_array_equal(ours.seed_windows(split, n),
                                          theirs.seed_windows(split, n))
    for epoch in epochs:
        for kw in (dict(augment=True), dict(augment=False),
                   dict(shuffle=False, drop_remainder=False,
                        with_masks=True)):
            got = list(ours.batches("train", epoch=epoch, **kw))
            want = list(theirs.batches("train", epoch=epoch, **kw))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for x, y in zip(g if isinstance(g, tuple) else (g,),
                                w if isinstance(w, tuple) else (w,)):
                    assert x.dtype == y.dtype == np.uint8
                    np.testing.assert_array_equal(x, y)
    for split in ("valid", "test"):
        for (g, gm), (w, wm) in zip(
                ours.batches(split, shuffle=False, drop_remainder=False,
                             with_masks=True),
                theirs.batches(split, shuffle=False, drop_remainder=False,
                               with_masks=True)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(gm, wm)


@pytest.mark.parametrize("kw", [
    dict(), dict(encoding="onset_hold"),
    dict(n_tracks=1, transpose_exclude=(), splits=(0.5, 0.3, 0.2), seed=7),
    dict(synthetic_songs=2)])
def test_synthetic_source_equals_the_jax_dataset(kw):
    ours, theirs = _pair(**dict(SMALL, **kw))
    _same_dataset(ours, theirs)
    # augmentation moved something (the transposition is exercised)
    aug = next(ours.batches("train", epoch=1, augment=True))
    assert not np.array_equal(aug, next(ours.batches("train", epoch=1)))


def test_pickle_source_equals_the_jax_dataset():
    kw = dict(config.PRESETS["jsb"], dataset="jsb", path="data/jsb_synth.pkl",
              window=32, batch_size=8, transpose_range=3)
    ours, theirs = _pair(**kw)
    assert len(ours.windows["train"]) > 8
    _same_dataset(ours, theirs, epochs=(0, 2))


def _rolls(n, k, d, seed):
    rng = np.random.default_rng(seed)
    return [(rng.random((int(rng.integers(20, 50)), k, d)) < 0.1).astype(
        np.uint8) for _ in range(n)]


@pytest.mark.parametrize("layout", ["rolls", "split_keys", "loose_arrays"])
def test_npz_source_equals_the_jax_dataset(tmp_path, layout):
    kw = dict(SMALL, source="npz", path=str(tmp_path / "c.npz"))
    d = kw["pitch_max"] - kw["pitch_min"] + 1
    rolls = _rolls(9, 3, d, 1)
    obj = np.empty(len(rolls), object)
    obj[:] = rolls
    if layout == "rolls":
        np.savez(kw["path"], rolls=obj)
    elif layout == "split_keys":
        np.savez(kw["path"], rolls_train=obj[:6], rolls_valid=obj[6:8],
                 rolls_test=obj[8:])
    else:
        np.savez(kw["path"], **{f"r{i}": r for i, r in enumerate(rolls)})
    _same_dataset(*_pair(**kw))


def _write_midi_dir(path, n_songs, spec, seed):
    path.mkdir()
    for i, roll in enumerate(_rolls(n_songs, spec.n_tracks, spec.n_pitches,
                                    seed)):
        midi.save(pianoroll.roll_to_midi(roll, spec),
                  str(path / f"song_{i:02d}.mid"))
    (path / "broken.mid").write_bytes(b"MThd\x00\x00\x00\x06\x00\x01")


def test_midi_dir_source_equals_the_jax_dataset(tmp_path):
    kw = dict(SMALL, n_tracks=5, source="midi_dir",
              path=str(tmp_path / "mid"))
    cfg = config.DataConfig(**kw)
    _write_midi_dir(tmp_path / "mid", 8, cfg.spec(), 2)
    _same_dataset(*_pair(**kw))


def test_midi_writer_and_readers_agree_with_the_jax_package(tmp_path):
    spec = pianoroll.RollSpec(pitch_min=30, pitch_max=70, n_tracks=5)
    jspec = jax_pr.RollSpec(pitch_min=30, pitch_max=70, n_tracks=5)
    roll = _rolls(1, 5, spec.n_pitches, 3)[0]
    ours = midi.dumps(pianoroll.roll_to_midi(roll, spec, bpm=96.0))
    assert ours == jax_midi.dumps(jax_pr.roll_to_midi(roll, jspec, bpm=96.0))
    back = pianoroll.midi_to_roll(midi.loads(ours), spec)
    np.testing.assert_array_equal(back[:len(roll)], roll)
    np.testing.assert_array_equal(
        back, jax_pr.midi_to_roll(jax_midi.loads(ours), jspec))
    f = tmp_path / "a.mid"
    f.write_bytes(ours)
    np.testing.assert_array_equal(
        datasets.parse_midi_file(str(f), spec, use_native=False), back)
    if native.available():
        np.testing.assert_array_equal(native.midi_file_to_roll(str(f), spec),
                                      back)
    with pytest.raises(midi.MidiParseError):
        midi.loads(ours[:30])
    assert datasets.parse_midi_file(str(f), spec, False) is not None
    f.write_bytes(ours[:30])
    assert datasets.parse_midi_file(str(f), spec, False) is None


def test_native_and_python_readers_agree_on_a_corpus(tmp_path):
    if not native.available():
        pytest.skip("the native MIDI library does not load here")
    spec = pianoroll.RollSpec(pitch_min=24, pitch_max=107, n_tracks=5)
    _write_midi_dir(tmp_path / "m", 5, spec, 4)
    fast = datasets.load_midi_dir(str(tmp_path / "m"), spec, use_native=True)
    slow = datasets.load_midi_dir(str(tmp_path / "m"), spec, use_native=False)
    assert len(fast) == len(slow) == 5          # the broken file is skipped
    for a, b in zip(fast, slow):
        np.testing.assert_array_equal(a, b)


def _dir_bytes(path):
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


def test_cache_written_by_either_package_loads_in_the_other(tmp_path):
    kw = dict(SMALL, encoding="onset_hold")
    ours, theirs = _pair(**kw)
    # an exact dump of an in-memory dataset, by each package
    cache.write_cache_from_dataset(ours, str(tmp_path / "a"))
    jax_cache.write_cache_from_dataset(theirs, str(tmp_path / "b"))
    assert _dir_bytes(tmp_path / "a") == _dir_bytes(tmp_path / "b")
    # the streaming writer, by each package, read by the other
    cfg, jcfg = ours.cfg, theirs.cfg
    cache.write_cache(str(tmp_path / "c"), cfg, cache.iter_synthetic(cfg))
    jax_cache.write_cache(str(tmp_path / "d"), jcfg,
                          jax_cache.iter_synthetic(jcfg))
    assert _dir_bytes(tmp_path / "c") == _dir_bytes(tmp_path / "d")
    for src, dst in (("a", "b"), ("c", "d")):
        _same_dataset(
            datasets.Dataset(config.DataConfig(
                **dict(kw, source="cache_dir", path=str(tmp_path / dst)))),
            jax_datasets.Dataset(jax_datasets.DataConfig(
                **dict(kw, source="cache_dir", path=str(tmp_path / src)))))
    with pytest.raises(ValueError, match="does not match"):
        datasets.Dataset(config.DataConfig(**dict(
            kw, encoding="frame", source="cache_dir",
            path=str(tmp_path / "b"))))


def test_cache_streamed_from_a_midi_dir_equals_the_jax_cache(tmp_path):
    kw = dict(SMALL, n_tracks=5, source="midi_dir",
              path=str(tmp_path / "mid"))
    ours, jcfg = config.DataConfig(**kw), jax_datasets.DataConfig(**kw)
    _write_midi_dir(tmp_path / "mid", 7, ours.spec(), 5)
    for use_native in (False, True) if native.available() else (False,):
        cache.write_cache(str(tmp_path / f"a{use_native}"), ours,
                          cache.iter_midi_dir(ours, use_native=use_native))
        jax_cache.write_cache(str(tmp_path / f"b{use_native}"), jcfg,
                              jax_cache.iter_midi_dir(jcfg,
                                                      use_native=False))
        assert (_dir_bytes(tmp_path / f"a{use_native}")
                == _dir_bytes(tmp_path / f"b{use_native}"))


def test_sources_refuse_what_the_reference_refuses(tmp_path):
    for kw, match in ((dict(source="npz"), "requires data.path"),
                      (dict(source="npz", path=str(tmp_path / "no.npz")),
                       "does not exist"),
                      (dict(source="tape", path=str(tmp_path)),
                       "unknown source")):
        with pytest.raises(ValueError, match=match):
            datasets.Dataset(config.DataConfig(**dict(SMALL, **kw)))
    assert config.DataConfig.from_preset("lpd5") == config.DataConfig(
        **dataclasses.asdict(jax_datasets.DataConfig.from_preset("lpd5")))


def _smf(ntrks, division, *track_bodies):
    chunks = b"".join(
        b"MTrk" + len(body + b"\x00\xff\x2f\x00").to_bytes(4, "big")
        + body + b"\x00\xff\x2f\x00" for body in track_bodies)
    return (b"MThd" + (6).to_bytes(4, "big") + (1).to_bytes(2, "big")
            + ntrks.to_bytes(2, "big") + division.to_bytes(2, "big")
            + chunks)


def test_tick_to_seconds_walks_the_tempo_map_as_the_jax_package():
    # 96 tpqn; 120 bpm at tick 0, 60 bpm (1e6 us/q) at tick 96; a note
    # from tick 192 to 288
    body = (b"\x00\xff\x51\x03" + (500000).to_bytes(3, "big")
            + b"\x60\xff\x51\x03" + (1000000).to_bytes(3, "big")
            + b"\x60\x90\x3c\x40" + b"\x60\x80\x3c\x00")
    m = midi.loads(_smf(1, 96, body))
    assert m.tempo_map == [(0, 500000), (96, 1000000)]
    # 96 ticks at 120 bpm = 0.5 s; the next 96 at 60 bpm = 1.0 s
    assert abs(m.tick_to_seconds(96) - 0.5) < 1e-9
    assert abs(m.tick_to_seconds(192) - 1.5) < 1e-9
    assert abs(m.duration_seconds() - 2.5) < 1e-9
    # no tempo meta: 120 bpm throughout
    m2 = midi.loads(_smf(1, 96, b"\x00\x90\x3c\x40\x60\x80\x3c\x00"))
    assert m2.tempo_map == []
    assert abs(m2.duration_seconds() - 0.5) < 1e-9
    for data in (_smf(1, 96, body),
                 _smf(1, 96, b"\x00\x90\x3c\x40\x60\x80\x3c\x00")):
        got, want = midi.loads(data), jax_midi.loads(data)
        for tick in (0, 50, 96, 150, 192, 288, 1000):
            assert got.tick_to_seconds(tick) == want.tick_to_seconds(tick)
        assert got.duration_seconds() == want.duration_seconds()
