"""The port's file output against the JAX package's, byte for byte:

* ``utils/images``: ``render_pianoroll`` arrays and ``encode_png`` bytes
  identical to the JAX module's (whose PNGs PIL writes), for pianorolls
  and arbitrary RGB arrays; ``decode_png`` reads both back to the array;
* ``Generator.to_midi`` / ``write_files``: the MIDI and PNG files equal
  those of JAX ``Generator.write_files`` on the same finalized rolls, for
  the frame and the onset/hold encodings (``finalize`` equal as well);
* TensorBoard image events: ``EventWriter.add_image`` and
  ``MetricsLogger.log_image`` round-trip through ``read_events``, and the
  JAX reader reads the port's file (and the other way round).
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.training.generator import Generator as JaxGenerator  # noqa
from multinn_tpu.utils import config as jax_config  # noqa: E402
from multinn_tpu.utils import images as jax_images  # noqa: E402
from multinn_tpu.utils import logging as jax_logging  # noqa: E402
from multinn_tpu.utils import tb as jax_tb  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.training.generator import Generator  # noqa: E402
from multinn_torch.utils import config, images, tb  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402
from multinn_torch.utils.logging import MetricsLogger  # noqa: E402

K, D, T = 3, 16, 32


def _rolls(n=3, t=T, k=K, d=D, seed=0, density=0.2):
    rng = np.random.default_rng(seed)
    return (rng.random((n, t, k, d)) < density).astype(np.uint8)


@pytest.mark.parametrize("shape,density,scale", [
    ((T, K, D), 0.05, 2), ((T, K, D), 0.5, 1), ((T, D), 0.3, 2),
    ((300, 9, D), 0.2, 2)])
def test_pianoroll_images_and_png_bytes_equal_the_jax_ones(shape, density,
                                                           scale):
    roll = (np.random.default_rng(1).random(shape) < density).astype(np.uint8)
    img = images.render_pianoroll(roll, scale)
    np.testing.assert_array_equal(img, jax_images.render_pianoroll(roll,
                                                                   scale))
    png = images.encode_png(img)
    assert png == jax_images.encode_png(img)
    np.testing.assert_array_equal(images.decode_png(png), img)


@pytest.mark.parametrize("shape", [(7, 5, 3), (40, 33, 3), (1, 1, 3)])
def test_png_bytes_of_arbitrary_rgb_equal_pil(shape):
    """Noise exercises every row filter (sub, up and Paeth)."""
    img = np.random.default_rng(2).integers(0, 256, shape).astype(np.uint8)
    png = images.encode_png(img)
    assert png == jax_images.encode_png(img)
    np.testing.assert_array_equal(images.decode_png(png), img)
    with pytest.raises(ValueError, match="crc"):
        images.decode_png(png[:-5] + bytes([png[-5] ^ 1]) + png[-4:])


def _generators(encoding):
    width = 2 * D if encoding == "onset_hold" else D
    model = dict(n_tracks=K, n_pitches=width, mode="feedback", n_hidden=8,
                 n_rnn=6)
    data = dict(n_tracks=K, pitch_min=40, pitch_max=40 + D - 1,
                encoding=encoding)
    gen = dict(gap_fill_steps=1, min_note_steps=2)
    jcfg = jax_config.ExperimentConfig(
        model=jax_multinn.MultINNConfig(**model),
        data=jax_config.DataConfig(**data),
        generate=jax_config.GenerateConfig(**gen)).validate()
    tcfg = config.ExperimentConfig(
        model=multinn.MultINNConfig(**model), data=config.DataConfig(**data),
        generate=config.GenerateConfig(**gen)).validate()
    jp = jax_multinn.init(jax.random.PRNGKey(0), jcfg.model)
    return JaxGenerator(jcfg, jp), Generator(tcfg, from_jax(jp, device="cpu"))


@pytest.mark.parametrize("encoding", ["frame", "onset_hold"])
def test_write_files_equal_the_jax_generator(tmp_path, encoding):
    jgen, tgen = _generators(encoding)
    width = tgen.cfg.model.n_pitches
    model_rolls = _rolls(d=width, seed=3)
    rolls = tgen.finalize(model_rolls)
    np.testing.assert_array_equal(rolls, jgen.finalize(model_rolls))
    assert rolls.shape == (3, T, K, D)
    got = tgen.write_files(rolls, str(tmp_path / "torch"), bpm=96.0)
    want = jgen.write_files(rolls, str(tmp_path / "jax"), bpm=96.0)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p)
                                                  for p in want]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names
    assert {n[-4:] for n in names} == {".mid", ".png"} and len(names) == 6
    for name in names:
        a = (tmp_path / "torch" / name).read_bytes()
        assert a == (tmp_path / "jax" / name).read_bytes(), name
    tgen.to_midi(rolls[0], str(tmp_path / "one" / "a.mid"), bpm=140.0)
    jgen.to_midi(rolls[0], str(tmp_path / "one" / "b.mid"), bpm=140.0)
    assert ((tmp_path / "one" / "a.mid").read_bytes()
            == (tmp_path / "one" / "b.mid").read_bytes())
    # no images asked for: MIDI only
    tgen.write_files(rolls[:1], str(tmp_path / "bare"), prefix="x",
                     write_images=False)
    assert os.listdir(tmp_path / "bare") == ["x_000.mid"]


def test_image_events_round_trip_and_cross_read(tmp_path):
    roll = _rolls(1)[0]
    img = images.render_pianoroll(roll)
    png = images.encode_png(img)
    w = tb.EventWriter(str(tmp_path / "torch"))
    w.add_image("valid/sample", png, img.shape[0], img.shape[1], step=7)
    w.add_scalars([("valid/loss", 0.5)], step=7)
    w.close()
    for reader in (tb.read_events, jax_tb.read_events):
        events = list(reader(w.path))
        assert events[0]["file_version"] == "brain.Event:2"
        im = events[1]["images"]["valid/sample"]
        assert events[1]["step"] == 7
        assert (im["height"], im["width"], im["colorspace"]) == (
            img.shape[0], img.shape[1], 3)
        assert im["png"] == png
        assert events[2]["scalars"] == {"valid/loss": 0.5}
    jw = jax_tb.EventWriter(str(tmp_path / "jax"))
    jw.add_image("valid/reference", png, img.shape[0], img.shape[1], step=3)
    jw.close()
    got = list(tb.read_events(jw.path))[1]
    assert got["images"]["valid/reference"]["png"] == png


def test_log_image_writes_the_jax_loggers_event(tmp_path):
    roll = _rolls(1)[0]
    logs = {}
    for name, cls in (("torch", MetricsLogger),
                      ("jax", jax_logging.MetricsLogger)):
        log = cls(str(tmp_path / name))
        assert log.log_image("valid/sample", roll, 4)
        assert log.log_image("valid/rgb", images.render_pianoroll(roll), 4)
        log.close()
        (path,) = glob.glob(str(tmp_path / name / "tb" / "events.*"))
        logs[name] = [e["images"] for e in tb.read_events(path)][1:]
    assert logs["torch"] == logs["jax"]
    np.testing.assert_array_equal(
        images.decode_png(logs["torch"][0]["valid/sample"]["png"]),
        images.render_pianoroll(roll))
    quiet = MetricsLogger(str(tmp_path / "quiet"), tensorboard=False)
    assert not quiet.log_image("valid/sample", roll, 1)
    quiet.close()
