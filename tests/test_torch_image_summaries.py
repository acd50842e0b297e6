"""Image summaries in multinn_torch's ``Trainer.train()`` against the JAX
package's on the CPU, for both decoder families: from the same params
(``from_jax``) on the same synthetic data, with the JAX Gibbs chain and
NADE sampler run as the Pallas kernels in interpret mode (so both packages
draw the same stream), every ``valid/sample`` and the one
``valid/reference`` PNG in the TensorBoard file are byte-equal to the
reference's, at the same steps, and the trainer's key afterwards is the
reference's."""

import glob

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops import gibbs_pallas, nade_pallas  # noqa: E402
from multinn_tpu.ops import nade_ops as jax_nade_ops  # noqa: E402
from multinn_tpu.training import trainer as jax_trainer  # noqa: E402
from multinn_tpu.utils import config as jax_config  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.training import trainer  # noqa: E402
from multinn_torch.utils import config, images, tb  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

torch.set_num_threads(1)
K, D = 2, 24                 # the synthetic source needs 24 pitches
MODEL = dict(n_tracks=K, n_pitches=D, mode="feedback", n_hidden=6, n_rnn=4,
             cd_k=1, gen_k=2, w_std=0.5)
DATA = dict(dataset="synthetic", n_tracks=K, pitch_min=48,
            pitch_max=48 + D - 1, window=6, batch_size=3, synthetic_songs=6,
            synthetic_steps=20)


@pytest.fixture
def interpret_samplers(monkeypatch):
    """The JAX dispatch runs the Pallas Gibbs chain and NADE sampler in
    interpret mode, so it draws the port's stream."""
    chain = gibbs_pallas.gibbs_chain
    monkeypatch.setenv("MULTINN_GIBBS_IMPL", "pallas")
    monkeypatch.setattr(
        gibbs_pallas, "gibbs_chain",
        lambda key, v0, w, bv, bh, k, interpret=True: chain(
            key, v0, w, bv, bh, k, True))
    monkeypatch.setattr(
        jax_nade_ops, "nade_sample",
        lambda key, w, v, bv, bh, batch_shape=(), impl="auto":
            nade_pallas.sample(key, w, v, bv, bh, batch_shape, True))


def _images(run_dir):
    (path,) = glob.glob(f"{run_dir}/tb/events.out.tfevents.*")
    return [(e["step"], tag, im["png"]) for e in tb.read_events(path)
            for tag, im in e["images"].items()]


@pytest.mark.parametrize("decoder", ["rnn-rbm", "rnn-nade"])
def test_image_summaries_equal_the_jax_trainers(tmp_path, decoder,
                                                interpret_samplers):
    cfg = config.ExperimentConfig(
        name="images", data=config.DataConfig(**DATA),
        model=multinn.MultINNConfig(**dict(MODEL, decoder_type=decoder)),
        train=config.TrainConfig(
            epochs=2, lr=3e-3, seed=5, steps_per_call=1, log_every_steps=2,
            image_summaries=True,
            run_dir=str(tmp_path / "torch"))).validate()
    d = config.to_dict(cfg)
    jcfg = jax_config.from_dict(jax_config.ExperimentConfig, dict(
        d, train=dict(d["train"], run_dir=str(tmp_path / "jax"))))
    jp = jax_multinn.init(jax.random.PRNGKey(1), jcfg.model)
    jt = jax_trainer.Trainer(jcfg, params=jp)
    tt = trainer.Trainer(cfg, params=from_jax(jp, device="cpu"))
    tt.train()
    jt.train()
    jt.ckpt.wait()
    got, want = _images(tmp_path / "torch"), _images(tmp_path / "jax")
    assert [(s, t) for s, t, _ in got] == [(s, t) for s, t, _ in want] == [
        (5, "valid/reference"), (5, "valid/sample"), (10, "valid/sample")]
    for (_, tag, png), (_, _, jpng) in zip(got, want):
        assert png == jpng, tag
    # the reference is the first validation window, drawn as the port draws
    np.testing.assert_array_equal(
        images.decode_png(got[0][2]),
        images.render_pianoroll(tt.dataset.windows["valid"][0]))
    np.testing.assert_array_equal(tt.rng.numpy(), np.asarray(jt.rng))
    tt.close()
    jt.close()
