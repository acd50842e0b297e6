"""The port's public API (tests/test_public_api.py on the CPU): the
top-level re-exports resolve, and a user drives the whole flow — config,
Trainer, train, Generator — through them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def test_top_level_exports():
    import multinn_torch as mt
    for name in ("MultINNConfig", "Trainer", "Generator", "Dataset",
                 "DataConfig", "ExperimentConfig", "MeshConfig",
                 "TrainConfig", "load_config", "multinn"):
        assert getattr(mt, name) is not None
    assert "Trainer" in dir(mt)


def test_api_flow(tmp_path):
    import multinn_torch as mt

    data = mt.DataConfig.from_preset("synthetic", n_tracks=2, pitch_min=40,
                                     pitch_max=63, window=8, batch_size=4,
                                     synthetic_songs=4, synthetic_steps=32)
    model = mt.MultINNConfig(n_tracks=2, n_pitches=24,
                             decoder_type="rnn-nade", n_hidden=8, n_rnn=6,
                             gen_k=2)
    cfg = mt.ExperimentConfig(
        name="api", data=data, model=model,
        train=mt.TrainConfig(epochs=1, run_dir=str(tmp_path / "api"),
                             ckpt_every_steps=0)).validate()
    trainer = mt.Trainer(cfg, device="cpu")
    trainer.train()
    gen = mt.Generator(cfg, trainer.params)
    from multinn_torch.ops import sampling
    rolls = gen.generate(sampling.PRNGKey(0), n_steps=4, batch=2)
    assert rolls.shape == (2, 4, 2, 24)
    assert set(np.unique(rolls)) <= {0, 1}
    trainer.close()
