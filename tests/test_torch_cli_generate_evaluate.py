"""The port's generate and evaluate entry points on the CPU
(``--device cpu``), on a module-scoped tiny run whose params the JAX
package's run shares (``from_jax``):

* ``multinn_torch.generate.main`` writes the MIDI files, a PNG each and
  ``pianorolls.npz`` (rolls bit-equal to ``Generator.generate`` then
  ``finalize`` under the CLI's key, ``PRNGKey(train.seed + 7)``), prints
  the reference's summary line, accompanies a .mid the port wrote and an
  .npz roll (the given track passes through), and exits 2 for the inputs
  the JAX CLI exits 2 for;
* ``multinn_torch.evaluate.main`` writes the JAX CLI's report keys;
  ``frame`` within 1e-5 of the JAX CLI's on the shared params, with the
  JAX Gibbs chain and NADE sampler in interpret mode (the port's stream);
  ``musical_corpus`` identical; ``musical_generated`` equal to
  ``evaluate_rolls`` of the port's own rolls under ``PRNGKey(seed + 99)``.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import evaluate as jax_evaluate_cli  # noqa: E402
import generate as jax_generate_cli  # noqa: E402
from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_tpu.ops import gibbs_pallas, nade_pallas  # noqa: E402
from multinn_tpu.ops import nade_ops as jax_nade_ops  # noqa: E402
from multinn_tpu.training import trainer as jax_trainer  # noqa: E402
from multinn_tpu.utils import config as jax_config  # noqa: E402
from multinn_torch import evaluate as evaluate_cli  # noqa: E402
from multinn_torch import generate as generate_cli  # noqa: E402
from multinn_torch.data import midi, pianoroll  # noqa: E402
from multinn_torch.data.datasets import Dataset  # noqa: E402
from multinn_torch.eval import musical  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.ops import sampling  # noqa: E402
from multinn_torch.training import trainer  # noqa: E402
from multinn_torch.training.generator import Generator  # noqa: E402
from multinn_torch.utils import config  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

torch.set_num_threads(1)
K, D = 2, 24                 # the synthetic source needs 24 pitches
N_STEPS, N_SAMPLES = 16, 2
TOL = dict(rtol=1e-5, atol=1e-5)


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


def _make_runs(root, decoder):
    """A port run and a JAX run with the same config and params, each with
    one checkpoint (step 0, the best)."""
    cfg = config.ExperimentConfig(
        name=f"cli-{decoder}",
        data=config.DataConfig(dataset="synthetic", n_tracks=K,
                               pitch_min=48, pitch_max=48 + D - 1, window=16,
                               batch_size=4, synthetic_songs=6,
                               synthetic_steps=48),
        model=multinn.MultINNConfig(n_tracks=K, n_pitches=D,
                                    decoder_type=decoder, n_hidden=8,
                                    n_rnn=6, gen_k=2, w_std=0.5),
        train=config.TrainConfig(seed=3),
        generate=config.GenerateConfig(n_steps=N_STEPS, n_samples=N_SAMPLES,
                                       seed_steps=4))
    runs = {}
    jp = jax_multinn.init(jax.random.PRNGKey(2), cfg.model)
    for side in ("torch", "jax"):
        run = str(root / f"{decoder}-{side}")
        os.makedirs(run)
        cfg_r = config.apply_overrides(cfg, [f"train.run_dir={run}"])
        config.save_json(cfg_r, os.path.join(run, "config.json"))
        if side == "torch":
            t = trainer.Trainer(cfg_r, params=from_jax(jp, device="cpu"))
        else:
            t = jax_trainer.Trainer(jax_config.load_json(
                os.path.join(run, "config.json")), params=jp)
        t.save_checkpoint(metrics={"valid_loss": 1.0})
        t.ckpt.wait()
        t.close()
        runs[side] = run
    return runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    return {dec: _make_runs(root, dec) for dec in ("rnn-rbm", "rnn-nade")}


def _restored(run):
    """The run's config and its trainer, restored as the CLIs restore."""
    cfg = config.load_run_config(run, None, [])
    t = trainer.Trainer(cfg, device="cpu")
    t.restore(t.ckpt.best_step())
    return cfg, t


@pytest.mark.parametrize("decoder", ["rnn-rbm", "rnn-nade"])
def test_generate_writes_the_files_of_the_fused_generation(runs, decoder,
                                                           capsys):
    run = runs[decoder]["torch"]
    assert generate_cli.main(["--run", run, "--device", "cpu"]) == 0
    out = os.path.join(run, "samples")
    names = sorted(os.listdir(out))
    assert names == ["pianorolls.npz", "sample_000.mid", "sample_000.png",
                     "sample_001.mid", "sample_001.png"]
    with np.load(os.path.join(out, "pianorolls.npz")) as z:
        rolls = z["rolls"]
    assert rolls.shape == (N_SAMPLES, N_STEPS, K, D)
    assert rolls.dtype == np.uint8
    cfg, t = _restored(run)
    gen = Generator(cfg, t.params)
    seed = t.dataset.seed_windows("valid", n=N_SAMPLES)[:, :4]
    want = gen.finalize(gen.generate(sampling.PRNGKey(cfg.train.seed + 7),
                                     N_STEPS, seed=seed))
    np.testing.assert_array_equal(rolls, want)
    t.close()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == (f"wrote {N_SAMPLES} MIDI files to {out} (pianoroll "
                    f"shape {rolls.shape}, density {rolls.mean():.4f})")
    # read back: with K != 5 every instrument maps to track 0
    back = pianoroll.midi_to_roll(midi.load(os.path.join(
        out, "sample_001.mid")), cfg.data.spec(), max_steps=N_STEPS)
    np.testing.assert_array_equal(back[:, 0],
                                  rolls[1, :len(back)].max(axis=1))


def test_generate_accompanies_a_midi_file_and_an_npz(runs, tmp_path):
    run = runs["rnn-rbm"]["torch"]
    cfg = config.load_run_config(run, None, [])
    given = np.zeros((12, K, D), np.uint8)
    given[::2, 0, 5] = 1            # the MIDI file holds track 0 only: with
    given[1::3, 0, 9] = 1           # K != 5 every instrument reads as 0
    gen = Generator(cfg, multinn.init(cfg.model, device="cpu"))
    gen.to_midi(given, str(tmp_path / "given.mid"))
    given[:, 1, 2] = 1              # the npz's track 1 is not given
    np.savez(str(tmp_path / "given.npz"), roll=given * 3)
    for path, out_dir in ((tmp_path / "given.mid", "acc_mid"),
                          (tmp_path / "given.npz", "acc_npz")):
        assert generate_cli.main([
            "--run", run, "--device", "cpu", "--accompany", str(path),
            "--accompany-tracks", "0", f"--generate.out_dir={out_dir}"]) == 0
        out = os.path.join(run, out_dir)
        assert {"accompany_000.mid", "accompany_000.png",
                "pianorolls.npz"} <= set(os.listdir(out))
        with np.load(os.path.join(out, "pianorolls.npz")) as z:
            rolls = z["rolls"]
        assert rolls.shape[0] == 1 and rolls.shape[2:] == (K, D)
        want = given[:rolls.shape[1], 0]
        np.testing.assert_array_equal(rolls[0, :len(want), 0], want)


def test_generate_exits_2_where_the_jax_cli_does(runs, tmp_path):
    bogus = tmp_path / "bogus.npz"
    bogus.write_text("not an npz")
    nokey = tmp_path / "nokey.npz"
    np.savez(str(nokey), other=np.zeros(3))
    badmid = tmp_path / "bad.mid"
    badmid.write_bytes(b"MThd garbage")
    cases = [["--run", str(tmp_path / "nowhere")],
             ["--accompany", str(bogus)],
             ["--accompany", str(bogus), "--accompany-tracks", "0"],
             ["--accompany", str(nokey), "--accompany-tracks", "0"],
             ["--accompany", str(badmid), "--accompany-tracks", "0"]]
    for case in cases:
        run = ([] if case[0] == "--run"
               else ["--run", runs["rnn-nade"]["torch"]])
        assert generate_cli.main(run + case + ["--device", "cpu"]) == 2, case
        jrun = [] if case[0] == "--run" else ["--run",
                                              runs["rnn-nade"]["jax"]]
        assert jax_generate_cli.main(jrun + case) == 2, case


@pytest.mark.parametrize("decoder", ["rnn-rbm", "rnn-nade"])
def test_evaluate_report_matches_the_jax_cli(runs, decoder,
                                             interpret_samplers, capsys):
    args = ["--split", "valid", "--n-gen", "4"]
    assert evaluate_cli.main(["--run", runs[decoder]["torch"], "--device",
                              "cpu"] + args) == 0
    assert jax_evaluate_cli.main(["--run", runs[decoder]["jax"]] + args) == 0
    capsys.readouterr()
    reports = {}
    for side, run in runs[decoder].items():
        with open(os.path.join(run, "eval_valid.json")) as f:
            reports[side] = json.load(f)
    got, want = reports["torch"], reports["jax"]
    assert set(got) == set(want)
    assert {"frame", "musical_generated", "musical_corpus",
            "musical_significance"} <= set(got)
    assert (got["step"], got["split"], got["encoding"]) == (
        want["step"], want["split"], want["encoding"])
    assert set(got["frame"]) == set(want["frame"])
    for name, v in want["frame"].items():
        np.testing.assert_allclose(got["frame"][name], v, **TOL,
                                   err_msg=name)
    assert got["musical_corpus"] == want["musical_corpus"]
    assert set(got["musical_significance"]) == set(
        want["musical_significance"])
    cfg, t = _restored(runs[decoder]["torch"])
    gen = Generator(cfg, t.params)
    seed = t.dataset.seed_windows("valid", n=4)[:, :4]
    rolls = gen.finalize(gen.generate(sampling.PRNGKey(cfg.train.seed + 99),
                                      N_STEPS, seed=seed))
    assert got["musical_generated"] == json.loads(json.dumps(
        musical.evaluate_rolls(rolls, 16, cfg.data.pitch_min, None)))
    np.testing.assert_allclose(got["frame"]["ll_per_frame"],
                               t.evaluate("valid")["ll_per_frame"], **TOL)
    t.close()


def test_evaluate_without_musical_and_with_a_missing_run(runs, tmp_path,
                                                         capsys):
    run = runs["rnn-nade"]["torch"]
    assert evaluate_cli.main(["--run", run, "--device", "cpu", "--latest",
                              "--split", "test", "--no-musical"]) == 0
    with open(os.path.join(run, "eval_test.json")) as f:
        report = json.load(f)
    assert set(report) == {"run", "step", "split", "encoding", "frame"}
    assert json.loads(capsys.readouterr().out) == report
    assert evaluate_cli.main(["--run", str(tmp_path / "none"),
                              "--device", "cpu"]) == 2
    ds = Dataset(config.load_run_config(run, None, []).data)
    assert len(ds.windows["test"]) > 0
