"""multinn_torch stands alone and runs on the card by default:

* its pianoroll helpers (``multinn_torch/data/pianoroll.py``, the port's own
  copy) equal ``multinn_tpu.data.pianoroll``'s on seeded random rolls;
* no module of the port, and not ``chip_smoke.py``, imports JAX or the JAX
  package, not even inside a function (an AST scan);
* ``multinn.init``, ``from_jax`` and ``Trainer`` put the model on the CUDA
  device when given no device, and raise where there is none.
"""

import ast
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multinn_tpu.data import pianoroll as jax_pianoroll  # noqa: E402
from multinn_tpu.models import multinn as jax_multinn  # noqa: E402
from multinn_torch.data import pianoroll  # noqa: E402
from multinn_torch.models import multinn  # noqa: E402
from multinn_torch.training import trainer  # noqa: E402
from multinn_torch.utils import config  # noqa: E402
from multinn_torch.utils.convert import from_jax  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(n_tracks=2, n_pitches=6, mode="feedback", n_hidden=5, n_rnn=3)


def _roll(shape, density, seed):
    return (np.random.default_rng(seed).random(shape) < density).astype(
        np.uint8)


@pytest.mark.parametrize("shape,density,seed", [
    ((32, 3, 12), 0.3, 0), ((4, 40, 2, 7), 0.5, 1), ((1, 1, 1), 1.0, 2)])
def test_onset_hold_equals_the_jax_package(shape, density, seed):
    roll = _roll(shape, density, seed)
    if roll.ndim == 3:
        enc = pianoroll.encode_onset_hold(roll)
        np.testing.assert_array_equal(
            enc, jax_pianoroll.encode_onset_hold(roll))
        np.testing.assert_array_equal(pianoroll.decode_onset_hold(enc), roll)
    # a noisy onset/hold roll (orphan holds) decodes alike
    oh = _roll(shape[:-1] + (2 * shape[-1],), density, seed + 10)
    np.testing.assert_array_equal(pianoroll.decode_onset_hold(oh),
                                  jax_pianoroll.decode_onset_hold(oh))


@pytest.mark.parametrize("encoding", ["frame", "onset_hold"])
def test_encode_decode_rolls_equal_the_jax_package(encoding):
    roll = _roll((24, 3, 10), 0.4, 3)
    enc = pianoroll.encode_rolls(roll, encoding)
    np.testing.assert_array_equal(
        enc, jax_pianoroll.encode_rolls(roll, encoding))
    batch = np.stack([enc, enc[::-1]])
    np.testing.assert_array_equal(
        pianoroll.decode_rolls(batch, encoding),
        jax_pianoroll.decode_rolls(batch, encoding))
    with pytest.raises(ValueError, match="unknown encoding"):
        pianoroll.encode_rolls(roll, "midi")
    with pytest.raises(ValueError, match="unknown encoding"):
        pianoroll.decode_rolls(roll, "midi")


@pytest.mark.parametrize("gap,min_steps", [(0, 0), (2, 0), (0, 3), (3, 2),
                                           (1, 4)])
def test_postprocess_roll_equals_the_jax_package(gap, min_steps):
    roll = _roll((2, 64, 3, 9), 0.35, 4)
    got = pianoroll.postprocess_roll(roll, gap, min_steps)
    np.testing.assert_array_equal(
        got, jax_pianoroll.postprocess_roll(roll, gap, min_steps))
    assert got.dtype == np.uint8
    if gap or min_steps > 1:
        assert not np.array_equal(got, roll)       # the knob did something


def _imports(path):
    """Every module name an ``import`` / ``from ... import`` statement in
    ``path`` names, at any depth (functions, methods, branches)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_the_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "multinn_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    scanned = {str(f.relative_to(ROOT)) for f in files}
    assert {"multinn_torch/train.py", "multinn_torch/data/datasets.py",
            "multinn_torch/data/midi.py", "multinn_torch/data/cache.py",
            "multinn_torch/data/native.py", "multinn_torch/utils/tb.py",
            "multinn_torch/utils/logging.py",
            "multinn_torch/training/checkpoint.py",
            "multinn_torch/utils/flops.py", "multinn_torch/utils/profiling.py",
            "multinn_torch/scripts/prepare_dataset.py",
            "multinn_torch/scripts/serve_loadtest.py",
            "multinn_torch/scripts/scale_stress.py",
            "multinn_torch/scripts/ingest_bench.py",
            "multinn_torch/scripts/real_corpus_drill.py"} <= scanned
    bad = {str(f.relative_to(ROOT)): n for f in files for n in _imports(f)
           if n.split(".")[0] in ("jax", "jaxlib", "flax", "multinn_tpu")}
    assert not bad


def test_the_ast_scan_sees_imports_inside_functions(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    if True:\n        from multinn_tpu.data "
                   "import pianoroll\n    import jax.numpy as jnp\n")
    assert sorted(_imports(src)) == ["jax.numpy", "multinn_tpu.data"]


def _cfg():
    return multinn.MultINNConfig(**SMALL)


def test_init_defaults_to_the_card():
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        params = multinn.init(_cfg(), gen)
        assert params.decoder.w.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multinn.init(_cfg(), gen)
    cpu = multinn.init(_cfg(), torch.Generator().manual_seed(0),
                       device="cpu")
    assert all(t.device.type == "cpu" for t in multinn.tree_leaves(cpu))
    # the values are drawn on the CPU: the same seed gives the same params
    # whatever the device
    again = multinn.init(_cfg(), torch.Generator().manual_seed(0),
                         device="cpu")
    for a, b in zip(multinn.tree_leaves(cpu), multinn.tree_leaves(again)):
        assert torch.equal(a, b)


def test_from_jax_defaults_to_the_card():
    jp = jax_multinn.init(jax.random.PRNGKey(0),
                          jax_multinn.MultINNConfig(**SMALL))
    if torch.cuda.is_available():
        assert from_jax(jp).decoder.w.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            from_jax(jp)
    assert from_jax(jp, device="cpu").decoder.w.device.type == "cpu"


def test_trainer_defaults_to_the_card():
    ds = types.SimpleNamespace(n_batches=lambda split: 1)
    cfg = config.ExperimentConfig(model=_cfg())
    if torch.cuda.is_available():
        assert trainer.Trainer(cfg, ds).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainer.Trainer(cfg, ds)
    tr = trainer.Trainer(cfg, ds, device="cpu")
    assert tr.device == torch.device("cpu")
    assert tr.params.decoder.w.device.type == "cpu"
    # given params, the trainer follows them
    p = multinn.init(_cfg(), torch.Generator().manual_seed(1), device="cpu")
    assert trainer.Trainer(cfg, ds, params=p).device.type == "cpu"
