"""multinn_torch — the PyTorch/CUDA port of multinn_tpu for one NVIDIA H100.

The JAX package (``multinn_tpu``) stays beside this one as the reference;
every module here mirrors the JAX module of the same name so a reader can
find each counterpart. This package imports neither JAX nor anything of
``multinn_tpu``, not even its framework-free modules: what it needs of
them (the pianoroll encodings, ``data/pianoroll.py``) is its own copy.
Only the tests import both packages, to compare them.

Conventions:
  * the entry points (``multinn.init``, ``utils.convert.from_jax``,
    ``training.trainer.Trainer``) put the model on the CUDA device unless
    given ``device="cpu"``, and raise when there is no CUDA device and no
    explicit device; everything below them runs where its inputs lie;
  * parameters and states are dataclasses of tensors; every function takes
    them explicitly (no hidden module state, no global RNG);
  * randomness is a Threefry key — two uint32 words as a tensor — passed in
    and derived with ``ops.sampling`` (PRNGKey / fold_in / split), bit-equal
    to ``jax.random`` raw keys;
  * each hand-written CUDA kernel (``csrc/``) has a plain-PyTorch version of
    the same function beside it: CPU tensors take the plain version, CUDA
    tensors launch the kernel (``ops/_build.py`` builds it at first use).
"""

__version__ = "0.1.0"

_EXPORTS = {
    "MultINNConfig": ("multinn_torch.models.multinn", "MultINNConfig"),
    "MultINNParams": ("multinn_torch.models.multinn", "MultINNParams"),
    "multinn": ("multinn_torch.models", "multinn"),
    "Generator": ("multinn_torch.training.generator", "Generator"),
    "Trainer": ("multinn_torch.training.trainer", "Trainer"),
    "Dataset": ("multinn_torch.data.datasets", "Dataset"),
    "DataConfig": ("multinn_torch.data.datasets", "DataConfig"),
    "TrainConfig": ("multinn_torch.utils.config", "TrainConfig"),
    "MeshConfig": ("multinn_torch.parallel.mesh", "MeshConfig"),
    "GenerationService": ("multinn_torch.serving.service",
                          "GenerationService"),
    "ServeConfig": ("multinn_torch.serving.service", "ServeConfig"),
    "ExperimentConfig": ("multinn_torch.utils.config", "ExperimentConfig"),
    "GenerateConfig": ("multinn_torch.utils.config", "GenerateConfig"),
    "load_config": ("multinn_torch.utils.config", "load_json"),
    "from_jax": ("multinn_torch.utils.convert", "from_jax"),
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        module, attr = _EXPORTS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'multinn_torch' has no attribute '{name}'")


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))
