"""Typed experiment configs — mirror of multinn_tpu/utils/config.py.

Same dataclasses, field names and defaults, so every ``configs/*.json``
loads into either package (a test holds the field sets equal), plus the
helpers of the reference's CLIs: ``validate``, ``save_json``,
``load_run_config`` and ``apply_overrides`` (dot-path ``a.b.c=value``
overrides; an unknown path raises). ``MultINNConfig`` lives in
models/multinn.py as in the reference. ``DataConfig`` (with its corpus
``PRESETS``; multinn_tpu/data/datasets.py) and ``MeshConfig``
(multinn_tpu/parallel/mesh.py) live here, and ``data/datasets.py`` and
``parallel/mesh.py`` re-export them: the models import the parallel
package's collectives, and the config imports the models.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Any, Dict, List, Tuple, get_args, get_origin

from multinn_torch.data import pianoroll as pr
from multinn_torch.models.multinn import MultINNConfig

PRESETS: Dict[str, dict] = {
    # dataset -> spec knobs and canonical source. Non-synthetic presets name
    # their real source, so a preset without data.path fails loudly instead
    # of training on synthetic data under a corpus's name. Multi-track
    # presets leave track 0 (drums) out of the transposition augmentation.
    "jsb": dict(n_tracks=1, pitch_min=21, pitch_max=108, steps_per_quarter=4,
                source="pickle"),
    "nottingham": dict(n_tracks=1, pitch_min=21, pitch_max=108,
                       steps_per_quarter=4, source="pickle"),
    "lpd5": dict(n_tracks=5, pitch_min=24, pitch_max=107,
                 steps_per_quarter=4, source="midi_dir",
                 transpose_exclude=(0,)),
    "lakh": dict(n_tracks=5, pitch_min=24, pitch_max=107,
                 steps_per_quarter=4, source="midi_dir",
                 transpose_exclude=(0,)),
    "synthetic": dict(n_tracks=5, pitch_min=24, pitch_max=107,
                      steps_per_quarter=4, source="synthetic",
                      transpose_exclude=(0,)),
}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"
    source: str = "synthetic"
    path: str = ""
    steps_per_quarter: int = 4
    pitch_min: int = 21
    pitch_max: int = 108
    n_tracks: int = 1
    window: int = 64
    batch_size: int = 32
    splits: Tuple[float, float, float] = (0.8, 0.1, 0.1)
    seed: int = 0
    synthetic_songs: int = 64
    synthetic_steps: int = 256
    encoding: str = "frame"            # "frame" | "onset_hold"
    transpose_range: int = 0
    transpose_exclude: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.encoding not in ("frame", "onset_hold"):
            raise ValueError(f"data.encoding must be 'frame' or "
                             f"'onset_hold', got {self.encoding!r}")
        if self.transpose_range < 0:
            raise ValueError(f"data.transpose_range must be >= 0, got "
                             f"{self.transpose_range}")
        if self.transpose_range >= self.n_pitches:
            raise ValueError(f"data.transpose_range={self.transpose_range} "
                             f"must be < n_pitches={self.n_pitches}")
        bad = [k for k in self.transpose_exclude
               if not 0 <= k < self.n_tracks]
        if bad:
            raise ValueError(f"data.transpose_exclude indices {bad} out of "
                             f"range for n_tracks={self.n_tracks}")

    @staticmethod
    def from_preset(dataset: str, **overrides) -> "DataConfig":
        base = dict(PRESETS[dataset], dataset=dataset)
        base.update(overrides)
        return DataConfig(**base)

    def spec(self) -> pr.RollSpec:
        return pr.RollSpec(steps_per_quarter=self.steps_per_quarter,
                           pitch_min=self.pitch_min,
                           pitch_max=self.pitch_max,
                           n_tracks=self.n_tracks)

    @property
    def n_pitches(self) -> int:
        return self.pitch_max - self.pitch_min + 1

    @property
    def frame_dim(self) -> int:
        """Per-track visible width the model sees (model.n_pitches)."""
        return self.n_pitches * (2 if self.encoding == "onset_hold" else 1)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 10
    lr: float = 1e-3
    lr_schedule: str = "constant"
    lr_min: float = 0.0
    warmup_steps: int = 0
    decay_steps: int = 0
    optimizer: str = "adam"
    hf_cg_iters: int = 25
    hf_lambda0: float = 1.0
    grad_clip: float = 5.0
    weight_decay: float = 0.0
    seed: int = 42
    steps_per_call: int = 1
    eval_every_epochs: int = 1
    log_every_steps: int = 50
    ckpt_every_steps: int = 500
    keep_last: int = 3
    keep_best: bool = True
    early_stop_patience: int = 0
    pretrain_encoder_epochs: int = 0
    pretrain_lr: float = 1e-3
    fault_inject_step: int = -1
    image_summaries: bool = False
    run_dir: str = "runs/default"


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    n_steps: int = 1024                # 64 bars x 16 steps/bar
    n_samples: int = 2
    seed_steps: int = 32
    gibbs_k: int = 0                   # 0 = use model cfg gen_k
    temperature: float = 1.0
    bpm: float = 120.0
    out_dir: str = "samples"
    gap_fill_steps: int = 0
    min_note_steps: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    use_mesh: bool = False
    data: int = 0
    track: int = 1
    model: int = 1
    seq: int = 1
    seq_microbatches: int = 0
    style: str = "gspmd"

    def __post_init__(self):
        if self.style not in ("gspmd", "shard_map", "seqpipe"):
            raise ValueError(
                f"unknown mesh.style '{self.style}' "
                "(expected gspmd | shard_map | seqpipe)")

    def resolved_data(self, n_devices: int) -> int:
        """The data axis: ``data``, or 0 = every rank the other axes leave
        (``n_devices`` is the world's rank count)."""
        if self.data > 0:
            return self.data
        other = self.track * self.model * self.seq
        if n_devices % other:
            raise ValueError(
                f"track*model*seq = {other} does not divide the device "
                f"count {n_devices}; set mesh.data explicitly or adjust "
                f"the axis sizes")
        return n_devices // other


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "experiment"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: MultINNConfig = dataclasses.field(default_factory=MultINNConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    generate: GenerateConfig = dataclasses.field(
        default_factory=GenerateConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def validate(self) -> "ExperimentConfig":
        """The reference's cross-section checks; returns self."""
        if self.model.n_tracks != self.data.n_tracks:
            raise ValueError(
                f"model.n_tracks={self.model.n_tracks} != "
                f"data.n_tracks={self.data.n_tracks}")
        if self.model.n_pitches != self.data.frame_dim:
            hint = (" (data.encoding=onset_hold doubles the visible width: "
                    f"set model.n_pitches={self.data.frame_dim})"
                    if self.data.encoding != "frame" else "")
            raise ValueError(
                f"model.n_pitches={self.model.n_pitches} != data frame dim "
                f"{self.data.frame_dim}{hint}")
        mesh = self.mesh
        if mesh.use_mesh and mesh.track > 1:
            if mesh.style != "gspmd":
                raise ValueError("track sharding requires mesh.style=gspmd")
            if self.model.mode == "joint":
                raise ValueError("joint mode has no track axis to shard")
            if self.model.n_tracks % mesh.track:
                raise ValueError(
                    f"n_tracks={self.model.n_tracks} not divisible by "
                    f"mesh.track={mesh.track}")
        if mesh.use_mesh and mesh.model > 1:
            if mesh.style != "gspmd":
                raise ValueError(
                    "tensor (model-axis) sharding requires mesh.style=gspmd")
            if self.model.n_hidden % mesh.model:
                raise ValueError(
                    f"n_hidden={self.model.n_hidden} not divisible by "
                    f"mesh.model={mesh.model}")
        if mesh.use_mesh and mesh.seq > 1:
            if mesh.style != "seqpipe":
                raise ValueError(
                    "time (seq-axis) sharding requires mesh.style=seqpipe")
            if self.data.window % mesh.seq:
                raise ValueError(
                    f"data.window={self.data.window} not divisible by "
                    f"mesh.seq={mesh.seq}")
        if mesh.style == "seqpipe" and mesh.seq <= 1:
            raise ValueError("mesh.style=seqpipe requires mesh.seq > 1")
        return self


def _coerce(value: Any, typ: Any) -> Any:
    origin = get_origin(typ)
    if dataclasses.is_dataclass(typ) and isinstance(value, dict):
        return from_dict(typ, value)
    if origin in (tuple, Tuple) and isinstance(value, (list, tuple)):
        args = get_args(typ)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(v, args[0]) for v in value)
        if args:
            return tuple(_coerce(v, t) for v, t in zip(value, args))
        return tuple(value)
    if origin in (list, List) and isinstance(value, (list, tuple)):
        (arg,) = get_args(typ) or (Any,)
        return [_coerce(v, arg) for v in value]
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if typ in (int, float) and isinstance(value, str):
        return typ(value)
    if typ is float and isinstance(value, int):
        return float(value)
    if origin is typing.Union:           # Optional[...]
        for arg in get_args(typ):
            if arg is type(None):
                if value is None or value == "none":
                    return None
                continue
            try:
                return _coerce(value, arg)
            except (TypeError, ValueError):
                continue
    return value


def from_dict(cls, d: Dict[str, Any]):
    """Build dataclass ``cls`` from a nested dict; unknown keys raise."""
    fields = {f.name for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls)
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: "
                         f"{sorted(unknown)}")
    return cls(**{k: _coerce(v, hints[k]) for k, v in d.items()})


def to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def _migrate(d: Dict[str, Any]) -> Dict[str, Any]:
    train = d.get("train", {})
    if "remat" in train:                     # moved: train.remat -> model.remat
        d.setdefault("model", {})["remat"] = train.pop("remat")
    return d


def load_json(path: str) -> ExperimentConfig:
    with open(path) as f:
        return from_dict(ExperimentConfig, _migrate(json.load(f)))


def save_json(cfg: ExperimentConfig, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)
        f.write("\n")


def load_run_config(run_dir, config_path, overrides) -> ExperimentConfig:
    """The config of a run: ``config_path`` if given, else
    ``<run_dir>/config.json``; applies the overrides and pins
    ``train.run_dir`` to ``run_dir``. Raises FileNotFoundError if absent."""
    path = config_path or os.path.join(run_dir or "", "config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"config not found: {path}")
    cfg = load_json(path)
    ovs = list(overrides or [])
    if run_dir:
        ovs.insert(0, f"train.run_dir={run_dir}")
    if ovs:
        cfg = apply_overrides(cfg, ovs)
    return cfg.validate()


def on_one_device(cfg: ExperimentConfig) -> ExperimentConfig:
    """``cfg`` without its mesh: the single-process entry points (generate,
    evaluate, serve) restore a run trained on a mesh on one device, as its
    checkpoints hold the whole parameters."""
    return dataclasses.replace(cfg, mesh=MeshConfig())


def apply_overrides(cfg: ExperimentConfig,
                    overrides: List[str]) -> ExperimentConfig:
    """Apply ``a.b.c=value`` dot-path overrides (a leading ``--`` allowed).
    Values parse as JSON where they can, else stay strings, then coerce by
    field type; an unknown path raises ValueError."""
    d = to_dict(cfg)
    for ov in overrides:
        ov = ov.lstrip("-")
        if "=" not in ov:
            raise ValueError(f"override '{ov}' is not key=value")
        path, raw = ov.split("=", 1)
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node = d
        keys = path.split(".")
        for k in keys[:-1]:
            if k not in node:
                raise ValueError(f"unknown config path '{path}'")
            node = node[k]
        if keys[-1] not in node:
            raise ValueError(f"unknown config path '{path}'")
        node[keys[-1]] = value
    return from_dict(ExperimentConfig, d)
