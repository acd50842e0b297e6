"""Encoders — port of the pass-through half of multinn_tpu/models/encoders.py.

A pass-through encoder (``hidden_sizes=()``) has no parameters and its
decoder-facing features are the pianoroll frames themselves. The DBN stack
is not ported yet (ROADMAP queue 1, DBN encoders slice).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DBN = ("DBN encoders are not ported yet (ROADMAP queue 1, 'DBN encoders' "
        "slice); use encoder_hidden=() (pass-through)")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """hidden_sizes=() means pass-through (identity)."""

    n_in: int
    hidden_sizes: Tuple[int, ...] = ()
    w_std: float = 0.01


def init(cfg: EncoderConfig) -> tuple:
    if cfg.hidden_sizes:
        raise NotImplementedError(_DBN)
    return ()


def out_dim(cfg: EncoderConfig) -> int:
    return cfg.hidden_sizes[-1] if cfg.hidden_sizes else cfg.n_in


def features(params, x: torch.Tensor) -> torch.Tensor:
    """Decoder-facing features: the frames themselves for pass-through."""
    if params:
        raise NotImplementedError(_DBN)
    return x
