"""Encoders — port of multinn_tpu/models/encoders.py.

Two encoder types behind one contract (params is a tuple of
``nn.rbm.RBMParams``, empty = pass-through):

  * pass-through: no parameters; the decoder-facing features are the
    pianoroll frames themselves;
  * DBN: a stack of RBMs. The upward pass h^{l+1} = sigmoid(h^l W_l + bh_l)
    gives latent features, the downward pass sigmoid(h W_l^T + bv_l)
    decodes them back to pianoroll space. Layer l is pre-trained greedily
    by CD on the layer-(l-1) features (``pretrain_loss``, whose chain runs
    on ``ops/gibbs.cd_loss``: the Gibbs kernel on the card).

The functions here take ONE encoder. The per-track architecture's
track-stacked encoders (a leading K axis on every tensor) are applied
track by track by ``models/multinn.py``, where the JAX package vmaps.
The layers' products follow the bf16 matmul policy (ops/precision.py).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from multinn_torch.nn import rbm as rbm_nn
from multinn_torch.ops import gibbs as gibbs_ops
from multinn_torch.ops import sampling
from multinn_torch.ops.precision import mm


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """hidden_sizes=() means pass-through (identity). ``encode`` returns
    mean-field probabilities; decoder-facing features go through
    ``features``, which binarizes and freezes them."""

    n_in: int
    hidden_sizes: Tuple[int, ...] = ()
    w_std: float = 0.01


def init(cfg: EncoderConfig, generator=None, device=None) -> tuple:
    """One RBM per hidden size, drawn in order from ``generator``."""
    sizes = (cfg.n_in, *cfg.hidden_sizes)
    return tuple(rbm_nn.init(sizes[i], sizes[i + 1], w_std=cfg.w_std,
                             generator=generator, device=device)
                 for i in range(len(cfg.hidden_sizes)))


def out_dim(cfg: EncoderConfig) -> int:
    return cfg.hidden_sizes[-1] if cfg.hidden_sizes else cfg.n_in


def _up(layer, h: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(mm(h, layer.w) + layer.bh)


def encode(params, x: torch.Tensor, key=None) -> torch.Tensor:
    """Deterministic upward pass (probabilities); with ``key`` the top
    layer is Bernoulli-sampled instead."""
    h = x
    for i, layer in enumerate(params):
        h = _up(layer, h)
        if key is not None and i == len(params) - 1:
            h = sampling.bernoulli(key, h)
    return h


def features(params, x: torch.Tensor) -> torch.Tensor:
    """Decoder-facing features: ``encode`` thresholded at 0.5 and detached
    (DBN; pass-through returns x). The decoders model these binary latents
    and generation samples them; the encoder trains only by CD
    pre-training, never through the decoder's loss. The threshold is taken
    on sigmoid(s), as the JAX package does: in float32 sigmoid(s) rounds to
    0.5 for s down to about -1e-7, so ``s >= 0`` would give other bits."""
    if not params:
        return x
    h = encode(params, x)
    return (h >= 0.5).to(h.dtype).detach()


def decode_logits(params, h: torch.Tensor) -> torch.Tensor:
    """Downward pass to the first layer's pre-sigmoid logits (upper layers
    pass mean-field probabilities down), so generation temperature can
    scale the sampled conditional's logits."""
    v = h
    for layer in reversed(params[1:]):
        v = torch.sigmoid(mm(v, layer.w.transpose(-1, -2)) + layer.bv)
    first = params[0]
    return mm(v, first.w.transpose(-1, -2)) + first.bv


def decode(params, h: torch.Tensor) -> torch.Tensor:
    """Downward pass to pianoroll-space probabilities (identity for the
    pass-through encoder)."""
    if not params:
        return h
    return torch.sigmoid(decode_logits(params, h))


def init_visible_biases(params, x: torch.Tensor, eps: float = 1e-4) -> tuple:
    """Each layer's visible bias set to logit(marginal) of its input: layer
    0 from the data x, upper layers from the chained sigmoid features, so
    the decode conditional starts calibrated to the data's density."""
    if not params:
        return params
    out = []
    h = x.reshape(-1, x.shape[-1])
    for layer in params:
        m = torch.clamp(h.mean(dim=0), eps, 1.0 - eps)
        out.append(dataclasses.replace(layer,
                                       bv=torch.log(m) - torch.log1p(-m)))
        h = _up(layer, h)
    return tuple(out)


def decode_calibration(params, x: torch.Tensor) -> dict:
    """Marginals of the data and of the decode probabilities
    p(v | features(x)): ``data_mean``, ``decode_mean``, and the mean decode
    probability on the bits that are 0 (``p_on_given_off``) and 1
    (``p_on_given_on``) in x. A decode_mean / data_mean far from 1 scales
    every generated roll's density whatever the decoder learns."""
    x2 = x.reshape(-1, x.shape[-1])
    pv = decode(params, features(params, x2))
    on = x2.sum()
    n = x2.numel()
    return {
        "data_mean": x2.mean(),
        "decode_mean": pv.mean(),
        "p_on_given_off": (pv * (1 - x2)).sum() / torch.clamp(n - on,
                                                              min=1.0),
        "p_on_given_on": (pv * x2).sum() / torch.clamp(on, min=1.0),
    }


def layer_inputs(params, x: torch.Tensor, layer: int) -> torch.Tensor:
    """Features feeding RBM ``layer`` during greedy pre-training."""
    h = x
    for lyr in params[:layer]:
        h = _up(lyr, h)
    return h


def pretrain_loss(params, key: torch.Tensor, x: torch.Tensor, layer: int,
                  k: int = 1) -> torch.Tensor:
    """CD-k loss of RBM ``layer`` on the detached lower-layer features: the
    greedy layer-wise objective; lower layers get no gradient."""
    feats = layer_inputs(params, x, layer).detach()
    p = params[layer]
    return gibbs_ops.cd_loss(key, feats, p.w, p.bv, p.bh, k=k)
