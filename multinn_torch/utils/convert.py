"""Parameter conversion from the JAX package — ``from_jax``.

Duck-typed on the JAX pytree (attributes, ``np.asarray`` on each leaf), so
this module imports no jax. The layout is kept as is: the track-stacked
leading axis K; LSTM ``wx`` (in, 4U), ``wh`` (U, 4U), ``b`` (4U) in gate
order i, f, g, o; RBM ``w`` (F, H) and NADE ``w``, ``v`` (F, H);
``wuv`` (U, F); ``wuh`` (U, H).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multinn_torch.models import multinn
from multinn_torch.models.base import get_decoder
from multinn_torch.nn import rnn as rnn_nn


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def _cell(p, device):
    four = p.wx.shape[-1] == 4 * p.wh.shape[-2]      # LSTM gates i, f, g, o
    cls = rnn_nn.LSTMParams if four else rnn_nn.VanillaRNNParams
    return cls(wx=_tensor(p.wx, device), wh=_tensor(p.wh, device),
               b=_tensor(p.b, device))


def from_jax(params, device=None) -> multinn.MultINNParams:
    """A JAX ``MultINNParams`` (RNN-RBM or RNN-NADE decoder, pass-through
    encoder) -> the port's MultINNParams on ``device``."""
    cfg = multinn.MultINNConfig(**dataclasses.asdict(params.cfg))
    if cfg.encoder_hidden:
        raise NotImplementedError("from_jax covers pass-through encoders")
    mod = get_decoder(cfg.decoder_type)
    d = params.decoder
    decoder = mod.Params(
        cell=tuple(_cell(c, device) for c in d.cell),
        cfg=cfg.decoder_config(),
        **{f.name: _tensor(getattr(d, f.name), device)
           for f in dataclasses.fields(mod.Params)
           if f.name not in ("cell", "cfg")})
    return multinn.MultINNParams(encoder=(), decoder=decoder, cfg=cfg)
