"""Parameter conversion from the JAX package — ``from_jax``.

Duck-typed on the JAX pytree (attributes, ``np.asarray`` on each leaf), so
this module imports no jax. The layout is kept as is: the track-stacked
leading axis K; LSTM ``wx`` (in, 4U), ``wh`` (U, 4U), ``b`` (4U) in gate
order i, f, g, o; RBM ``w`` (F, H); ``wuv`` (U, F); ``wuh`` (U, H).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multinn_torch.models import multinn, rnn_rbm
from multinn_torch.nn import rnn as rnn_nn


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def _cell(p, device):
    four = p.wx.shape[-1] == 4 * p.wh.shape[-2]      # LSTM gates i, f, g, o
    cls = rnn_nn.LSTMParams if four else rnn_nn.VanillaRNNParams
    return cls(wx=_tensor(p.wx, device), wh=_tensor(p.wh, device),
               b=_tensor(p.b, device))


def from_jax(params, device=None) -> multinn.MultINNParams:
    """A JAX ``MultINNParams`` (RNN-RBM decoder, pass-through encoder) ->
    the port's MultINNParams on ``device``."""
    cfg = multinn.MultINNConfig(**dataclasses.asdict(params.cfg))
    if cfg.decoder_type != "rnn-rbm" or cfg.encoder_hidden:
        raise NotImplementedError("from_jax covers RNN-RBM decoders with "
                                  "pass-through encoders")
    d = params.decoder
    decoder = rnn_rbm.Params(
        cell=tuple(_cell(c, device) for c in d.cell),
        w=_tensor(d.w, device), bv=_tensor(d.bv, device),
        bh=_tensor(d.bh, device), wuv=_tensor(d.wuv, device),
        wuh=_tensor(d.wuh, device), cfg=cfg.decoder_config())
    return multinn.MultINNParams(encoder=(), decoder=decoder, cfg=cfg)
