"""Parameter conversion between the packages — ``from_jax`` and its
inverse ``to_numpy``.

Duck-typed on the JAX pytree (attributes, ``np.asarray`` on each leaf), so
this module imports no jax. The layout is kept as is: the track-stacked
leading axis K; LSTM ``wx`` (in, 4U), ``wh`` (U, 4U), ``b`` (4U) in gate
order i, f, g, o; RBM ``w`` (F, H) and NADE ``w``, ``v`` (F, H);
``wuv`` (U, F); ``wuh`` (U, H); a DBN encoder is a tuple of RBM params
``w`` (D_in, D_out), ``bv``, ``bh``, shared (feedback and hybrid modes, and
joint mode over K*D pitches) or with a leading K axis (per-track mode).
The one exception: joint mode's single decoder, unstacked in the JAX
package, is a stack of one track in the port (models/multinn.py), so
``from_jax`` adds that axis and ``to_numpy`` drops it.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from multinn_torch.models import multinn
from multinn_torch.models.base import get_decoder
from multinn_torch.nn import rbm as rbm_nn
from multinn_torch.nn import rnn as rnn_nn
from multinn_torch.utils.device import entry_device


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def _cell(p, device):
    four = p.wx.shape[-1] == 4 * p.wh.shape[-2]      # LSTM gates i, f, g, o
    cls = rnn_nn.LSTMParams if four else rnn_nn.VanillaRNNParams
    return cls(wx=_tensor(p.wx, device), wh=_tensor(p.wh, device),
               b=_tensor(p.b, device))


def from_jax(params, device=None) -> multinn.MultINNParams:
    """A JAX ``MultINNParams`` (RNN-RBM or RNN-NADE decoder, pass-through
    or DBN encoder) -> the port's MultINNParams on ``device``: the CUDA
    card when None, which raises without one."""
    device = entry_device(device)
    cfg = multinn.MultINNConfig(**dataclasses.asdict(params.cfg))
    mod = get_decoder(cfg.decoder_type)
    d = params.decoder
    decoder = mod.Params(
        cell=tuple(_cell(c, device) for c in d.cell),
        cfg=cfg.decoder_config(),
        **{f.name: _tensor(getattr(d, f.name), device)
           for f in dataclasses.fields(mod.Params)
           if f.name not in ("cell", "cfg")})
    if cfg.mode == "joint":             # one decoder -> a stack of one
        decoder = multinn.stack_trees([decoder])
    encoder = tuple(rbm_nn.RBMParams(w=_tensor(e.w, device),
                                     bv=_tensor(e.bv, device),
                                     bh=_tensor(e.bh, device))
                    for e in params.encoder)
    return multinn.MultINNParams(encoder=encoder, decoder=decoder, cfg=cfg)


def to_numpy(params: multinn.MultINNParams) -> SimpleNamespace:
    """The port's MultINNParams -> the JAX layout as numpy arrays: a
    namespace tree with the JAX pytree's attributes (``cfg``, ``encoder``,
    ``decoder.cell[l].wx``, ``decoder.w``, ...), so ``from_jax`` reads it
    back and a test compares it leaf by leaf with JAX params."""
    joint = params.cfg.mode == "joint"

    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().copy()

    def dec_arr(t: torch.Tensor) -> np.ndarray:     # joint: drop the stack
        return arr(t[0] if joint else t)

    d = params.decoder
    cell = tuple(SimpleNamespace(wx=dec_arr(c.wx), wh=dec_arr(c.wh),
                                 b=dec_arr(c.b)) for c in d.cell)
    decoder = SimpleNamespace(cell=cell, **{
        f.name: dec_arr(getattr(d, f.name)) for f in dataclasses.fields(d)
        if f.name not in ("cell", "cfg")})
    encoder = tuple(SimpleNamespace(w=arr(e.w), bv=arr(e.bv), bh=arr(e.bh))
                    for e in params.encoder)
    return SimpleNamespace(cfg=params.cfg, encoder=encoder, decoder=decoder)
