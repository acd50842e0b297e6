"""The cells' inputs made from ``--seed``: the sub-seeds of a run and the
model's weights, drawn on the card in one call.

The weights follow the model's init distribution (normal(0, w_std)
matrices, zero biases, the LSTM's forget-gate bias 1) and the
configuration's ``bv_shift``, which lowers every visible bias so that
seeded weights sample about as many notes as music holds. They are one
flat float32 tensor, and each leaf a view of it: the program gets them
in its own parameter tree (``port_params``), the reference by name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_MATRICES = ("wx", "wh", "w", "v", "wuv", "wuh")


class Seeds:
    """Independent sub-seeds of one ``--seed`` (any integer)."""

    def __init__(self, seed: int):
        words = [int(w) for w in np.random.SeedSequence(
            int(seed) % 2 ** 64).generate_state(8, dtype=np.uint32)]
        self.weights = int(words[0] << 32 | words[1])
        self.program = int(words[2] & 0x7FFFFFFF)   # the program's int32 seed
        self.data = int(words[3] << 32 | words[4])
        self.sample = int(words[5] << 32 | words[6])


def shapes(model_cfg) -> dict:
    """The track-stacked decoder's leaves by name: one LSTM layer over the
    own frame and the feedback context, the frame model, its biases and
    the conditioning; the RNN-NADE adds V."""
    if (model_cfg.rnn_layers != 1 or model_cfg.cell != "lstm"
            or model_cfg.mode != "feedback" or model_cfg.encoder_hidden):
        raise ValueError("the benchmark's configurations are feedback "
                         "models with pass-through encoders and one LSTM "
                         "layer")
    k, d = model_cfg.n_tracks, model_cfg.n_pitches
    h, u = model_cfg.n_hidden, model_cfg.n_rnn
    out = {"wx": (k, d + k * d, 4 * u), "wh": (k, u, 4 * u), "b": (k, 4 * u),
           "w": (k, d, h)}
    if model_cfg.decoder_type == "rnn-nade":
        out["v"] = (k, d, h)
    out.update(bv=(k, d), bh=(k, h), wuv=(k, u, d), wuh=(k, u, h))
    return out


def draw(model_cfg, seed: int, bv_shift: float, device) -> dict:
    """The decoder's weights by name (``shapes``), as views of one flat
    tensor drawn on ``device`` from ``seed``."""
    leaves = shapes(model_cfg)
    sizes = [int(np.prod(s)) for s in leaves.values()]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(leaves.items(), flat.split(sizes)):
        x = part.view(shape)
        if name in _MATRICES:
            x.mul_(model_cfg.w_std)
        else:
            x.zero_()
            if name == "b":                      # gates i, f, g, o
                u = model_cfg.n_rnn
                x[..., u:2 * u] = 1.0
            elif name == "bv":
                x -= bv_shift
        out[name] = x
    return out


def port_params(model_cfg, wts: dict):
    """The program's MultINNParams over the same tensors."""
    from multinn_torch.models import multinn
    from multinn_torch.models.base import get_decoder
    from multinn_torch.nn import rnn
    dec = get_decoder(model_cfg.decoder_type)
    names = [f.name for f in dataclasses.fields(dec.Params)
             if f.name not in ("cell", "cfg")]
    decoder = dec.Params(
        cell=(rnn.LSTMParams(wx=wts["wx"], wh=wts["wh"], b=wts["b"]),),
        cfg=model_cfg.decoder_config(), **{n: wts[n] for n in names})
    return multinn.MultINNParams(encoder=(), decoder=decoder, cfg=model_cfg)


def leaf_names(decoder) -> list:
    """The names of the program's decoder leaves, in its ``tree_leaves``
    order (the LSTM layer's first, then the dataclass's fields)."""
    names = []
    for f in dataclasses.fields(decoder):
        if f.name == "cell":
            names += [g.name for g in dataclasses.fields(decoder.cell[0])]
        elif f.name != "cfg":
            names.append(f.name)
    return names
