"""The weights of a per-track MultINN with a one-layer DBN encoder per
track, made from ``--seed`` on the card in one call, as ``weights.py``
makes the feedback cells'.

The init distribution (normal(0, w_std) matrices, zero biases, the LSTM's
forget-gate bias 1) for the decoders over the F latents and for each
track's encoder (D pitches -> F latents); the configuration's
``bv_shift`` lowers every pianoroll-side visible bias of the encoders, so
that decoded songs hold about as many notes as music, and leaves the
decoders' latent biases as drawn. One flat float32 tensor, each leaf a
view of it: the program gets them in its own parameter tree
(``port_params``), the reference (``reference/per_track_dbn.py``) by
name.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import weights

_MATRICES = ("wx", "wh", "w", "wuv", "wuh", "enc_w")


def shapes(model_cfg) -> dict:
    """The track-stacked leaves by name: each decoder's LSTM layer over
    its own latent frame, its RBM, biases and conditioning, then each
    track's encoder."""
    if (model_cfg.rnn_layers != 1 or model_cfg.cell != "lstm"
            or model_cfg.mode != "per-track"
            or len(model_cfg.encoder_hidden) != 1
            or model_cfg.decoder_type != "rnn-rbm"):
        raise ValueError("this drawer makes per-track RNN-RBM models with "
                         "one DBN layer per track and one LSTM layer")
    k, d = model_cfg.n_tracks, model_cfg.n_pitches
    f = model_cfg.encoder_hidden[0]
    h, u = model_cfg.n_hidden, model_cfg.n_rnn
    return {"wx": (k, f, 4 * u), "wh": (k, u, 4 * u), "b": (k, 4 * u),
            "w": (k, f, h), "bv": (k, f), "bh": (k, h), "wuv": (k, u, f),
            "wuh": (k, u, h), "enc_w": (k, d, f), "enc_bv": (k, d),
            "enc_bh": (k, f)}


def draw(model_cfg, seed: int, bv_shift: float, device) -> dict:
    """The leaves by name (``shapes``), as views of one flat tensor drawn
    on ``device`` from ``seed``."""
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
            elif name == "enc_bv":
                x -= bv_shift
        out[name] = x
    return out


def port_params(model_cfg, wts: dict):
    """The program's MultINNParams over the same tensors."""
    from multinn_torch.nn import rbm
    dec = {n: x for n, x in wts.items() if not n.startswith("enc_")}
    params = weights.port_params(model_cfg, dec)
    params.encoder = (rbm.RBMParams(w=wts["enc_w"], bv=wts["enc_bv"],
                                    bh=wts["enc_bh"]),)
    return params
