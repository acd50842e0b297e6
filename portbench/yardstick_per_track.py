"""The benchmark's frozen count of the model FLOPs of a generated frame of
a per-track MultINN whose RNN-RBM decoders sample a one-layer DBN's
latents, kept with the benchmark so that no change to the program moves
it. It equals ``multinn_torch/utils/flops.py``'s
``gen_step_flops_rbm(cfg, 1)["model"]`` at the time it was written, plus
the decode that count leaves out. Convention as ``yardstick.py``'s: one
multiply-accumulate is two FLOPs, an add or a sigmoid one; the peak is
its f32 rate outside the tensor cores.
"""

from __future__ import annotations

from typing import NamedTuple

from portbench.yardstick import F32_FLOPS, lstm_frame_flops

__all__ = ["F32_FLOPS", "Dims", "dims_of", "gen_frame_flops"]


class Dims(NamedTuple):
    """K tracks of D pitches, each with its encoder to F latents, an RBM of
    H hidden units over them and an LSTM of U units in L layers reading
    the track's own latent frame."""
    k: int
    d: int
    f: int
    h: int
    u: int
    layers: int = 1


def dims_of(model: dict) -> Dims:
    """Dims of a configuration file's ``model`` block."""
    if (model.get("mode") != "per-track"
            or len(model.get("encoder_hidden", ())) != 1
            or model.get("decoder_type") != "rnn-rbm"
            or model.get("cell", "lstm") != "lstm"):
        raise ValueError("this count is of per-track RNN-RBM models with "
                         "one DBN layer per track and LSTM cells")
    return Dims(model["n_tracks"], model["n_pitches"],
                model["encoder_hidden"][0], model["n_hidden"],
                model["n_rnn"], model.get("rnn_layers", 1))


def gen_frame_flops(n: Dims, gen_k: int) -> int:
    """Model FLOPs of one generated frame of one song, all K tracks: per
    track the LSTM step on its F latents, the conditioned biases, gen_k
    Gibbs sweeps of two passes over (F, H), and the decode of the F
    latents to D pitches."""
    per = (lstm_frame_flops(n.f, n.u, n.layers) + 2 * n.u * (n.f + n.h)
           + 4 * n.f * n.h * gen_k + 2 * n.f * n.d)
    return n.k * per
