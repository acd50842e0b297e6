"""The plain reference of MultINN's per-track architecture ("Jamming")
with a DBN encoder per track and RNN-RBM decoders over its latents,
written from the model's equations in plain PyTorch, float32 with TF32
off (call ``model.no_tf32()`` first).

Weights are a dict of track-stacked tensors (leading axis K) as
``portbench/weights_dbn.py`` draws them. The decoder's: ``wx`` (K, F, 4U)
over the track's own latent frame, ``wh`` (K, U, 4U), ``b`` (K, 4U)
(gates i, f, g, o), ``w`` (K, F, H), ``bv`` (K, F), ``bh`` (K, H), ``wuv``
(K, U, F), ``wuh`` (K, U, H); each track's one-layer DBN encoder:
``enc_w`` (K, D, F), ``enc_bv`` (K, D), ``enc_bh`` (K, F). Latent rolls
are (N, T, K, F), pianorolls (N, T, K, D), both in {0, 1}.

    u_k(t)  = LSTM_k(u_k(t-1), z_k(t))            u(-1) = 0, z(-1) = 0
    bv(t)   = bv + u(t-1) Wuv,  bh(t) = bh + u(t-1) Wuh
    RBM over the latents: p(h | z) = sigmoid(z W + bh(t)),
                          p(z | h) = sigmoid(h W^T + bv(t))
    decode:  p(v | z) = sigmoid(z enc_W^T + enc_bv)

Unlike the feedback model (``model.py``) no track reads another's frame:
each LSTM reads only its own previous latent frame. Departures from the
published model: generation draws on the streams the configuration
states (below), where the published code draws from TensorFlow's; the
encoder's upward pass is not run, since generation only decodes.

Streams: the latent chain as ``model.rbm_replay`` states it, with F
latents in place of D pitches (salt ``key[1] + t*2*gen_k + 2s`` (+1 for
z), counter ``(row*K + k)*H + j`` (z: ``(row*K + k)*F + i``), seed
``key[0]``); the decode under key ``split(fold_in(key, 0x5eed), K)[k]``,
``jax.random``'s layout over the batch's (B, T, D) draws of track k: the
draw of (row, t, i) is the Threefry block of counter (0, (row*T + t)*D +
i) under that key, its two words XORed, as a uniform.
"""

from __future__ import annotations

import torch

from portbench.reference import threefry
from portbench.reference.model import (_judge, _song_streams,
                                       conditioned_biases, lstm_states)

DECODE_SALT = 0x5EED


def latent_replay(wts: dict, lat: torch.Tensor, keys, rows, gen_k: int,
                  t_chunk: int = 64) -> dict:
    """Replay served latent rolls step by step, teacher forced: at step t
    each track's LSTM state comes from its served latent frames before t,
    and the chain starts at the served frame t-1; gen_k sweeps on the
    streams of the module docstring. ``keys``: each song's key (two
    ints), ``rows``: its row in its batch. Returns per song the frames
    whose replayed sample differs from the served one and the widest
    margin by which a served bit contradicts its final draw, and the
    frames a song has (``cells``)."""
    n, t, k, f = lat.shape
    hid = wts["w"].shape[-1]
    dev = lat.device
    served = lat.permute(1, 2, 0, 3)                           # (T, K, N, F)
    u_prev = lstm_states(wts, served)
    bv_t, bh_t = conditioned_biases(wts, u_prev)
    s0, s1 = _song_streams(keys, dev)
    row = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    lane = (row[None, :, None] * k + torch.arange(k, device=dev)[:, None,
                                                                 None])
    ctr_h = lane * hid + torch.arange(hid, device=dev)         # (K, N, H)
    ctr_z = lane * f + torch.arange(f, device=dev)             # (K, N, F)
    prev = torch.cat([torch.zeros_like(served[:1]), served[:-1]])
    wt = wts["w"].transpose(1, 2)
    frames = torch.zeros(n, dtype=torch.int64, device=dev)
    worst = torch.zeros(n, device=dev)
    for t0 in range(0, t, t_chunk):
        ts = torch.arange(t0, min(t0 + t_chunk, t), device=dev)
        seed = s0[None, None, :, None]
        salt0 = s1[None, None, :, None] + ts[:, None, None, None] * 2 * gen_k
        z = prev[ts]
        for s in range(gen_k):
            ph = torch.sigmoid(torch.matmul(z, wts["w"]) + bh_t[ts])
            uh = threefry.uniform(seed, (salt0 + 2 * s) & threefry.MASK,
                                  ctr_h)
            h = (uh < ph).to(z.dtype)
            pz = torch.sigmoid(torch.matmul(h, wt) + bv_t[ts])
            uz = threefry.uniform(seed, (salt0 + 2 * s + 1) & threefry.MASK,
                                  ctr_z)
            z = (uz < pz).to(z.dtype)
        bad, margin = _judge(served[ts], pz, uz)
        frames += bad.any(dim=-1).sum(dim=(0, 1))
        worst = torch.maximum(worst, margin.amax(dim=(0, 1, 3)))
    return {"frames": frames.cpu(), "margin": worst.cpu(), "cells": t * k}


def decode_keys(key, k: int) -> list:
    """The decode's key of each track under a batch's ``key``."""
    kd = threefry.fold_in(key, DECODE_SALT)
    return [threefry.split(kd, i) for i in range(k)]


def decode_replay(wts: dict, lat: torch.Tensor, roll: torch.Tensor, keys,
                  rows, t_chunk: int = 64) -> dict:
    """Check served pianorolls (N, T, K, D) against the decode of their
    served latents (N, T, K, F): each cell against ``u < p(v | z)`` on the
    decode's stream (module docstring), in blocks of ``t_chunk`` steps.
    Returns per song the cells that differ and the widest margin by which
    a served cell contradicts its draw, and the cells a song has."""
    n, t, k, d = roll.shape
    dev = roll.device
    kd = [decode_keys(key, k) for key in keys]                 # [N][K]
    k0 = torch.tensor([[w[0] for w in song] for song in kd],
                      dtype=torch.int64, device=dev).t()       # (K, N)
    k1 = torch.tensor([[w[1] for w in song] for song in kd],
                      dtype=torch.int64, device=dev).t()
    row = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    wt = wts["enc_w"].transpose(1, 2)                          # (K, F, D)
    cells = torch.zeros(n, dtype=torch.int64, device=dev)
    worst = torch.zeros(n, device=dev)
    for t0 in range(0, t, t_chunk):
        ts = torch.arange(t0, min(t0 + t_chunk, t), device=dev)
        z = lat[:, ts].permute(1, 2, 0, 3)                     # (c, K, N, F)
        p = torch.sigmoid(torch.matmul(z, wt) + wts["enc_bv"][:, None, :])
        idx = ((row[None, None, :, None] * t + ts[:, None, None, None]) * d
               + torch.arange(d, device=dev))                  # (c, 1, N, D)
        y0, y1 = threefry.block(k0[None, :, :, None], k1[None, :, :, None],
                                0, idx)
        u = (((y0 ^ y1) >> 9) | 0x3F800000).to(torch.int32).view(
            torch.float32) - 1.0
        bad, margin = _judge(roll[:, ts].permute(1, 2, 0, 3), p, u)
        cells += bad.sum(dim=(0, 1, 3))
        worst = torch.maximum(worst, margin.amax(dim=(0, 1, 3)))
    return {"cells": cells.cpu(), "margin": worst.cpu(),
            "cells_per_song": t * k * d}
