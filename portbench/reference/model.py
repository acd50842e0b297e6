"""The plain reference of the feedback MultINN with pass-through encoders:
its LSTM, the RNN-RBM and RNN-NADE frame models, the CD-1 loss and Adam,
written from the model's equations in plain PyTorch, float32 with TF32
off.

Weights are a dict of track-stacked tensors (leading axis K) as the
benchmark draws them: ``wx`` (K, D + K*D, 4U) over the own frame and the
feedback context (every track's previous frame, track-major), ``wh`` (K,
U, 4U), ``b`` (K, 4U) (gates i, f, g, o), ``w`` (K, D, H) (and the NADE's
``v``), ``bv`` (K, D), ``bh`` (K, H), ``wuv`` (K, U, D), ``wuh`` (K, U,
H). Rolls are (N, T, K, D) in {0, 1}.

    u(t)  = LSTM(u(t-1), [v(t); v_all(t-1)])      u(-1) = 0, v(-1) = 0
    bv(t) = bv + u(t-1) Wuv,  bh(t) = bh + u(t-1) Wuh
    RBM:  p(h | v) = sigmoid(v W + bh(t)),  p(v | h) = sigmoid(h W^T + bv(t))
    NADE: p(v_i | v_<i) = sigmoid(bv_i(t) + V_i . sigmoid(bh(t) + sum_{j<i} v_j W_j))

Random draws follow the streams the configuration states (threefry.py):
generation at (seed, salt, counter) as stated in ``rbm_replay`` and
``nade_replay``, the CD chain as stated in ``cd1_chain``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import threefry

# rows of one block of the CD chain's stream: the JAX package's Gibbs
# kernel tiles rows by its per-step VMEM budget (8 MiB), in multiples of 8
# and at most 1024, and each block keys its stream apart
_TILE_BYTES = (10 * 1024 * 1024 * 4) // 5


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def lstm_inputs(roll: torch.Tensor) -> torch.Tensor:
    """(N, T, K, D) -> the LSTM's inputs (T, K, N, D + K*D): each track's
    own frame and every track's previous frame (zeros before the first)."""
    n, t, k, d = roll.shape
    own = roll.permute(1, 2, 0, 3)
    prev = torch.cat([torch.zeros_like(roll[:, :1]), roll[:, :-1]], dim=1)
    ctx = prev.reshape(n, t, k * d).transpose(0, 1)          # (T, N, K*D)
    return torch.cat([own, ctx[:, None].expand(t, k, n, k * d)], dim=-1)


def lstm_states(wts: dict, x_in: torch.Tensor) -> torch.Tensor:
    """u(t-1) for every step t: (T, K, N, U), from a zero state."""
    t, k, n, _ = x_in.shape
    u = wts["wh"].shape[1]
    xz = torch.matmul(x_in, wts["wx"]) + wts["b"][:, None, :]
    h = x_in.new_zeros(k, n, u)
    c = torch.zeros_like(h)
    out = []
    for step in range(t):
        out.append(h)
        z = xz[step] + torch.matmul(h, wts["wh"])
        i, f, g, o = z.split(u, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return torch.stack(out)


def conditioned_biases(wts: dict, u_prev: torch.Tensor):
    return (wts["bv"][:, None, :] + torch.matmul(u_prev, wts["wuv"]),
            wts["bh"][:, None, :] + torch.matmul(u_prev, wts["wuh"]))


def _song_streams(keys, device):
    """Per song the two words of its kernel key, as (N,) int64 tensors."""
    s0 = torch.tensor([k[0] for k in keys], dtype=torch.int64, device=device)
    s1 = torch.tensor([k[1] for k in keys], dtype=torch.int64, device=device)
    return s0, s1


def _judge(served: torch.Tensor, p: torch.Tensor, u: torch.Tensor):
    """Per song: bits where the served value is not ``u < p``, and the
    widest |u - p| among them."""
    want = (u < p).to(served.dtype)
    bad = want != served
    margin = torch.where(bad, (u - p).abs(), torch.zeros_like(p))
    return bad, margin


def rbm_replay(wts: dict, rolls: torch.Tensor, keys, rows, batch: int,
               gen_k: int, t_chunk: int = 64) -> dict:
    """Replay the served RBM rolls step by step, teacher forced: at step t
    the state comes from the served frames before t and the chain starts
    at the served frame t-1; gen_k sweeps draw h of sweep s at salt
    ``key[1] + t*2*gen_k + 2s`` (v: + 1) and counter ``(row*K + k)*H +
    j`` (v: ``(row*K + k)*D + i``), under seed ``key[0]``. ``keys``: each
    song's kernel key (two ints), ``rows``: its row in a batch of
    ``batch`` songs. Returns per song the frames whose replayed sample
    differs from the served one and the widest margin by which a served
    bit contradicts its final draw."""
    n, t, k, d = rolls.shape
    hid = wts["w"].shape[-1]
    dev = rolls.device
    u_prev = lstm_states(wts, lstm_inputs(rolls))
    bv_t, bh_t = conditioned_biases(wts, u_prev)
    s0, s1 = _song_streams(keys, dev)
    row = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    kk = torch.arange(k, device=dev)
    ctr_h = ((row[None, :, None] * k + kk[:, None, None]) * hid
             + torch.arange(hid, device=dev))                  # (K, N, H)
    ctr_v = ((row[None, :, None] * k + kk[:, None, None]) * d
             + torch.arange(d, device=dev))
    served = rolls.permute(1, 2, 0, 3)                         # (T, K, N, D)
    prev = torch.cat([torch.zeros_like(served[:1]), served[:-1]])
    wt = wts["w"].transpose(1, 2)
    frames = torch.zeros(n, dtype=torch.int64, device=dev)
    worst = torch.zeros(n, device=dev)
    for t0 in range(0, t, t_chunk):
        ts = torch.arange(t0, min(t0 + t_chunk, t), device=dev)
        seed = s0[None, None, :, None]
        salt0 = s1[None, None, :, None] + ts[:, None, None, None] * 2 * gen_k
        v = prev[ts]
        for s in range(gen_k):
            ph = torch.sigmoid(torch.matmul(v, wts["w"]) + bh_t[ts])
            uh = threefry.uniform(seed, (salt0 + 2 * s) & threefry.MASK,
                                  ctr_h)
            hs = (uh < ph).to(v.dtype)
            pv = torch.sigmoid(torch.matmul(hs, wt) + bv_t[ts])
            uv = threefry.uniform(seed, (salt0 + 2 * s + 1) & threefry.MASK,
                                  ctr_v)
            v = (uv < pv).to(v.dtype)
        bad, margin = _judge(served[ts], pv, uv)
        frames += bad.any(dim=-1).sum(dim=(0, 1))
        worst = torch.maximum(worst, margin.amax(dim=(0, 1, 3)))
    return {"frames": frames.cpu(), "margin": worst.cpu(),
            "cells": t * k}


def nade_replay(wts: dict, rolls: torch.Tensor, keys, rows, batch: int,
                t_chunk: int = 16) -> dict:
    """Replay the served NADE rolls dim by dim, teacher forced: every
    conditional comes from the served frames and the served dims before
    it; the draw of (step t, track k, dim i) for the song in row ``row``
    of a batch of ``batch`` is at counter ``(i*8 + k)*batch + row``, salt
    ``key[1] + t``, seed ``key[0]``. The kernel stores W, V, Wuv and Wx in
    bf16, so the reference rounds them so too. Returns what
    ``rbm_replay`` returns."""
    n, t, k, d = rolls.shape
    dev = rolls.device
    w = {**wts, **{name: round_bf16(wts[name])
                   for name in ("w", "v", "wuv", "wx")}}
    u_prev = lstm_states(w, lstm_inputs(rolls))
    bv_t, bh_t = conditioned_biases(w, u_prev)
    s0, s1 = _song_streams(keys, dev)
    row = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    ctr = ((torch.arange(d, device=dev) * 8
            + torch.arange(k, device=dev)[:, None, None]) * batch
           + row[:, None])                                      # (K, N, D)
    served = rolls.permute(1, 2, 0, 3)
    frames = torch.zeros(n, dtype=torch.int64, device=dev)
    worst = torch.zeros(n, device=dev)
    for t0 in range(0, t, t_chunk):
        ts = torch.arange(t0, min(t0 + t_chunk, t), device=dev)
        x = served[ts]                                          # (c, K, N, D)
        contrib = x[..., :, None] * w["w"][None, :, None]      # (c,K,N,D,H)
        csum = torch.cumsum(contrib, dim=-2)
        a = (bh_t[ts][..., None, :]
             + torch.cat([torch.zeros_like(csum[..., :1, :]),
                          csum[..., :-1, :]], dim=-2))
        logits = bv_t[ts] + (torch.sigmoid(a) * w["v"][None, :, None]).sum(-1)
        u = threefry.uniform(s0[None, None, :, None],
                             (s1[None, None, :, None]
                              + ts[:, None, None, None]) & threefry.MASK, ctr)
        bad, margin = _judge(x, torch.sigmoid(logits), u)
        frames += bad.any(dim=-1).sum(dim=(0, 1))
        worst = torch.maximum(worst, margin.amax(dim=(0, 1, 3)))
    return {"frames": frames.cpu(), "margin": worst.cpu(),
            "cells": t * k}


# -- training ------------------------------------------------------------------

def block_rows(n: int, d: int, h: int) -> int:
    """Rows per block of the CD chain's stream."""
    per_row = 4 * (2 * d + 2 * h + d + h)
    bb = max(8, min(n, _TILE_BYTES // per_row))
    return max(8, min(bb // 8 * 8, 1024))


def cd1_chain(key, v0: torch.Tensor, w, bv, bh) -> torch.Tensor:
    """One block-Gibbs sweep from the rows v0 (n, D) with row biases: rows
    are tiled into blocks of ``block_rows``, block q draws under seed
    ``key[0] ^ q*0x85EB`` and the draw at (row r of its block, column c)
    has counter r*width + c, salt ``key[1]`` (h) or ``key[1] + 1`` (v)."""
    n, d = v0.shape
    h = w.shape[-1]
    dev = v0.device
    r = torch.arange(n, dtype=torch.int64, device=dev)
    bb = block_rows(n, d, h)
    seed = (key[0] ^ (((r // bb) * 0x85EB) & threefry.MASK))[:, None]
    lrow = (r % bb)[:, None]
    uh = threefry.uniform(seed, key[1], lrow * h + torch.arange(h, device=dev))
    hs = (uh < torch.sigmoid(v0 @ w + bh)).to(v0.dtype)
    uv = threefry.uniform(seed, (key[1] + 1) & threefry.MASK,
                          lrow * d + torch.arange(d, device=dev))
    return (uv < torch.sigmoid(hs @ w.t() + bv)).to(v0.dtype)


def free_energy(v, w, bv, bh):
    return -(v * bv).sum(-1) - F.softplus(torch.matmul(v, w) + bh).sum(-1)


def rbm_cd1_loss(wts: dict, x: torch.Tensor, step_key) -> torch.Tensor:
    """The CD-1 loss of a batch x (B, T, K, D): per track the mean over
    frames of F(v0) - F(v1), v1 a constant drawn by ``cd1_chain`` under
    key 0 of ``split(split(step_key, K)[k], 3)``; the mean over tracks."""
    b, t, k, d = x.shape
    u_prev = lstm_states(wts, lstm_inputs(x))
    bv_t, bh_t = conditioned_biases(wts, u_prev)
    x_tm = x.permute(1, 2, 0, 3)
    losses = []
    for kk in range(k):
        key = threefry.split(threefry.split(step_key, kk), 0)
        w, bv, bh = wts["w"][kk], bv_t[:, kk], bh_t[:, kk]
        v0 = x_tm[:, kk]
        with torch.no_grad():
            v1 = cd1_chain(key, v0.reshape(-1, d), w.detach(),
                           bv.detach().reshape(-1, d),
                           bh.detach().reshape(t * b, -1)).reshape(v0.shape)
        losses.append((free_energy(v0, w, bv, bh)
                       - free_energy(v1, w, bv, bh)).mean())
    return torch.stack(losses).mean()


class Adam:
    """Adam behind a clip of the gradients' global norm (optax's
    ``chain(clip_by_global_norm(clip), adam(lr))``), constant rate."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: dict, lr: float, clip: float):
        self.lr, self.clip, self.count = lr, clip, 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> float:
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = 1.0 if norm < self.clip else self.clip / norm
        self.count += 1
        for n, g in grads.items():
            g = g * scale
            self.mu[n].mul_(self.B1).add_(g, alpha=1 - self.B1)
            self.nu[n].mul_(self.B2).addcmul_(g, g, value=1 - self.B2)
            mhat = self.mu[n] / (1 - self.B1 ** self.count)
            vhat = self.nu[n] / (1 - self.B2 ** self.count)
            params[n].sub_(self.lr * mhat / (vhat.sqrt() + self.EPS))
        return float(norm)


def rbm_train(wts: dict, batches, step_keys, lr: float, clip: float):
    """Adam steps of the CD-1 loss from ``wts`` over ``batches`` (each (B,
    T, K, D)) under ``step_keys``. Returns (the weights after, the Adam
    state, each step's loss, each step's gradient norm before the
    clip)."""
    params = {n: p.detach().clone() for n, p in wts.items()}
    opt = Adam(params, lr, clip)
    losses, norms = [], []
    for x, key in zip(batches, step_keys):
        live = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        loss = rbm_cd1_loss(live, x, key)
        grads = torch.autograd.grad(loss, list(live.values()))
        norms.append(opt.step(params, dict(zip(live, grads))))
        losses.append(float(loss.detach()))
    return params, opt, losses, norms
