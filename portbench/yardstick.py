"""The benchmark's frozen arithmetic: the H100's published peaks, the
model FLOP counts of a training step and of a generated frame, and the
operations and bytes of the kernels whose roofline share the benchmark
reports.

A copy, kept with the benchmark so that no change to the program moves
the yardstick: the closed forms equal those of
``multinn_torch/utils/flops.py`` at the time the benchmark was written
(``train_step_flops``, ``gen_step_flops_*["model"]``, ``gibbs_work``,
``fused_work``), rewritten to take plain sizes instead of the program's
config and parameter objects. Convention: one multiply-accumulate is two
FLOPs, an add or a sigmoid one.

Roofline: the least time the card could take for a call, the larger of
its bytes at the memory rate and its operations at the f32 rate outside
the tensor cores (every matrix product of these cells runs in f32 with
TF32 off). Each input byte is counted once, each output byte once, and
only the products these inputs need: a lower bound of the time, so a
share of it never passes 100 % unless the time leaves out work.
"""

from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at its 700 W
# power limit
F32_FLOPS = 67e12          # f32 outside the tensor cores
TF32_FLOPS = 494.7e12
BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12
# about 80 32-bit integer operations per Threefry-2x32 counter (20 rounds
# of add / rotate / xor, 5 key injections)
THREEFRY_OPS = 80


class Dims(NamedTuple):
    """A feedback MultINN with pass-through encoders, as the cells run it:
    K tracks of D pitches, H hidden units, an LSTM of U units in L layers,
    the feedback context K*D wide."""
    k: int
    d: int
    h: int
    u: int
    layers: int = 1

    @property
    def ctx(self) -> int:
        return self.k * self.d

    @property
    def g(self) -> int:            # LSTM gate width
        return 4 * self.u


def dims_of(model: dict) -> Dims:
    """Dims of a configuration file's ``model`` block."""
    if model.get("mode") != "feedback" or model.get("encoder_hidden"):
        raise ValueError("the yardstick counts feedback models with "
                         "pass-through encoders")
    if model.get("cell", "lstm") != "lstm":
        raise ValueError("the yardstick counts LSTM cells")
    return Dims(model["n_tracks"], model["n_pitches"], model["n_hidden"],
                model["n_rnn"], model.get("rnn_layers", 1))


def lstm_frame_flops(xin: int, u: int, layers: int = 1) -> int:
    """One LSTM step for one row: z = x @ Wx + h @ Wh (4U gates) and about
    12U elementwise operations a layer."""
    total = 0
    for layer in range(layers):
        inp = xin if layer == 0 else u
        total += 2 * (inp + u) * 4 * u + 12 * u
    return total


def train_step_flops(n: Dims, decoder: str, batch: int, t: int,
                     cd_k: int = 1) -> int:
    """Model FLOPs of one optimizer step (forward and backward) over all K
    tracks: the backward costs twice the differentiable forward; the CD
    chain runs without gradient, so it counts forward only."""
    lstm = lstm_frame_flops(n.d + n.ctx, n.u, n.layers)
    biases = 2 * n.u * (n.d + n.h)
    if decoder == "rnn-rbm":
        per = 3 * (lstm + biases + 2 * (2 * n.d * n.h)) + 4 * n.d * n.h * cd_k
    elif decoder == "rnn-nade":
        per = 3 * (lstm + biases + 6 * n.d * n.h)
    else:
        raise ValueError(f"unknown decoder {decoder!r}")
    return batch * t * n.k * per


def gen_frame_flops(n: Dims, decoder: str, gen_k: int = 10) -> int:
    """Model FLOPs of one generated frame of one song, all K tracks: the
    conditioned biases, the LSTM step and the frame model (gen_k Gibbs
    sweeps of two passes over (D, H); the NADE's 6DH grid plus its
    own-frame input product once more, as the reference counts it)."""
    lstm = lstm_frame_flops(n.d + n.ctx, n.u, n.layers)
    if decoder == "rnn-rbm":
        return n.k * (4 * n.d * n.h * gen_k + 2 * n.u * (n.d + n.h) + lstm)
    if decoder == "rnn-nade":
        return n.k * (6 * n.d * n.h + 2 * n.d * n.g + lstm)
    raise ValueError(f"unknown decoder {decoder!r}")


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the card could take: bytes at the memory rate or
    operations at the f32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


def gibbs_cd1_work(rows: int, nnz_v0: float, d: int, h: int):
    """(bytes, operations) of one CD-1 chain launch over ``rows`` rows: v0,
    bv and the output (rows, d), bh (rows, h) and W once each; the hidden
    pass's products over v0's ``nnz_v0`` nonzero entries and d + h
    Threefry draws a row. The visible pass, whose products run over hidden
    samples no trace shows, is left out."""
    return (4 * (3 * rows * d + d * h + rows * h),
            2 * h * nnz_v0 + THREEFRY_OPS * rows * (d + h))


def weight_count(n: Dims, decoder: str) -> int:
    """Elements of the track-stacked decoder: the LSTM (Wx over the frame
    and the context, Wh, b), the frame model's W (and the NADE's V), bv,
    bh, Wuv and Wuh."""
    lstm = (n.d + n.ctx) * n.g + n.u * n.g + n.g
    frame = n.d * n.h * (2 if decoder == "rnn-nade" else 1) + n.d + n.h
    return n.k * (lstm + frame + n.u * (n.d + n.h))


def fused_work(n: Dims, decoder: str, batch: int, steps: int, nnz: float,
               gen_k: int = 10):
    """(bytes, operations) of one whole-generation launch over ``batch``
    songs of ``steps`` frames whose roll holds ``nnz`` notes.

    Bytes: every decoder weight once, at the bytes the kernel stores it
    in (the RNN-NADE kernel keeps W, V, Wuv, the own-frame Wx and the
    context's Wx in bf16; everything else f32, the storage both cells'
    batches take), the state in and out, the roll written once.
    Operations: the dense products a frame needs (conditioned biases,
    the recurrence), plus the products over the notes the roll holds
    (the RBM's hidden pass in each of its gen_k sweeps; the own-frame
    projection; the feedback context over the previous frame; the
    NADE's per-dim sums and its W updates)."""
    rows = batch * steps * n.k
    dense = rows * ((n.d + n.h) * n.u + n.g * n.u * (2 * n.layers - 1))
    # the context reads the previous frame: every frame but the last
    ctx = n.k * n.g * nnz * (steps - 1) / steps
    numel = weight_count(n, decoder)
    if decoder == "rnn-rbm":
        ops = 2 * (dense + gen_k * n.h * nnz + n.g * nnz + ctx)
        half = 0
    else:
        ops = 2 * (dense + rows * n.d * n.h + ctx) + n.h * nnz + n.g * nnz
        half = n.k * (2 * n.d * n.h + n.u * n.d + (n.d + n.ctx) * n.g)
    wbytes = 2 * half + 4 * (numel - half)
    state = 4 * (4 * batch * n.layers * n.k * n.u + batch * n.k * n.d)
    return wbytes + state + 4 * batch * steps * n.k * n.d, ops
