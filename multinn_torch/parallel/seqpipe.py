"""Sequence (time-axis) parallelism for teacher-forced training — port of
multinn_tpu/parallel/seqpipe.py.

The training window T is chunked over the mesh axis ``seq``: rank s holds
frames [s*T/S, (s+1)*T/S). Everything per frame stays local; the one
sequential object, the RNN carry, crosses chunk boundaries by
``comm.ppermute`` (s -> s+1) in a GPipe schedule of S + M - 1 stages over
M microbatches of the local batch: at stage j, rank s scans microbatch
j - s through its chunk and hands the final state to rank s + 1.

The backward reverses the pipeline through autograd (the ppermute's
backward shifts the cotangents s + 1 -> s). A collective's backward runs
only where its output reaches the loss, and every rank must run it, so
every rank scans every stage, its idle stages on a clipped microbatch
whose hidden states enter the result multiplied by zero, as the
reference's SPMD program does: the autograd graph is the same on every
rank. Rank 0 receives zeros from the ppermute, which is the zero state the
recurrence starts from, so it needs no select.

The feedback architecture's cross-track context is a one-frame time shift
of the per-frame latents: its chunk-boundary halo is one frame, exchanged
once per step (``shift_right_seq``).
"""

from __future__ import annotations

import dataclasses

import torch

from multinn_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class SeqSpec:
    """Static description of the time-sharded execution context.

    axis: mesh axis name the time chunks live on.
    n_seq: number of chunks S (mesh axis size).
    microbatches: pipeline depth M; must divide the rank-local batch.
    group / index: the axis's process group and this rank's chunk.
    """

    axis: str
    n_seq: int
    microbatches: int
    group: object = None
    index: int = 0


def auto_microbatches(b_local: int, n_seq: int, requested: int = 0) -> int:
    """Pick the pipeline depth M: the largest divisor of the rank-local
    batch <= the target, 2*S by default (efficiency S*M/(S+M-1) >= 2/3 of
    ideal while the microbatches stay fat). ``requested``
    (mesh.seq_microbatches) is a CAP, not an exact value, so short padded
    evaluation batches still get a valid depth."""
    target = requested if requested else max(1, min(b_local, 2 * n_seq))
    for m in range(min(target, b_local), 0, -1):
        if b_local % m == 0:
            return m
    return 1


def shift_right_seq(lat: torch.Tensor, spec: SeqSpec) -> torch.Tensor:
    """ctx(t) = lat(t-1) across chunk boundaries. lat: (B, T_local, C)
    batch-major local chunk; rank s receives the last frame of rank s-1's
    chunk (zeros into rank 0, the t=0 convention of the feedback
    context)."""
    incoming = comm.ppermute(lat[:, -1].contiguous(), spec.group)
    return torch.cat([incoming[:, None], lat[:, :-1]], dim=1)


def scan_states_pipelined(params, x_tm: torch.Tensor, spec: SeqSpec):
    """Time-sharded drop-in for the teacher-forced recurrence.

    Always starts from the zero RNN state (training windows are stateless;
    priming and generation run unsharded over time). x_tm: (T_local, [K,]
    B_local, I), this rank's time chunk (track-stacked params take the
    K axis). Returns ``(None, u_prev)`` with u_prev[t] the top layer's
    hidden state BEFORE consuming x[t], (T_local, [K,] B_local, U); the
    final cell state is not materialized. ``params.cfg.remat`` checkpoints
    each chunk scan's steps (nn/rnn.stacked_scan)."""
    from multinn_torch.nn import rnn as rnn_nn

    cfg = params.cfg
    t_loc, b_loc = x_tm.shape[0], x_tm.shape[-2]
    lead = tuple(x_tm.shape[1:-2])
    m = spec.microbatches
    if b_loc % m:
        raise ValueError(f"microbatches={m} does not divide local batch "
                         f"{b_loc}")
    mb = b_loc // m
    s, idx = spec.n_seq, spec.index
    # (T_loc, [K,] B_loc, I) -> microbatch q: (T_loc, [K,] mb, I)
    xs_mb = x_tm.reshape(t_loc, *lead, m, mb, x_tm.shape[-1])
    state = rnn_nn.stacked_zero_state(cfg.cell, (*lead, mb), cfg.n_rnn,
                                      cfg.rnn_layers, device=x_tm.device)
    bufs = [None] * m
    for j in range(s + m - 1):
        q = j - idx                        # the microbatch this rank scans
        valid = 0 <= q < m
        qc = min(max(q, 0), m - 1)
        final, us = rnn_nn.stacked_scan(cfg.cell, params.cell, state,
                                        xs_mb[..., qc, :, :],
                                        remat=cfg.remat)
        u0 = rnn_nn.state_h(state[-1])
        u_prev = torch.cat([u0[None], us[:-1]], dim=0)
        # an idle stage's states enter times zero: every stage reaches the
        # loss on every rank, so every ppermute's backward runs everywhere
        term = u_prev if valid else u_prev * 0.0
        bufs[qc] = term if bufs[qc] is None else bufs[qc] + term
        if j < s + m - 2:                 # the last hand-off is never read
            state = tuple(type(st)(**{f.name: comm.ppermute(
                getattr(st, f.name), spec.group)
                for f in dataclasses.fields(st)}) for st in final)
    # m x (T_loc, [K,] mb, U) -> (T_loc, [K,] B_loc, U)
    return None, torch.cat(bufs, dim=-2)
