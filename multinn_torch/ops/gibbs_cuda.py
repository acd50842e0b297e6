"""The k-sweep block-Gibbs chain: CUDA kernel wrapper (csrc/gibbs_chain.cu)
and its plain PyTorch version — port of multinn_tpu/ops/gibbs_pallas.py.

Both draw the JAX Pallas kernel's stream: rows are tiled into blocks of
``block_rows(N, D, H)`` (the Pallas kernel's ``_block_b`` rule, kept for its
stream layout, not for any memory budget of this card), block q keys its
stream with ``seed[0] ^ q * 0x85EB`` (int32, wrapping), and the draw at
(row r of the block, column c) has counter r * n_cols + c under salt
``seed[1] + 2i`` (h of sweep i) or ``+ 2i + 1`` (v). So the plain version
equals ``gibbs_pallas.gibbs_chain(..., interpret=True)`` bit for bit, and
the kernel equals the plain version up to the rare draw a last-ulp
difference in a probability flips.

The row map ``rows=(b0, B_global)``: v0 (..., B_local, D) holds rows b0 ..
b0 + B_local - 1 of each (..., B_global, D) group of a larger launch (one
data shard of a mesh), and each row draws the bits that launch would draw
for it: its stream block and counter are those of its row there. None is
``(0, B_local)``, the launch itself.

The Pallas dispatch gate (8 <= B <= 2048) was a TPU performance crossover;
the kernel here takes any row count and picks one of two launch plans from
it (``launch_plan``): a latency plan for the scan path's few rows and a
throughput plan for the training and k=25 shapes. Where W at its pitch and
the plan's rows exceed a CTA's shared memory, the throughput plan reads W
from device memory instead, so every (D, H) the reference runs is launched.
"""

from __future__ import annotations

import torch

from multinn_torch.ops import _build, kernel_prng
from multinn_torch.ops.sampling import key_to_seeds

# the Pallas kernel's row-tile budget (multinn_tpu/ops/vmem.py:
# PER_STEP_KERNEL_BUDGET_BYTES) — part of the stream layout
_TILE_BUDGET_BYTES = (10 * 1024 * 1024 * 4) // 5


def block_rows(b: int, d: int, h: int) -> int:
    """Rows per stream block: gibbs_pallas._block_b's formula."""
    per_row = 4 * (2 * d + 2 * h + d + h)
    bb = max(8, min(b, _TILE_BUDGET_BYTES // max(per_row, 1)))
    bb = (bb // 8) * 8
    return max(8, min(bb, 1024))


def _rows(v0, w, bv, bh):
    d, h = w.shape
    shape = v0.shape
    return (v0.reshape(-1, d).contiguous(),
            bv.expand(shape).reshape(-1, d).contiguous(),
            bh.expand(*shape[:-1], h).reshape(-1, h).contiguous())


def row_map(v0, rows):
    """(b0, B_local, B_global) of the row map ``rows`` for v0 (...,
    B_local, D): each run of B_local rows is rows b0 .. b0 + B_local - 1 of
    a run of B_global in the launch whose stream is drawn."""
    b_loc = v0.shape[-2] if v0.dim() >= 2 else 1
    b0, b_glob = kernel_prng.row_map(b_loc, rows)
    return b0, b_loc, b_glob


# launch plans of csrc/gibbs_chain.cu: (rows per CTA, threads, lanes per
# dot, W in shared memory 1 / in device memory 0)
LATENCY_PLAN = (1, 256, 8, 1)
_WARPS = 8                     # warps per CTA of the throughput plan
CTA_SMEM_LIMIT = 227 * 1024    # a CTA's dynamic shared memory


def _r4(x: int) -> int:
    return -(-x // 4) * 4


def plan_smem_bytes(plan, d: int, h: int) -> int:
    """The shared memory csrc/gibbs_chain.cu's launcher asks for under
    ``plan``: W at the plan's pitch (when it stays in shared memory) and
    the rows' state."""
    rows, _, lanes, w_smem = plan
    if lanes > 1:          # latency plan: pitch H rounded to 32, plus 4
        h32 = -(-h // 32) * 32
        return 4 * (_r4(d) * (h32 + 4) + _r4(d) + h32 + 3 * (d + h))
    return 4 * (w_smem * _r4(d) * (_r4(h) + 1) + rows * (_r4(d) + _r4(h)))


def launch_plan(n: int, sm_count: int, d: int,
                h: int) -> tuple[int, int, int, int]:
    """The kernel's launch plan for n rows of an RBM (D, H) on a card with
    ``sm_count`` SMs.

    Up to three rows per SM (the CTAs an SM holds at once), the latency
    plan: one row per CTA, each output's dot product split over 8 lanes, so
    a pass is a short chain. Beyond that, the throughput plan: each of a
    CTA's 8 warps carries its rows through all sweeps, one lane per output
    with a register block of rows — 2 rows a warp once that still gives
    every SM a CTA, else 1, so the card holds more warps. The crossovers
    are measured ones (``scripts/torch_kernel_sweep.py --plans``). Where W
    at its pitch and the chosen plan's rows exceed a CTA's 227 KB, the
    throughput plan with W in device memory (read through L2); a shape
    whose rows alone do not fit raises before any launch."""
    rows_per_warp = 2 if -(-n // (2 * _WARPS)) >= sm_count else 1
    plan = (LATENCY_PLAN if n <= 3 * sm_count
            else (_WARPS * rows_per_warp, _WARPS * 32, 1, 1))
    if plan_smem_bytes(plan, d, h) <= CTA_SMEM_LIMIT:
        return plan
    plan = (_WARPS * rows_per_warp, _WARPS * 32, 1, 0)
    if plan_smem_bytes(plan, d, h) <= CTA_SMEM_LIMIT:
        return plan
    raise ValueError(
        f"gibbs_chain: D={d}, H={h} needs {plan_smem_bytes(plan, d, h)} "
        f"bytes of shared memory for a CTA's rows, over the card's "
        f"{CTA_SMEM_LIMIT} (227 KB) limit")


def gibbs_chain(key, v0, w, bv, bh, k: int, rows=None) -> torch.Tensor:
    """The chain on the card: v0 (..., D) float32 CUDA tensors, biases
    broadcastable to v0 / (..., H); returns the k-th visible sample.
    ``rows``: the row map (b0, B_global), None for the launch's own."""
    n = v0.numel() // w.shape[0]
    return _launch(key, v0, w, bv, bh, k,
                   launch_plan(n, _build.sm_count(v0), *w.shape), rows)


def _launch(key, v0, w, bv, bh, k: int, plan, rows=None) -> torch.Tensor:
    """``gibbs_chain`` under a given launch plan."""
    b0, b_loc, b_glob = row_map(v0, rows)
    v0_2d, bv_2d, bh_2d = _rows(v0, w, bv, bh)
    d, h = w.shape
    out = torch.empty_like(v0_2d)
    seeds = key_to_seeds(key).to(v0.device)
    bb = block_rows(v0_2d.shape[0] // b_loc * b_glob, d, h)
    with torch.cuda.device(v0.device):
        _build.launches["gibbs_chain"] += 1
        _build.ops().gibbs_chain(out, v0_2d, w.contiguous(), bv_2d, bh_2d,
                                 seeds, k, bb, b0, b_loc, b_glob, *plan,
                                 _build.stream_of(v0))
    return out.reshape(v0.shape)


def gibbs_chain_plain(key, v0, w, bv, bh, k: int,
                      rows=None) -> torch.Tensor:
    """Plain PyTorch version of ``gibbs_chain`` on the same stream."""
    b0, b_loc, b_glob = row_map(v0, rows)
    v0_2d, bv_2d, bh_2d = _rows(v0, w, bv, bh)
    n = v0_2d.shape[0]
    d, h = w.shape
    s0, s1 = (int(s) & kernel_prng.MASK for s in key_to_seeds(key).tolist())
    local = torch.arange(n, dtype=torch.int64, device=v0.device)
    rows = (local // b_loc) * b_glob + b0 + local % b_loc
    bb = block_rows(n // b_loc * b_glob, d, h)
    blk, lrow = rows // bb, rows % bb
    seed = (s0 ^ ((blk * 0x85EB) & kernel_prng.MASK))[:, None]
    ctr_h = lrow[:, None] * h + torch.arange(h, device=v0.device)
    ctr_v = lrow[:, None] * d + torch.arange(d, device=v0.device)
    v = v0_2d
    for i in range(k):
        salt = (s1 + 2 * i) & kernel_prng.MASK
        ph = torch.sigmoid(v @ w + bh_2d)
        uh = kernel_prng.uniform_from_bits(
            kernel_prng.bits_at_plain(seed, salt, ctr_h))
        hs = (uh < ph).to(v.dtype)
        pv = torch.sigmoid(hs @ w.t() + bv_2d)
        uv = kernel_prng.uniform_from_bits(
            kernel_prng.bits_at_plain(seed, salt + 1, ctr_v))
        v = (uv < pv).to(v.dtype)
    return v.reshape(v0.shape)
