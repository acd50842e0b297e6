"""The NADE ancestral sampling sweep: CUDA kernel wrapper
(csrc/nade_sample.cu) and its plain PyTorch version — port of
multinn_tpu/ops/nade_pallas.py.

    a = bh;  per dim i:  h = sigmoid(a),  p = sigmoid(bv_i + V_i . h),
                         x_i = (u_i < p),  a += x_i W_i

Both draw the Pallas kernel's stream: one (D, N) uniform matrix under key
(seed[0], seed[1]) (the kernel's block key ``seed[0] ^ 0 * 0x85EB``; under
``jax.vmap`` over tracks its grid keeps program_id 0, so each track's key
plays the same role), so the draw of (dim i, row b) has counter i * N + b.
The plain version therefore equals ``nade_pallas.sample(...,
interpret=True)`` bit for bit up to the rare draw that a last-ulp
difference in a logit flips, and the kernel equals the plain version the
same way. The row map ``rows=(b0, N_global)``: the N rows are rows b0 ..
b0 + N - 1 of a batch of N_global (one data shard of a mesh), and row b
draws counter i * N_global + b0 + b, what the whole batch's launch draws
for it; None is ``(0, N)``. Weights are float32: the Pallas gate refuses anything else, and
so does the kernel's binding.

The kernel runs one CTA a row and looks ahead over runs of zeros: the
logits of a window of 16 dims come from the same h, and the first one
drawn ends the window (``sample_plan``: whether W and V are staged in
shared memory or read from L2).
"""

from __future__ import annotations

import torch

from multinn_torch.ops import _build, kernel_prng
from multinn_torch.ops.sampling import key_to_seeds


def _rows(w, bv, bh, batch_shape):
    d, h = w.shape
    return (bv.expand(*batch_shape, d).reshape(-1, d).contiguous(),
            bh.expand(*batch_shape, h).reshape(-1, h).contiguous())


# csrc/nade_sample.cu: one CTA of 128 threads a row
ROW_THREADS = 128
GROUP_DIMS = 4            # dims a bulk copy of W and V carries
CTA_SMEM_LIMIT = 227 * 1024


def _r4(x: int) -> int:
    return -(-x // 4) * 4


def sample_smem_bytes(d: int, h: int, staged: bool) -> int:
    """csrc/nade_sample.cu nade_sample_smem_bytes: when staged, the bulk
    copies' mbarriers and W and V; the row's a, h (H rounded to 32 each), u
    and bv (D each) and the warps' hit bits."""
    bars = _r4(2 * -(-d // GROUP_DIMS))
    return 4 * ((bars + 2 * _r4(d * h) if staged else 0)
                + 2 * (-(-h // 32) * 32) + 2 * d + 2 * (ROW_THREADS // 32))


def sample_plan(d: int, h: int, aligned: bool = True) -> int:
    """W and V staged in shared memory (1) or read from L2 (0) by the
    sampler kernel, which runs one CTA a row: staged where they fit beside
    the row's state and both are 16-byte aligned (the bulk copies need it),
    else from L2; a shape whose row alone does not fit raises before any
    launch."""
    for staged in (1, 0) if aligned else (0,):
        if sample_smem_bytes(d, h, staged) <= CTA_SMEM_LIMIT:
            return staged
    raise ValueError(
        f"nade_sample: D={d}, H={h} needs {sample_smem_bytes(d, h, False)} "
        f"bytes of shared memory for one row, over the card's "
        f"{CTA_SMEM_LIMIT} (227 KB) limit")


def nade_sample(key, w, v, bv, bh, batch_shape=(), rows=None) -> torch.Tensor:
    """The sweep on the card: w, v (D, H) float32 CUDA tensors, bv / bh
    broadcastable to batch_shape + (D,) / (H,). Returns (*batch_shape, D)
    binary float32. ``rows``: the row map (b0, N_global)."""
    w, v = w.contiguous(), v.contiguous()
    aligned = (w.data_ptr() | v.data_ptr()) % 16 == 0
    return _launch(key, w, v, bv, bh, batch_shape,
                   sample_plan(*w.shape, aligned), rows)


def _launch(key, w, v, bv, bh, batch_shape, staged,
            rows=None) -> torch.Tensor:
    """``nade_sample`` under a given plan (staged 1 / 0)."""
    bv_2d, bh_2d = _rows(w, bv, bh, batch_shape)
    b0, total = kernel_prng.row_map(bv_2d.shape[0], rows)
    out = torch.empty_like(bv_2d)
    seeds = key_to_seeds(key).to(w.device)
    with torch.cuda.device(w.device):
        _build.launches["nade_sample"] += 1
        _build.ops().nade_sample(out, w.contiguous(), v.contiguous(), bv_2d,
                                 bh_2d, seeds, staged, b0, total,
                                 _build.stream_of(w))
    return out.reshape(*batch_shape, w.shape[0])


def nade_sample_plain(key, w, v, bv, bh, batch_shape=(),
                      rows=None) -> torch.Tensor:
    """Plain PyTorch version of ``nade_sample`` on the same stream."""
    bv_2d, bh_2d = _rows(w, bv, bh, batch_shape)
    d, n = w.shape[0], bv_2d.shape[0]
    b0, total = kernel_prng.row_map(n, rows)
    s0, s1 = (int(s) & kernel_prng.MASK for s in key_to_seeds(key).tolist())
    ctr = (torch.arange(d, dtype=torch.int64, device=w.device)[:, None]
           * total + b0 + torch.arange(n, dtype=torch.int64,
                                       device=w.device))     # (D, N)
    u = kernel_prng.uniform_from_bits(kernel_prng.bits_at_plain(
        s0, s1, ctr & kernel_prng.MASK))                     # (D, N)
    a = bh_2d
    cols = []
    for i in range(d):
        s = torch.sigmoid(a) @ v[i]
        x = (u[i] < torch.sigmoid(s + bv_2d[:, i])).to(torch.float32)
        cols.append(x)
        a = a + x[:, None] * w[i]
    return torch.stack(cols, dim=-1).reshape(*batch_shape, d)
