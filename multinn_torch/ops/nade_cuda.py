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
same way. Weights are float32: the Pallas gate refuses anything else, and
so does the kernel's binding.
"""

from __future__ import annotations

import torch

from multinn_torch.ops import _build, kernel_prng
from multinn_torch.ops.sampling import key_to_seeds


def _rows(w, bv, bh, batch_shape):
    d, h = w.shape
    return (bv.expand(*batch_shape, d).reshape(-1, d).contiguous(),
            bh.expand(*batch_shape, h).reshape(-1, h).contiguous())


def nade_sample(key, w, v, bv, bh, batch_shape=()) -> torch.Tensor:
    """The sweep on the card: w, v (D, H) float32 CUDA tensors, bv / bh
    broadcastable to batch_shape + (D,) / (H,). Returns (*batch_shape, D)
    binary float32."""
    bv_2d, bh_2d = _rows(w, bv, bh, batch_shape)
    out = torch.empty_like(bv_2d)
    seeds = key_to_seeds(key).to(w.device)
    with torch.cuda.device(w.device):
        _build.launches["nade_sample"] += 1
        _build.ops().nade_sample(out, w.contiguous(), v.contiguous(), bv_2d,
                                 bh_2d, seeds, _build.stream_of(w))
    return out.reshape(*batch_shape, w.shape[0])


def nade_sample_plain(key, w, v, bv, bh, batch_shape=()) -> torch.Tensor:
    """Plain PyTorch version of ``nade_sample`` on the same stream."""
    bv_2d, bh_2d = _rows(w, bv, bh, batch_shape)
    d = w.shape[0]
    s0, s1 = (int(s) & kernel_prng.MASK for s in key_to_seeds(key).tolist())
    u = kernel_prng.uniform_from_bits(kernel_prng.random_bits_plain(
        (d, bv_2d.shape[0]), s0, s1, device=w.device))       # (D, N)
    a = bh_2d
    cols = []
    for i in range(d):
        s = torch.sigmoid(a) @ v[i]
        x = (u[i] < torch.sigmoid(s + bv_2d[:, i])).to(torch.float32)
        cols.append(x)
        a = a + x[:, None] * w[i]
    return torch.stack(cols, dim=-1).reshape(*batch_shape, d)
