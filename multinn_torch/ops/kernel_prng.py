"""Threefry-2x32-20 counter stream — port of multinn_tpu/ops/kernel_prng.py.

The stream every sampling kernel of the port draws from, bit-equal to the
JAX package's in-kernel PRNG: key (seed, salt), counter words
(c, c ^ 0x9E3779B9) with c = row * n_cols + col over the drawn shape (row
is the index along axis 0, col along the last axis, as the JAX version's
two iotas), and a uniform in [0, 1) from ``(bits >> 9) | 0x3F800000``
bit-cast to float, minus 1.

The kernels use the ``__device__`` function in csrc/threefry.cuh. This
module holds its plain version — uint32 arithmetic emulated in int64 masked
by 0xFFFFFFFF, since CPU torch lacks uint32 shifts and compares — and the
``threefry2x32`` op that runs the CUDA kernel (csrc/threefry.cu) on card
tensors.
"""

from __future__ import annotations

import torch

from multinn_torch.ops import _build

MASK = 0xFFFFFFFF
_ROT_EVEN = (13, 15, 26, 6)
_ROT_ODD = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_GOLDEN = 0x9E3779B9


def as_u64(x) -> torch.Tensor:
    """uint32 words (any int tensor, or a Python int) as int64 in
    [0, 2**32)."""
    if not isinstance(x, torch.Tensor):
        return torch.tensor(int(x) & MASK, dtype=torch.int64)
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32_plain(k0, k1, x0, x1):
    """One Threefry-2x32-20 block on int64 tensors holding uint32 values
    (broadcastable). Returns the two output words the same way."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for d in range(5):
        for r in (_ROT_EVEN if d % 2 == 0 else _ROT_ODD):
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & MASK
        x1 = (x1 + ks[(d + 2) % 3] + (d + 1)) & MASK
    return x0, x1


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                 impl=None):
    """Threefry-2x32-20 of the counters (x0, x1) under ``key`` (two uint32
    words as a tensor). x0/x1: int32 or uint32 tensors of one shape.
    Returns (y0, y1) as int32 tensors holding the uint32 bits — on the card
    through the CUDA kernel, on the CPU through the plain version."""
    if _build.impl_for(impl, x0) == "plain":
        kw = as_u64(key.reshape(-1))
        y0, y1 = threefry2x32_plain(kw[0], kw[1], as_u64(x0), as_u64(x1))
        # int64 -> int32 keeps the low 32 bits: the same uint32 bit pattern
        return y0.to(torch.int32), y1.to(torch.int32)
    as32 = lambda t: (t.view(torch.int32) if t.dtype == torch.uint32
                      else t).contiguous()
    key32, x0, x1 = as32(key.reshape(-1)), as32(x0), as32(x1)
    y0, y1 = torch.empty_like(x0), torch.empty_like(x1)
    with torch.cuda.device(x0.device):
        _build.launches["threefry2x32"] += 1
        _build.ops().threefry2x32(y0, y1, key32, x0, x1, _build.stream_of(x0))
    return y0, y1


def _counters(shape, device) -> torch.Tensor:
    rows = torch.arange(shape[0], dtype=torch.int64, device=device)
    cols = torch.arange(shape[-1], dtype=torch.int64, device=device)
    view = [1] * len(shape)
    view[0] = shape[0]
    c = rows.view(view) * shape[-1]
    view = [1] * len(shape)
    view[-1] = shape[-1]
    return ((c + cols.view(view)) & MASK).expand(shape)


def bits_at_plain(seed, salt, counter: torch.Tensor) -> torch.Tensor:
    """The (seed, salt) stream's bits at int64 ``counter`` values, as int64.
    ``seed``/``salt``: ints or int tensors broadcastable to ``counter``."""
    out0, _ = threefry2x32_plain(as_u64(seed).to(counter.device),
                                 as_u64(salt).to(counter.device),
                                 counter, counter ^ _GOLDEN)
    return out0


def row_map(n: int, rows):
    """(b0, N_global) of the row map ``rows`` of a sampling kernel's launch
    of n rows (or samples): they are rows b0 .. b0 + n - 1 of a batch of
    N_global (one data shard of a mesh), and draw the counters the whole
    batch's launch draws for them; None is ``(0, n)``, the launch itself."""
    if rows is None:
        return 0, n
    b0, total = (int(r) for r in rows)
    if b0 < 0 or b0 + n > total:
        raise ValueError(f"rows {b0}..{b0 + n - 1} do not lie in a batch "
                         f"of {total}")
    return b0, total


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """int64 uint32 bits -> float32 in [0, 1) (mantissa trick)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def random_bits(shape, seed: int, salt: int, device=None,
                impl=None) -> torch.Tensor:
    """The kernel stream's bits of ``shape`` as int32 (uint32 bit pattern):
    the plain version on the CPU, the threefry2x32 kernel on the card."""
    device = torch.device(device or "cpu")
    c = _counters(tuple(shape), device).contiguous()
    if _build.impl_for(impl, c) == "plain":
        return bits_at_plain(seed, salt, c).to(torch.int32)
    key = torch.tensor([int(seed) & MASK, int(salt) & MASK],
                       dtype=torch.int64).to(torch.int32).to(device)
    y0, _ = threefry2x32(key, c.to(torch.int32), (c ^ _GOLDEN).to(torch.int32),
                         impl="cuda")
    return y0


def random_uniform(shape, seed: int, salt: int, device=None,
                   impl=None) -> torch.Tensor:
    """Floats in [0, 1) of the kernel stream."""
    return uniform_from_bits(
        as_u64(random_bits(shape, seed, salt, device, impl)))
