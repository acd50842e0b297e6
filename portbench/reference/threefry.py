"""Threefry-2x32-20 and the key functions of ``jax.random`` on raw keys,
in plain Python integers and torch int64 tensors holding uint32 values.

The streams the cells sample from are stated in terms of these: a key is
two uint32 words; ``prng_key(s)`` is (0, s); ``fold_in(key, i)`` and
``split(key, n)[i]`` are the Threefry block of the counter (0, i) under
the key. A kernel's uniform at (seed, salt, counter c) is the first word
of the block of (c, c ^ 0x9E3779B9) under the key (seed, salt), its top
23 bits as the mantissa of a float in [1, 2), minus 1.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def block(k0, k1, x0, x1):
    """One Threefry-2x32-20 block; arguments are ints or int64 tensors
    holding uint32 values (broadcastable), and so are the two results."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for d in range(5):
        for r in _ROT[d % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & MASK
        x1 = (x1 + ks[(d + 2) % 3] + d + 1) & MASK
    return x0, x1


def prng_key(seed: int):
    return 0, int(seed) & MASK


def fold_in(key, data: int):
    return block(key[0], key[1], 0, int(data) & MASK)


def split(key, i: int):
    """Key i of ``split(key, n)`` (for any n > i)."""
    return block(key[0], key[1], 0, int(i))


def uniform(seed, salt, counter: torch.Tensor) -> torch.Tensor:
    """The stream's float32 uniforms at int64 ``counter`` values; ``seed``
    and ``salt``: ints or int64 tensors broadcastable to ``counter``."""
    bits, _ = block(seed, salt, counter, counter ^ GOLDEN)
    return (((bits >> 9) | 0x3F800000).to(torch.int32)
            .view(torch.float32) - 1.0)
