"""Threefry keys and the kernel-seed contract — port of the key half of
multinn_tpu/ops/sampling.py plus the raw-key ``jax.random`` functions the
generation path uses.

A key is two uint32 words as a tensor, exactly ``jax.random.key_data`` of
a raw JAX key: ``PRNGKey(s)``, ``fold_in(key, i)`` and ``split(key, n)``
give the same words as their ``jax.random`` namesakes under the installed
JAX's defaults (``jax_threefry_partitionable=True``: ``split`` counts with
the 64-bit iota's (hi, lo) word pair, so ``split(key, n)[i]`` is the
Threefry block of counter (0, i)). Keys that live on the card are derived
there by the threefry2x32 kernel — no host round trip between a serving
batch's key and its generation kernel. ``key_to_seeds`` gives the kernels
their two int32 seed words.

``uniform``, ``bernoulli`` and ``randint`` are ``jax.random``'s under the
same layout (bits of flat index i are the Threefry block of counter
(i >> 32, i & 0xFFFFFFFF), its two words XORed): the monitoring draws of the
RBM loss (``nn/rbm.py``: reconstruction, pseudo-likelihood) take them, as
the JAX package's do on every backend.
"""

from __future__ import annotations

import torch

from multinn_torch.ops import kernel_prng


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Raw key of an int32 seed: (0, seed mod 2**32), as jax.random.PRNGKey
    with 64-bit types disabled."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit int32")
    words = torch.tensor([0, seed & kernel_prng.MASK], dtype=torch.int64)
    return words.to(torch.int32).view(torch.uint32).to(device)


def _stack(y0: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    return torch.stack([y0, y1], dim=-1).view(torch.uint32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in: the Threefry block of counter (0, data)."""
    x0 = torch.zeros(1, dtype=torch.int32, device=key.device)
    # filled on the device (a host tensor would be a blocking copy)
    word = int(data) & kernel_prng.MASK
    x1 = torch.full((1,), word - (word >> 31 << 32), dtype=torch.int32,
                    device=key.device)
    y0, y1 = kernel_prng.threefry2x32(key, x0, x1)
    return _stack(y0, y1)[0]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split (partitionable layout): (num, 2) keys, key i the
    Threefry block of counter (0, i)."""
    x0 = torch.zeros(num, dtype=torch.int32, device=key.device)
    x1 = torch.arange(num, dtype=torch.int32, device=key.device)
    y0, y1 = kernel_prng.threefry2x32(key, x0, x1)
    return _stack(y0, y1)


def _random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.bits(key, shape) for 32-bit words (partitionable layout):
    the Threefry block of counter (hi, lo) of each element's row-major flat
    index, its two output words XORed. int64 tensor of uint32 values."""
    n = 1
    for s in shape:
        n *= int(s)
    flat = torch.arange(n, dtype=torch.int64, device=key.device)
    hi = (flat >> 32).to(torch.int32)
    lo = (flat & kernel_prng.MASK).to(torch.int32)
    y0, y1 = kernel_prng.threefry2x32(key, hi, lo)
    return (kernel_prng.as_u64(y0) ^ kernel_prng.as_u64(y1)).reshape(shape)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.uniform(key, shape) (float32 in [0, 1)), bit for bit."""
    return kernel_prng.uniform_from_bits(_random_bits(key, tuple(shape)))


def bernoulli(key: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """{0, 1} in p's dtype: ``uniform(key, p.shape) < p``, as the JAX
    package's ``nn.rbm._bernoulli``."""
    return (uniform(key, p.shape).to(p.device) < p).to(p.dtype)


def randint(key: torch.Tensor, shape, lo: int, hi: int) -> torch.Tensor:
    """jax.random.randint(key, shape, lo, hi) for int32, bit for bit: two
    words per value under ``split(key)``, folded into the span with the
    2**32 mod span multiplier. Returns int64 values in [lo, hi)."""
    shape = tuple(shape)
    k1, k2 = split(key)
    higher, lower = _random_bits(k1, shape), _random_bits(k2, shape)
    span = max(int(hi) - int(lo), 1)
    # uint32 arithmetic: every product and sum wraps as in JAX
    mult = ((2 ** 16 % span) ** 2 & kernel_prng.MASK) % span
    offset = (((higher % span) * mult) & kernel_prng.MASK) + lower % span
    return int(lo) + (offset & kernel_prng.MASK) % span


def key_to_seeds(key: torch.Tensor) -> torch.Tensor:
    """Both 32-bit words of a key as a (2,) int32 tensor — the full 64-bit
    Threefry key of the in-kernel PRNG (first and last word, as the JAX
    version)."""
    words = key.reshape(-1).view(torch.int32)
    if words.numel() == 2:     # the key itself: no copy, no kernel
        return words
    return torch.stack([words[0], words[-1]])
