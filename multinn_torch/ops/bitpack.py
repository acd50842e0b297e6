"""Bit-packing of binary pianorolls for device->host transport — port of
multinn_tpu/ops/bitpack.py.

The pitch axis (last) packs MSB-first into ceil(D/8) bytes — numpy's
``packbits`` layout — on the device; ``unpack_rolls`` inverts it on the
host, so ``unpack_rolls(pack_rolls(r), D) == r`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def packed_width(d: int) -> int:
    """Bytes per D binary pitches."""
    return (d + 7) // 8


def pack_rolls(roll: torch.Tensor) -> torch.Tensor:
    """(..., D) binary {0,1} (any dtype) -> (..., ceil(D/8)) uint8."""
    d = roll.shape[-1]
    bits = roll.to(torch.int32)
    pad = packed_width(d) * 8 - d
    if pad:
        bits = F.pad(bits, (0, pad))
    bits = bits.reshape(*bits.shape[:-1], packed_width(d), 8)
    # made on the device: a host tensor here would be a blocking copy
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=roll.device)
    return (bits << shifts).sum(dim=-1).to(torch.uint8)


def unpack_rolls(packed, d: int) -> np.ndarray:
    """Host-side inverse: (..., ceil(D/8)) uint8 -> (..., D) uint8 {0,1}."""
    bits = np.unpackbits(np.asarray(packed, np.uint8), axis=-1)
    return bits[..., :d]
