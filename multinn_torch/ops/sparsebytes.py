"""Sparse-byte coding of bit-packed pianorolls for the device -> host
transport — port of multinn_tpu/ops/sparsebytes.py.

``ops/bitpack`` ships binary rolls at 1 bit a cell; at musical densities
most of those packed bytes are zero. This codec ships only the nonzero
packed bytes as ``(flat_position, value)`` records.

Record layout (the host inverse is ``sparse_unpack``): one ``(cap, 5)``
uint8 buffer; row j = 4 little-endian bytes of the flat byte position
within the packed roll + the byte value. Rows past ``count`` (the int32
count of nonzero bytes, exact even when truncated) are zero-filled; iff
``count > cap`` the buffer is truncated and the caller falls back to a
frame transport (``Generator`` keeps the packed roll beside the records).

``sparse_pack`` is a stream compaction in plain PyTorch ops (an exclusive
cumsum and a scatter whose out-of-range targets land in one spare slot),
so it runs on the device with no host synchronisation. The host fetches
the records in whole chunks of ``FETCH_CHUNK`` rows, as many as ``count``
needs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

RECORD_BYTES = 5  # 4-byte LE position + 1-byte value
FETCH_CHUNK = 262144  # records per fetch chunk (1.25 MiB)


def sparse_pack(packed: torch.Tensor, cap: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A bit-packed roll (any shape, uint8 — ops/bitpack layout) ->
    ``(buf (cap, 5) uint8, count int32 scalar)`` on its device."""
    flat = packed.reshape(-1)
    if flat.numel() >= 1 << 31:
        raise ValueError(f"packed roll has {flat.numel()} bytes; int32 "
                         "positions overflow")
    mask = flat != 0
    hits = mask.to(torch.int32)
    pos = torch.cumsum(hits, 0, dtype=torch.int32) - hits  # exclusive
    tgt = torch.where(mask, pos, torch.full_like(pos, cap)).clamp_(max=cap)
    idx = torch.arange(flat.numel(), dtype=torch.int32, device=flat.device)
    # slot ``cap`` takes every dropped position (zeros and overflow)
    posbuf = torch.zeros(cap + 1, dtype=torch.int32, device=flat.device)
    posbuf.scatter_(0, tgt.long(), idx)
    posbuf = posbuf[:cap]
    count = hits.sum(dtype=torch.int32)
    valid = torch.arange(cap, device=flat.device) < count
    val = torch.where(valid, flat[posbuf.long()], torch.zeros_like(flat[:1]))
    # made on the device: a host tensor here would be a blocking copy
    shifts = 8 * torch.arange(4, dtype=torch.int32, device=flat.device)
    buf = ((posbuf[:, None] >> shifts) & 0xFF).to(torch.uint8)
    buf = torch.where(valid[:, None], buf, torch.zeros_like(buf))
    return torch.cat([buf, val[:, None]], dim=1), count


def sparse_unpack(buf: np.ndarray, count: int, packed_shape) -> np.ndarray:
    """Host-side inverse: ``(n >= count, 5)`` uint8 records -> the
    bit-packed uint8 roll of ``packed_shape`` (feed to
    bitpack.unpack_rolls for cells)."""
    buf = np.asarray(buf, np.uint8)
    count = int(count)
    if buf.ndim != 2 or buf.shape[1] != RECORD_BYTES or buf.shape[0] < count:
        raise ValueError(f"record buffer {buf.shape} can't hold "
                         f"{count} records")
    out = np.zeros(int(np.prod(packed_shape)), np.uint8)
    if count:
        pos = (buf[:count, :4].copy().view("<u4").reshape(-1)
               .astype(np.int64))
        if pos.max() >= out.size:
            raise ValueError("corrupt record stream (position out of "
                             "range)")
        out[pos] = buf[:count, 4]
    return out.reshape(packed_shape)


def record_cap(packed_size: int, chunk: int = FETCH_CHUNK) -> int:
    """Record-buffer rows for a packed roll of ``packed_size`` bytes: a
    25%-nonzero-bytes allowance, rounded up to a whole number of fetch
    chunks, so every chunk read lies inside the buffer."""
    want = max(packed_size // 4, 1)
    return -(-want // chunk) * chunk


def n_chunks(count: int, chunk: int = FETCH_CHUNK) -> int:
    """Fetch chunks needed to cover ``count`` valid records (at least 1,
    so a zero count still reads one chunk)."""
    return max(1, -(-count // chunk))
