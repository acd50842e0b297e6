"""Pianoroll images — the port's own copy of multinn_tpu/utils/images.py,
with a first-party PNG codec in place of PIL.

``render_pianoroll`` draws a binary roll as an RGB array (pitch upward, one
colour per track). ``encode_png`` writes the bytes PIL writes for an RGB
uint8 array with its default settings: each row takes the filter of least
sum of |signed byte| among none, up, sub and Paeth, tried in that order (a
later filter replaces the choice only when strictly smaller, and none is
tried once the choice costs 0), the stream is deflated at level 6 with ``Z_FILTERED``,
window 15 and memLevel 9, and split into IDAT chunks of 65536 bytes.
``decode_png`` reads such files back to the array. Only the standard
library's zlib is needed, so the images are written the same way on any
machine.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

import numpy as np

# distinct RGB per track (drums, piano, guitar, bass, strings order for LPD-5)
_TRACK_COLORS = np.array([
    [230, 60, 60],     # red
    [60, 120, 230],    # blue
    [60, 200, 90],     # green
    [240, 180, 40],    # yellow
    [170, 80, 220],    # purple
    [80, 220, 220],    # cyan
    [240, 120, 180],   # pink
    [160, 160, 160],   # grey
], dtype=np.uint8)

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_IDAT_BYTES = 65536


def render_pianoroll(roll: np.ndarray, scale: int = 2) -> np.ndarray:
    """(T, K, D) or (T, D) binary -> RGB image (D*scale, T*scale, 3), pitch
    axis upward, one color per track (overlaps blend additively)."""
    roll = np.asarray(roll)
    if roll.ndim == 2:
        roll = roll[:, None, :]
    t, k, d = roll.shape
    img = np.zeros((d, t, 3), np.uint16)
    for ki in range(k):
        color = _TRACK_COLORS[ki % len(_TRACK_COLORS)]
        mask = roll[:, ki, :].T.astype(bool)           # (D, T)
        img[mask] += color
    img = np.clip(img, 0, 255).astype(np.uint8)
    img = img[::-1]                                     # low pitch at bottom
    if scale > 1:
        img = np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)
    return img


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _paeth(left: np.ndarray, up: np.ndarray, upleft: np.ndarray
           ) -> np.ndarray:
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    return np.where((pa <= pb) & (pa <= pc), left,
                    np.where(pb <= pc, up, upleft))


def encode_png(img: np.ndarray) -> bytes:
    """RGB uint8 (H, W, 3) -> PNG bytes (module docstring)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, bpp = img.shape
    cur = img.reshape(h, w * bpp).astype(np.int32)
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    left = np.zeros_like(cur)
    left[:, bpp:] = cur[:, :-bpp]
    upleft = np.zeros_like(cur)
    upleft[:, bpp:] = up[:, :-bpp]
    # (filter type, filtered rows) in the order the filters are tried
    cands = [(0, cur), (2, cur - up), (1, cur - left),
             (4, cur - _paeth(left, up, upleft))]
    filtered = [(code, (rows & 0xFF).astype(np.uint8)) for code, rows in cands]
    costs = [np.where(rows < 128, rows, 256 - rows.astype(np.int32)).sum(-1)
             for _, rows in filtered]
    lines = []
    for i in range(h):
        best = 0
        for j in range(1, len(filtered)):
            if costs[best][i] > 0 and costs[j][i] < costs[best][i]:
                best = j
        code, rows = filtered[best]
        lines.append(bytes((code,)) + rows[i].tobytes())
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    data = z.compress(b"".join(lines)) + z.flush()
    out = [_PNG_MAGIC,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    out += [_chunk(b"IDAT", data[i:i + _IDAT_BYTES])
            for i in range(0, len(data), _IDAT_BYTES)]
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def decode_png(png: bytes) -> np.ndarray:
    """8-bit RGB PNG bytes (non-interlaced, any row filters) -> (H, W, 3)
    uint8. Raises ValueError on any other PNG or a bad checksum."""
    if png[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(png):
        (n,) = struct.unpack_from(">I", png, pos)
        kind, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", png, pos + 8 + n)
        if crc != zlib.crc32(kind + data):
            raise ValueError(f"bad crc in chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if hdr is None or hdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"only 8-bit RGB non-interlaced PNGs, got {hdr}")
    w, h = hdr[:2]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.int32)
    for i in range(h):
        code, row = raw[i, 0], raw[i, 1:].astype(np.int32)
        up = out[i - 1] if i else np.zeros_like(row)
        if code in (0, 2):
            out[i] = (row + (up if code == 2 else 0)) & 0xFF
        elif code == 1:                        # sub: a running sum per channel
            out[i] = (np.cumsum(row.reshape(w, 3), axis=0) & 0xFF).ravel()
        elif code in (3, 4):                   # average, Paeth: pixel by pixel
            line = out[i]
            for x in range(3 * w):
                a = line[x - 3] if x >= 3 else 0
                c = up[x - 3] if x >= 3 else 0
                b = up[x]
                if code == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = (a if pa <= pb and pa <= pc
                            else b if pb <= pc else c)
                line[x] = (row[x] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter {code}")
    return out.astype(np.uint8).reshape(h, w, 3)


def save_pianoroll_png(roll: np.ndarray, path: str, scale: int = 2) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(render_pianoroll(roll, scale)))
    return path


def save_sample_grid(rolls: np.ndarray, out_dir: str, prefix: str = "sample",
                     scale: int = 2) -> Sequence[str]:
    """One PNG per sample of a (N, T, K, D) batch."""
    paths = []
    for i, roll in enumerate(np.asarray(rolls)):
        paths.append(save_pianoroll_png(
            roll, os.path.join(out_dir, f"{prefix}_{i:03d}.png"), scale))
    return paths
