"""First-party TensorBoard event-file writer and reader — the port's own
copy of multinn_tpu/utils/tb.py.

An ``events.out.tfevents.*`` file is a sequence of TFRecord frames, each a
protobuf-encoded ``Event`` message::

    TFRecord frame: uint64 len | uint32 masked_crc32c(len bytes)
                    | data | uint32 masked_crc32c(data)
    Event:  1: wall_time (double)   2: step (int64)
            3: file_version (string, first record only)
            5: summary -> Summary { 1: value -> Value { 1: tag (string),
                                                        2: simple_value,
                                                        4: image } }
    Image:  1: height   2: width   3: colorspace   4: encoded_image_string

Two summary kinds are written, scalars and images (the trainer's
pianoroll image summaries, PNG bytes from utils/images.py); only the
protobuf encodings those fields need are implemented. ``read_events``
decodes them back, so the format is round-trip tested.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterator, List, Tuple

# ---------------------------------------------------------------------------
# crc32c (Castagnoli) — TFRecord framing checksums. Table-driven pure
# Python; scalar events are tens of bytes, so throughput is irrelevant.
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord masks its CRCs to tolerate CRC-of-CRC storage patterns."""
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire helpers (just what Event/Summary need)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f64(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _i64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: int = 0, file_version: str = None,
           scalars: List[Tuple[str, float]] = (),
           images: List[Tuple[str, Tuple[int, int, int, bytes]]] = ()
           ) -> bytes:
    msg = _f64(1, wall_time) + _i64(2, step)
    if file_version is not None:
        msg += _bytes(3, file_version.encode())
    values = [_bytes(1, _bytes(1, tag.encode()) + _f32(2, float(val)))
              for tag, val in scalars]
    for tag, (height, width, colorspace, png) in images:
        img = (_i64(1, height) + _i64(2, width) + _i64(3, colorspace)
               + _bytes(4, png))
        values.append(_bytes(1, _bytes(1, tag.encode()) + _bytes(4, img)))
    if values:
        msg += _bytes(5, b"".join(values))
    return msg


def _frame(record: bytes) -> bytes:
    hdr = struct.pack("<Q", len(record))
    return (hdr + struct.pack("<I", _masked_crc(hdr))
            + record + struct.pack("<I", _masked_crc(record)))


# ---------------------------------------------------------------------------
# public writer / reader
# ---------------------------------------------------------------------------

class EventWriter:
    """TensorBoard writer: ``add_scalar(tag, value, step)``,
    ``add_scalars`` and ``add_image``.

    One ``events.out.tfevents.<ts>.<host>`` file per instance, line-buffered
    semantics (each event is flushed framed+checksummed, so a crash never
    leaves a torn tail that TB refuses to read past)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}"
                 f".{socket.gethostname()}")
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        self._f.write(_frame(record))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step, scalars=[(tag, value)]))

    def add_scalars(self, scalars: List[Tuple[str, float]],
                    step: int) -> None:
        """All of one step's tags in a single Event (one frame, one fsync
        unit — the common per-step call from MetricsLogger)."""
        self._write(_event(time.time(), step, scalars=list(scalars)))

    def add_image(self, tag: str, png: bytes, height: int, width: int,
                  step: int, colorspace: int = 3) -> None:
        """One encoded image (PNG bytes; colorspace 3 = RGB). Rendering and
        PNG encoding live in utils/images.py; this layer only frames."""
        self._write(_event(time.time(), step,
                           images=[(tag, (height, width, colorspace, png))]))

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_events(path: str) -> Iterator[dict]:
    """Decode an event file back to dicts (the round-trip half of the
    format contract; also handy for tests/tools). Yields
    {"wall_time", "step", "file_version"?, "scalars": {tag: value},
    "images": {tag: {"height", "width", "colorspace", "png"}}}."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        # a torn tail (process killed mid-_write) is a ValueError like a
        # corrupt crc — callers get ONE exception type for "bad file"
        if pos + 12 > len(data):
            raise ValueError(f"truncated frame header at byte {pos}")
        (ln,) = struct.unpack_from("<Q", data, pos)
        (lc,) = struct.unpack_from("<I", data, pos + 8)
        if lc != _masked_crc(data[pos:pos + 8]):
            raise ValueError(f"bad length crc at byte {pos}")
        if pos + 16 + ln > len(data):
            raise ValueError(f"truncated record at byte {pos}")
        rec = data[pos + 12:pos + 12 + ln]
        (rc,) = struct.unpack_from("<I", data, pos + 12 + ln)
        if rc != _masked_crc(rec):
            raise ValueError(f"bad record crc at byte {pos}")
        pos += 16 + ln
        yield _decode_event(rec)


def _decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    pos = 0
    while pos < len(buf):
        tag, pos = _decode_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _decode_varint(buf, pos)
        elif wire == 1:
            val, pos = struct.unpack_from("<d", buf, pos)[0], pos + 8
        elif wire == 5:
            val, pos = struct.unpack_from("<f", buf, pos)[0], pos + 4
        elif wire == 2:
            ln, pos = _decode_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _decode_image(buf: bytes) -> dict:
    img = {"height": 0, "width": 0, "colorspace": 0, "png": b""}
    for f, _, v in _fields(buf):
        if f == 1:
            img["height"] = v
        elif f == 2:
            img["width"] = v
        elif f == 3:
            img["colorspace"] = v
        elif f == 4:
            img["png"] = v
    return img


def _decode_event(rec: bytes) -> dict:
    out = {"wall_time": 0.0, "step": 0, "scalars": {}, "images": {}}
    for field, _, val in _fields(rec):
        if field == 1:
            out["wall_time"] = val
        elif field == 2:
            out["step"] = val
        elif field == 3:
            out["file_version"] = val.decode()
        elif field == 5:
            for f2, _, v2 in _fields(val):
                if f2 != 1:
                    continue
                tag, sval, ival = None, None, None
                for f3, _, v3 in _fields(v2):
                    if f3 == 1:
                        tag = v3.decode()
                    elif f3 == 2:
                        sval = v3
                    elif f3 == 4:
                        ival = _decode_image(v3)
                if tag is not None and sval is not None:
                    out["scalars"][tag] = sval
                if tag is not None and ival is not None:
                    out["images"][tag] = ival
    return out
