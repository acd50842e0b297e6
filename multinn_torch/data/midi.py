"""First-party Standard MIDI File (SMF) reader and writer — the port's own
copy of multinn_tpu/data/midi.py (the port imports nothing of the JAX
package).

Scope: what pianoroll modelling needs — note on/off with velocities per
(track, channel, program), tempo meta, drum-channel detection, running
status, formats 0/1 (format 2's patterns overlaid at tick 0) — and a
format-1 writer for generated pianorolls. Timing stays symbolic (ticks and
ticks per quarter note): quantization works on the musical grid; the tempo
map is kept. SMPTE division is refused.

Robustness contract: any byte-level corruption raises ``MidiParseError``
(never IndexError or struct.error, never a hang); truncated meta / sysex
payloads are clamped, truncation inside event bytes rejects the file — the
same accept / reject set as the native reader (native/midi_fast.cpp).
"""

from __future__ import annotations

import dataclasses
import struct as _struct
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Note:
    pitch: int          # 0..127
    velocity: int       # 1..127
    start: int          # absolute ticks
    end: int            # absolute ticks (exclusive)


@dataclasses.dataclass
class Instrument:
    program: int        # 0..127
    is_drum: bool
    name: str = ""
    notes: List[Note] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MidiFile:
    ticks_per_quarter: int = 480
    instruments: List[Instrument] = dataclasses.field(default_factory=list)
    tempo_us_per_quarter: int = 500000      # first tempo event (120 bpm)
    # full tempo map, (tick, us_per_quarter) ascending; empty = no tempo
    # meta seen (the 120 bpm default applies throughout)
    tempo_map: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)

    @property
    def bpm(self) -> float:
        return 6e7 / self.tempo_us_per_quarter

    def end_tick(self) -> int:
        return max((n.end for ins in self.instruments for n in ins.notes),
                   default=0)

    def tick_to_seconds(self, tick: int) -> float:
        """Seconds-domain position of an absolute tick, walking the tempo
        map (piecewise-constant tempo between events; events after ``tick``
        are ignored). Grid quantization never calls this — it exists for
        seconds-domain consumers (audio alignment, playback duration)."""
        seconds = 0.0
        cur_tick, cur_uspq = 0, 500000
        for t, uspq in self.tempo_map:
            if t >= tick:
                break
            seconds += (t - cur_tick) * cur_uspq / (
                1e6 * self.ticks_per_quarter)
            cur_tick, cur_uspq = t, uspq
        seconds += (tick - cur_tick) * cur_uspq / (
            1e6 * self.ticks_per_quarter)
        return seconds

    def duration_seconds(self) -> float:
        return self.tick_to_seconds(self.end_tick())


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    """SMF variable-length quantity, capped at the spec's 4 bytes (a 5th
    continuation byte in the wild is corruption; the native fast path stops
    at 4 too, so both layers parse corrupt files identically)."""
    value = 0
    for _ in range(4):
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return value, pos


class MidiParseError(ValueError):
    pass


def _parse_track(data: bytes, collector: "_EventCollector") -> None:
    """Raises MidiParseError on truncation INSIDE event bytes (delta with
    no event, short data bytes, a dangling running status, a system-common/
    realtime byte — none of which a valid MTrk contains); truncated meta/
    sysex PAYLOADS are clamped (Python slicing semantics), matching the
    native fast path byte for byte."""
    try:
        _parse_track_inner(data, collector)
    except IndexError:
        raise MidiParseError("truncated track chunk") from None


def _parse_track_inner(data: bytes, collector: "_EventCollector") -> None:
    pos = 0
    tick = 0
    running_status: Optional[int] = None
    while pos < len(data):
        delta, pos = _read_varint(data, pos)
        tick += delta
        status = data[pos]
        if status >= 0x80:
            pos += 1
            if status < 0xF0:
                running_status = status
        else:
            if running_status is None:
                raise MidiParseError("data byte with no running status")
            status = running_status

        if status == 0xFF:                      # meta event
            meta_type = data[pos]
            length, pos2 = _read_varint(data, pos + 1)
            payload = data[pos2:pos2 + length]
            pos = pos2 + length
            collector.meta(tick, meta_type, payload)
        elif status in (0xF0, 0xF7):            # sysex — skip
            length, pos2 = _read_varint(data, pos)
            pos = pos2 + length
        else:
            kind = status & 0xF0
            channel = status & 0x0F
            if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                d1, d2 = data[pos], data[pos + 1]
                pos += 2
            elif kind in (0xC0, 0xD0):
                d1, d2 = data[pos], 0
                pos += 1
            else:
                # 0xF1-0xF6 / 0xF8-0xFE: system common/realtime bytes never
                # belong in an SMF track — corruption; reject the file
                raise MidiParseError(f"bad status byte 0x{status:02x}")
            if d1 >= 0x80 or d2 >= 0x80:
                # a status byte where a data byte belongs: malformed event
                # (mido/pretty_midi reject these too; masking to 7 bits
                # would fabricate notes from corruption)
                raise MidiParseError(
                    f"data byte >= 0x80 in event 0x{status:02x}")
            collector.channel_event(tick, kind, channel, d1, d2)


class _EventCollector:
    """Accumulates note on/off pairs into Instruments keyed by
    (track, channel, program) with drum channel 9 handling."""

    def __init__(self, track_idx: int, out: "MidiFile",
                 instruments: Dict[Tuple[int, int, int], Instrument]):
        self.track_idx = track_idx
        self.out = out
        self.instruments = instruments
        self.program = [0] * 16                 # current program per channel
        # (channel, pitch) -> list of (start_tick, velocity, instrument):
        # the owning instrument is resolved at note-ON (a program change
        # while a note sounds must not re-attribute it — the overflow-track
        # writer interleaves changes on a shared channel)
        self.open_notes: Dict[Tuple[int, int],
                              List[Tuple[int, int, Instrument]]] = {}
        self.track_name = ""

    def meta(self, tick: int, meta_type: int, payload: bytes) -> None:
        if meta_type == 0x51 and len(payload) == 3:
            uspq = int.from_bytes(payload, "big")
            self.out.tempo_map.append((tick, uspq))
        elif meta_type == 0x03:
            self.track_name = payload.decode("latin-1", "replace")

    def _instrument(self, channel: int) -> Instrument:
        key = (self.track_idx, channel, self.program[channel])
        if key not in self.instruments:
            self.instruments[key] = Instrument(
                program=self.program[channel], is_drum=(channel == 9),
                name=self.track_name)
        return self.instruments[key]

    def channel_event(self, tick, kind, channel, d1, d2) -> None:
        if kind == 0xC0:
            self.program[channel] = d1
        elif kind == 0x90 and d2 > 0:           # note on
            self.open_notes.setdefault((channel, d1), []).append(
                (tick, d2, self._instrument(channel)))
        elif kind == 0x80 or (kind == 0x90 and d2 == 0):   # note off
            stack = self.open_notes.get((channel, d1))
            if stack:
                start, vel, ins = stack.pop(0)
                if tick > start:
                    ins.notes.append(
                        Note(pitch=d1, velocity=vel, start=start, end=tick))

    def finish(self) -> None:
        # close dangling notes at their start+1 tick (defensive)
        for (channel, pitch), stack in self.open_notes.items():
            for start, vel, ins in stack:
                ins.notes.append(
                    Note(pitch=pitch, velocity=vel, start=start,
                         end=start + 1))
        self.open_notes.clear()


def loads(data: bytes) -> MidiFile:
    """Parse SMF bytes into a MidiFile (robustness contract in the module
    docstring: corruption -> MidiParseError, never IndexError/struct.error,
    same accept/reject set as the native fast path)."""
    if data[:4] != b"MThd":
        raise MidiParseError("not a MIDI file (missing MThd)")
    if len(data) < 14:
        raise MidiParseError("truncated header")
    header_len = int.from_bytes(data[4:8], "big")
    fmt, ntrks, division = _struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise MidiParseError("SMPTE time division not supported")
    out = MidiFile(ticks_per_quarter=division or 480)
    instruments: Dict[Tuple[int, int, int], Instrument] = {}
    pos = 8 + header_len
    track_idx = 0
    while pos + 8 <= len(data) and track_idx < ntrks:
        if data[pos:pos + 4] != b"MTrk":
            chunk_len = int.from_bytes(data[pos + 4:pos + 8], "big")
            pos += 8 + chunk_len                # skip alien chunk
            continue
        chunk_len = int.from_bytes(data[pos + 4:pos + 8], "big")
        chunk = data[pos + 8:pos + 8 + chunk_len]
        collector = _EventCollector(track_idx, out, instruments)
        _parse_track(chunk, collector)
        collector.finish()
        pos += 8 + chunk_len
        track_idx += 1
    out.instruments = [ins for ins in instruments.values() if ins.notes]
    for ins in out.instruments:
        ins.notes.sort(key=lambda n: (n.start, n.pitch))
    # events may span tracks: sort by tick (stable — ties keep track-parse
    # order), THEN take the headline tempo from the earliest event so bpm
    # always agrees with tempo_map[0] / tick_to_seconds at tick 0
    out.tempo_map.sort(key=lambda e: e[0])
    if out.tempo_map:
        out.tempo_us_per_quarter = out.tempo_map[0][1]
    return out


def load(path: str) -> MidiFile:
    with open(path, "rb") as f:
        return loads(f.read())


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _varint(value: int) -> bytes:
    buf = [value & 0x7F]
    value >>= 7
    while value:
        buf.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(buf))


def _track_chunk(events: bytes) -> bytes:
    events += b"\x00\xff\x2f\x00"               # end-of-track
    return b"MTrk" + len(events).to_bytes(4, "big") + events


def _instrument_track(ins: Instrument, channel: int) -> bytes:
    """One SMF track for an instrument on a dedicated (channel, program)."""
    # (tick, order, bytes) — offs before ons at the same tick (order 0 < 1)
    events: List[Tuple[int, int, bytes]] = []
    events.append((0, 0, bytes([0xC0 | channel, ins.program & 0x7F])))
    for n in ins.notes:
        events.append((n.start, 1, bytes(
            [0x90 | channel, n.pitch & 0x7F, max(1, min(127, n.velocity))])))
        events.append((n.end, 0, bytes([0x80 | channel, n.pitch & 0x7F, 0])))
    events.sort(key=lambda e: (e[0], e[1]))
    buf = bytearray()
    last_tick = 0
    for tick, _, ev in events:
        buf += _varint(tick - last_tick) + ev
        last_tick = tick
    return _track_chunk(bytes(buf))


def _overflow_track(instruments: List[Instrument], channel: int) -> bytes:
    """Instruments whose programs exceed the 15 melodic channels share ONE
    channel in ONE track, with a program-change interleaved immediately
    before every note-on whose program differs from the channel's current
    program — programs are always correct at note ONSET (a note still
    sounding across a change inherits the new timbre; inherent single-port
    MIDI limitation). One track keeps the event order deterministic, and the
    reader's per-channel program tracking re-splits the notes into their
    original (program) instruments on round-trip."""
    # (tick, order, program, payload) — offs(0) before ons(1) at equal ticks
    events: List[Tuple[int, int, int, bytes]] = []
    for ins in instruments:
        prog = ins.program & 0x7F
        for n in ins.notes:
            events.append((n.start, 1, prog, bytes(
                [0x90 | channel, n.pitch & 0x7F,
                 max(1, min(127, n.velocity))])))
            events.append((n.end, 0, prog, bytes(
                [0x80 | channel, n.pitch & 0x7F, 0])))
    events.sort(key=lambda e: (e[0], e[1], e[2]))
    buf = bytearray()
    last_tick = 0
    current = -1
    for tick, order, prog, ev in events:
        if order == 1 and prog != current:
            buf += _varint(tick - last_tick) + bytes([0xC0 | channel, prog])
            last_tick = tick
            current = prog
        buf += _varint(tick - last_tick) + ev
        last_tick = tick
    return _track_chunk(bytes(buf))


def dumps(mid: MidiFile) -> bytes:
    """Serialize to a format-1 SMF: tempo track + instrument tracks.

    Channel allocation: drums share channel 9 (GM convention); melodic
    instruments get one channel PER DISTINCT PROGRAM (instruments with equal
    programs can safely share a channel — channel state agrees). When more
    than 15 distinct melodic programs exist (Lakh-scale re-emission), the
    first 14 keep dedicated channels and the rest share the last channel via
    a merged track with interleaved program changes (_overflow_track) — no
    instrument is ever silently emitted with a wrong program."""
    tempo = b"\x00\xff\x51\x03" + mid.tempo_us_per_quarter.to_bytes(3, "big")
    chunks = [_track_chunk(tempo)]

    melodic_channels = [c for c in range(16) if c != 9]
    melodic = [ins for ins in mid.instruments if not ins.is_drum]
    programs: List[int] = []
    for ins in melodic:
        if (ins.program & 0x7F) not in programs:
            programs.append(ins.program & 0x7F)
    if len(programs) <= len(melodic_channels):
        chan_of = {p: melodic_channels[i] for i, p in enumerate(programs)}
        overflow_chan = None
    else:
        dedicated = programs[:len(melodic_channels) - 1]
        chan_of = {p: melodic_channels[i] for i, p in enumerate(dedicated)}
        overflow_chan = melodic_channels[-1]

    overflow: List[Instrument] = []
    for ins in mid.instruments:
        if ins.is_drum:
            chunks.append(_instrument_track(ins, 9))
        elif (ins.program & 0x7F) in chan_of:
            chunks.append(_instrument_track(ins, chan_of[ins.program & 0x7F]))
        else:
            overflow.append(ins)
    if overflow:
        chunks.append(_overflow_track(overflow, overflow_chan))

    header = (b"MThd" + (6).to_bytes(4, "big")
              + _struct.pack(">HHH", 1, len(chunks), mid.ticks_per_quarter))
    return header + b"".join(chunks)


def save(mid: MidiFile, path: str) -> None:
    with open(path, "wb") as f:
        f.write(dumps(mid))
