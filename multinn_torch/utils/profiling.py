"""Spans, step and kernel timers — the port of
multinn_tpu/utils/profiling.py (``annotate`` and the timers).

The span recorder is the port of ``annotate``: named regions of the host's
work, kept by the program itself. It is off by default; ``enable()`` turns
it on and ``collect()`` hands back what it kept and turns it off. Beside
the spans it keeps integer totals (``count``, read by ``counts()``). Each
span holds its name, its start and end on ``time.time_ns()``, an
identifier (what it is about: the service's batch index, the trainer's
group count) and its parent's identifier. Spans open in any thread; a
span nested in another on the same thread takes the enclosing one's
identifier unless given one, and that identifier as its parent. While
``torch.profiler`` records the calling thread, a span also opens a
``record_function`` of its name, so it shows in the profiler's trace (the
profiler records no region opened in another thread). A card interval
(``card_span``) is the time between two timing CUDA events, put on the
same clock through anchors: an event recorded on a stream of the
recorder's own, which nothing else holds up, and synchronised, its host
time the middle of ``time.time_ns()`` read before the record and after
the synchronisation. One anchor is taken at ``enable()``, another by a
``card_span`` once the last is ``ANCHOR_EVERY_NS`` old, and one at
``collect()``; an event's host time is interpolated between the anchors
on either side of it. One anchor would not do: the host's clock is
slewed against the card's (on H100 hosts by 166–530 µs a second, for
seconds at a time), and the card's intervals have to stay on the clock
of the host's spans. The profiler's device timestamps are not slewed, so
over such a stretch they part from both by up to a few ms. Off, a span
costs one attribute test: no clock read, no event, no allocation. The
program times the card through ``card_interval``, which makes its timing
events only while ``card_timing(device)`` holds: the recorder is on and
anchored on that card. An interval opened inside another on the same
thread times the outer one's stream under its identifier, so a layer
below the one that owns the stream (the model's DBN decode inside the
service's batch) needs to be told nothing.

PyTorch returns from a CUDA call before the card has run it, so every timer
here waits for the card: ``force`` synchronizes each device the results
live on, and the device timers read CUDA events. Whole-program traces are
the Trainer's ``profile_steps`` (torch.profiler).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch


def _tensors(tree):
    """The tensors of a tree of tensors, tuples, lists, dicts and
    dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def force(out) -> None:
    """Block until every tensor in ``out`` has completed on its device: one
    synchronize per CUDA device the tree touches (all of the device's
    streams). CPU tensors are complete when the call returns, so a tree
    without CUDA tensors costs nothing."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Span(NamedTuple):
    """One recorded span: ``start_ns`` and ``end_ns`` on ``time.time_ns()``;
    ``thread`` is the name of the thread that recorded it, or ``"card"``
    for an interval between two CUDA events."""
    name: str
    start_ns: int
    end_ns: int
    ident: Optional[int]
    parent: Optional[int]
    thread: str


class _Recorder:
    """The process-wide span recorder (module docstring)."""

    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._counts: Dict[str, int] = {}
        self._cards: list = []           # (name, start, end, ident, parent)
        self._anchors: list = []         # (CUDA event, time.time_ns())
        self._stream = None              # the anchors' stream
        self._device: Optional[torch.device] = None     # the anchors' card
        self._local = threading.local()

    def stack(self) -> list:
        """The identifiers of the spans open on the calling thread."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)


recorder = _Recorder()
_OFF = contextlib.nullcontext()
ANCHOR_EVERY_NS = 50_000_000


def _card(device) -> Optional[torch.device]:
    """``device`` as a CUDA device with its index, or None off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _anchor(stream) -> tuple:
    """An event on ``stream`` (idle) and its time on the host clock."""
    ev = torch.cuda.Event(enable_timing=True)
    t0 = time.time_ns()
    ev.record(stream)
    ev.synchronize()
    return ev, (t0 + time.time_ns()) // 2


def enable(device=None) -> None:
    """Turn the recorder on, dropping anything kept before. Where
    ``device`` is a CUDA device (the current one when None and CUDA is
    available), take the first anchor of its card intervals there; on any
    other device the recorder keeps host spans only."""
    stream, anchors, card = None, [], None
    if device is None and torch.cuda.is_available():
        device = torch.cuda.current_device()
    if device is not None:
        card = _card(device)
    if card is not None:
        stream = torch.cuda.Stream(card)
        anchors.append(_anchor(stream))
    with recorder._lock:
        recorder._spans, recorder._cards = [], []
        recorder._counts = {}
        recorder._anchors, recorder._stream = anchors, stream
        recorder._device = card
        recorder.on = True


def card_timing(device) -> bool:
    """Whether card intervals on ``device`` are recorded: the recorder is
    on and anchored on that card. Code that makes timing events for a
    ``card_span`` asks this first."""
    return (recorder.on and recorder._device is not None
            and _card(device) == recorder._device)


def _on_host(ev, anchors, at) -> int:
    """``ev``'s time on the host clock: interpolated between the anchors
    before and after it (``at``: each anchor's ms from the first)."""
    i = max(bisect.bisect_right(at, anchors[0][0].elapsed_time(ev)) - 1, 0)
    a, t = anchors[i]
    if i + 1 == len(anchors):
        return t + round(a.elapsed_time(ev) * 1e6)
    b, u = anchors[i + 1]
    return t + round(a.elapsed_time(ev) / a.elapsed_time(b) * (u - t))


def collect() -> List[Span]:
    """Turn the recorder off and return every span kept since ``enable()``,
    card intervals included, by start. Waits for the end event of each
    card interval."""
    with recorder._lock:
        recorder.on = False
        spans, cards = recorder._spans, recorder._cards
        recorder._spans, recorder._cards = [], []
        anchors, stream = recorder._anchors, recorder._stream
    for card in cards:
        card[2].synchronize()
    if cards and stream is not None:
        anchors.append(_anchor(stream))
    at = [anchors[0][0].elapsed_time(a) for a, _ in anchors]
    for name, start, end, ident, parent in cards:
        spans.append(Span(name, _on_host(start, anchors, at),
                          _on_host(end, anchors, at), ident, parent,
                          "card"))
    return sorted(spans, key=lambda s: s.start_ns)


class _Open:
    __slots__ = ("name", "ident", "parent", "start", "region")

    def __init__(self, name, ident):
        self.name, self.ident = name, ident

    def __enter__(self):
        stack = recorder.stack()
        self.parent = stack[-1] if stack else None
        if self.ident is None:
            self.ident = self.parent
        stack.append(self.ident)
        self.region = None
        if torch.autograd._profiler_enabled():    # on this thread
            self.region = torch.autograd.profiler.record_function(self.name)
            self.region.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.region is not None:
            self.region.__exit__(*exc)
        recorder.stack().pop()
        recorder.add(Span(self.name, self.start, end, self.ident,
                          self.parent, threading.current_thread().name))
        return False


def span(name: str, ident: Optional[int] = None):
    """A context manager that records the region it encloses as the span
    ``name`` while the recorder is on (module docstring for ``ident`` and
    the parent); a shared no-op while it is off."""
    if not recorder.on:
        return _OFF
    return _Open(name, ident)


def record(name: str, start_ns: int, end_ns: int,
           ident: Optional[int] = None) -> None:
    """Record the span ``name`` from times already read on
    ``time.time_ns()``'s clock (nothing while the recorder is off); its
    parent is the span open on the calling thread, if any."""
    if recorder.on:
        stack = recorder.stack()
        recorder.add(Span(name, int(start_ns), int(end_ns), ident,
                          stack[-1] if stack else None,
                          threading.current_thread().name))


def count(name: str, value: int) -> None:
    """Add ``value`` to the integer total ``name`` while the recorder is on
    (nothing while it is off)."""
    if recorder.on:
        with recorder._lock:
            recorder._counts[name] = recorder._counts.get(name, 0) + int(value)


def counts() -> Dict[str, int]:
    """The totals that ``count`` kept since ``enable()`` (``collect()``
    leaves them)."""
    with recorder._lock:
        return dict(recorder._counts)


def card_span(name: str, start: "torch.cuda.Event", end: "torch.cuda.Event",
              ident: Optional[int] = None) -> None:
    """Record the card's interval from the timing event ``start`` to
    ``end``, both recorded on the card the recorder is anchored on
    (``card_timing``), as the span ``name``; ``collect()`` puts it on the
    host clock. Inside an open span it takes that span as its parent, and
    its identifier unless given one. Nothing is kept while the recorder
    is off or has no anchor: an interval is dropped, never an error. Takes
    a new anchor when the last is ``ANCHOR_EVERY_NS`` old (a
    synchronisation with an idle stream: some µs)."""
    if not recorder.on:
        return
    stack = recorder.stack()
    parent = stack[-1] if stack else None
    with recorder._lock:
        if not recorder._anchors:
            return
        recorder._cards.append((name, start, end,
                                parent if ident is None else ident, parent))
        stream = recorder._stream
        due = (stream is not None and time.time_ns()
               - recorder._anchors[-1][1] >= ANCHOR_EVERY_NS)
    if due:
        anchor = _anchor(stream)
        with recorder._lock:
            recorder._anchors.append(anchor)


class _CardInterval:
    __slots__ = ("name", "ident", "stream", "start", "outer")

    def __init__(self, name, ident, stream):
        self.name, self.ident, self.stream = name, ident, stream

    def __enter__(self):
        self.outer = getattr(recorder._local, "card", None)
        recorder._local.card = (self.stream, self.ident)
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)
        return self

    def __exit__(self, exc_type, *exc):
        recorder._local.card = self.outer
        if exc_type is None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            card_span(self.name, self.start, end, self.ident)
        return False


def card_interval(name: str, ident: Optional[int] = None, stream=None):
    """A context manager that records the card's interval over the work
    its block enqueues on the CUDA ``stream``, between timing events
    recorded there before and after it, as the span ``name``
    (``card_span``, with ``ident``) while ``card_timing`` holds for the
    stream's device. Opened inside another card interval on the same
    thread it takes that one's stream and identifier; without a stream it
    records only there. Otherwise a shared no-op that makes no events. A
    block that raises records nothing."""
    if not recorder.on:
        return _OFF
    outer = getattr(recorder._local, "card", None)
    if outer is not None:
        stream, ident = outer
    elif stream is None or not card_timing(stream.device):
        return _OFF
    return _CardInterval(name, ident, stream)


def _cuda_device(*trees) -> Optional[torch.device]:
    for tree in trees:
        for t in _tensors(tree):
            if t.is_cuda:
                return t.device
    return None


def timeit(fn, *args, iters: int = 10, warmup: int = 2) -> Dict[str, float]:
    """Mean and min seconds per call of ``fn(*args)`` after ``warmup``
    calls. Where the arguments or the result hold CUDA tensors each call
    is timed by CUDA events on the current stream, the end event waited
    for; otherwise by ``perf_counter`` around the call."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    force(out)
    dev = _cuda_device(args, out)
    times = []
    for _ in range(iters):
        if dev is None:
            t0 = time.perf_counter()
            out = fn(*args)
            times.append(time.perf_counter() - t0)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return {"mean_s": sum(times) / len(times), "min_s": min(times),
            "iters": iters}


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs (after one warm
    run unless ``warm`` is False), by CUDA events on the current stream."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph after a warm call, its replay timed by CUDA events, so
    no host time between launches enters."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps
