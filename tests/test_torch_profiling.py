"""multinn_torch.utils.profiling on the CPU, as tests/test_profiling.py
pins the JAX package's: ``force`` accepts any tree and leaves its values
as they were, ``timeit`` returns positive times; the span recorder (the
port of ``annotate``): off it reads no clock, makes no event and opens no
profiler region; on it keeps names, identifiers, parents and nesting on
``time.time_ns()``, puts card intervals on that clock through its anchors
(and drops one it has no anchor for), times a card only where it is
anchored on it, records a ``card_interval`` only there, an inner one
under the outer one's stream and identifier, and opens a
``record_function`` only on a thread the profiler records.
The CUDA-event paths run in tests/test_torch_cuda.py."""

import dataclasses
import itertools
import json
import threading
import time

import numpy as np
import pytest
import torch

from multinn_torch.utils import profiling
from multinn_torch.utils.profiling import force, timeit


@dataclasses.dataclass
class _State:
    h: torch.Tensor
    rest: tuple


def test_force_accepts_any_tree():
    force(None)
    force({})
    force(torch.tensor(1.5))
    force((torch.zeros(3), {"a": torch.ones(100, 7),
                            "b": [torch.arange(4)]}))
    force(_State(h=torch.ones(2), rest=(None, [torch.zeros(1)])))
    # numpy leaves (already on the host) pass through
    force({"x": np.ones(5)})


def test_force_does_not_mutate_result():
    x = torch.eye(8)
    out = (x @ x, x.sum())
    force(out)
    assert float(out[1]) == 8.0
    np.testing.assert_allclose(out[0].numpy(), np.eye(8))


def test_timeit_returns_positive_times():
    r = timeit(lambda x: x @ x, torch.eye(16), iters=3, warmup=1)
    assert r["iters"] == 3
    assert 0 < r["min_s"] <= r["mean_s"]


@pytest.fixture
def recorder_off():
    """The recorder left off, and emptied, after the test."""
    yield profiling.recorder
    profiling.collect()


def test_recorder_off_reads_no_clock_and_makes_nothing(monkeypatch,
                                                       recorder_off):
    calls = []
    monkeypatch.setattr(profiling.time, "time_ns",
                        lambda: calls.append("clock") or 0)
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: calls.append("event"))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **k: calls.append("region"))
    assert not profiling.recorder.on
    first = profiling.span("a", 1)
    with first:
        inner = profiling.span("b")
        assert inner is first               # one shared no-op, no object
        with inner:
            pass
    profiling.record("c", 1, 2, 3)
    profiling.card_span("d", None, None, 4)
    assert calls == []
    assert profiling.collect() == []


def test_spans_keep_name_ident_parent_and_nesting(recorder_off):
    profiling.enable()
    t0 = time.time_ns()
    with profiling.span("outer", 7):
        with profiling.span("inner"):
            time.sleep(0.002)
        with profiling.span("other", 9):
            pass
        profiling.record("given", t0 - 5, t0 - 1, 3)
    with profiling.span("alone"):
        pass
    profiling.record("loose", t0 - 3, t0 - 2)
    t1 = time.time_ns()
    spans = profiling.collect()
    assert not profiling.recorder.on
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["given", "loose", "outer", "inner",
                                       "other", "alone"]
    assert (by["outer"].ident, by["outer"].parent) == (7, None)
    assert (by["inner"].ident, by["inner"].parent) == (7, 7)
    assert (by["other"].ident, by["other"].parent) == (9, 7)
    assert (by["alone"].ident, by["alone"].parent) == (None, None)
    assert by["given"][1:5] == (t0 - 5, t0 - 1, 3, 7)  # parent: nesting
    assert by["loose"][1:5] == (t0 - 3, t0 - 2, None, None)
    for name in ("inner", "other"):                 # nested in time too
        assert by["outer"].start_ns <= by[name].start_ns
        assert by[name].end_ns <= by["outer"].end_ns
    assert by["inner"].end_ns - by["inner"].start_ns >= 2_000_000
    assert by["inner"].end_ns <= by["other"].start_ns
    assert t0 <= by["outer"].start_ns and by["alone"].end_ns <= t1
    assert {s.thread for s in spans} == {threading.current_thread().name}
    assert profiling.collect() == []                # collect empties


def test_counts_sum_only_while_the_recorder_is_on(recorder_off):
    """``count`` keeps nothing while the recorder is off, sums per name
    while it is on (from any thread), ``counts()`` hands the totals back
    and ``collect()`` leaves them; the spans are the same with or without
    counts beside them; ``enable()`` starts the totals anew."""
    profiling.count("n", 5)
    assert profiling.counts() == {}
    profiling.enable(device="cpu")
    with profiling.span("batch", 1):
        profiling.count("n", 2)
        profiling.count("m", 0)
    worker = threading.Thread(target=profiling.count, args=("n", 40))
    worker.start()
    worker.join()
    profiling.count("n", np.int64(3))
    with_counts = profiling.collect()
    assert profiling.counts() == {"n": 45, "m": 0}
    assert all(type(v) is int for v in profiling.counts().values())
    profiling.count("n", 7)                          # off again
    assert profiling.counts() == {"n": 45, "m": 0}
    profiling.enable(device="cpu")
    assert profiling.counts() == {}
    with profiling.span("batch", 1):
        pass
    without = profiling.collect()
    assert [s[:1] + s[3:] for s in with_counts] == \
        [s[:1] + s[3:] for s in without] == [("batch", 1, None, "MainThread")]


def test_spans_of_threads_nest_per_thread(recorder_off):
    profiling.enable()
    gate = threading.Barrier(2, timeout=10)

    def work(i):
        with profiling.span("batch", i):
            gate.wait()                      # both open at once
            with profiling.span("step"):
                pass

    threads = [threading.Thread(target=work, args=(i,), name=f"w{i}")
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    spans = profiling.collect()
    steps = {s.thread: s for s in spans if s.name == "step"}
    assert {t: (s.ident, s.parent) for t, s in steps.items()} == {
        "w0": (0, 0), "w1": (1, 1)}


class _FakeEvent:
    """A timing event at ``ms`` on the card's clock."""

    def __init__(self, ms):
        self.ms = ms
        self.waited = False

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_card_intervals_go_on_the_host_clock_through_the_anchors(
        recorder_off):
    """An event's host time is interpolated between the anchors on either
    side of it (here the host clock runs 0.1 % fast against the card's)
    and carried on at the card's rate past the last one."""
    profiling.enable()
    t0 = 1_700_000_000_000_000_000
    profiling.recorder._anchors = [(_FakeEvent(10.0), t0),
                                   (_FakeEvent(20.0), t0 + 10_010_000)]
    start, end = _FakeEvent(12.5), _FakeEvent(15.0)
    with profiling.span("group", 4):
        profiling.card_span("card", start, end)
    with profiling.span("step", 6):
        profiling.card_span("late", _FakeEvent(21.0), _FakeEvent(22.0), 8)
    profiling.card_span("early", _FakeEvent(9.0), _FakeEvent(10.0), 9)
    spans = {s.name: s for s in profiling.collect() if s.thread == "card"}
    assert end.waited
    assert spans["card"] == profiling.Span(
        "card", t0 + 2_502_500, t0 + 5_005_000, 4, 4, "card")
    assert spans["late"][1:5] == (t0 + 11_010_000, t0 + 12_010_000, 8, 6)
    assert spans["early"][1:3] == (t0 - 1_001_000, t0)


def test_card_span_needs_an_anchor(recorder_off):
    """Without an anchor (the recorder enabled off the card) an interval
    is dropped, not raised: a span never fails the work it times."""
    profiling.enable(device="cpu")
    assert profiling.recorder.on and not profiling.recorder._anchors
    with profiling.span("batch", 1):
        profiling.card_span("card", _FakeEvent(0), _FakeEvent(1))
    assert [s.name for s in profiling.collect()] == ["batch"]


@pytest.mark.parametrize("anchored,asked,timed", [
    (None, "cpu", False), (None, "cuda:0", False),
    ("cuda:0", "cuda:0", True), ("cuda:0", "cuda:1", False),
    ("cuda:1", "cpu", False)])
def test_card_timing_only_on_the_anchored_card(recorder_off, anchored,
                                               asked, timed):
    assert not profiling.card_timing(asked)          # off
    profiling.enable(device="cpu")
    if anchored is not None:                 # as enable() on that card
        profiling.recorder._device = torch.device(anchored)
        profiling.recorder._anchors = [(_FakeEvent(0.0), time.time_ns())]
    assert profiling.card_timing(asked) is timed
    profiling.collect()
    assert not profiling.card_timing(asked)


class _Stream:
    """A stand-in for a CUDA stream on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)


class _Event(_FakeEvent):
    """A timing event that takes the next ms of a counter, and keeps the
    stream it was recorded on; every one made is in ``made``."""
    made = []
    tick = itertools.count(1)

    def __init__(self, enable_timing=False):
        super().__init__(None)
        self.stream = None
        _Event.made.append(self)

    def record(self, stream=None):
        self.ms, self.stream = float(next(self.tick)), stream


@pytest.fixture
def card_events(monkeypatch, recorder_off):
    """torch.cuda.Event replaced by ``_Event``, none made yet."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    _Event.made = []
    return _Event.made


def _anchor_on(device):
    """The recorder on, anchored on ``device`` as enable() there would."""
    profiling.enable(device="cpu")
    profiling.recorder._device = torch.device(device)
    profiling.recorder._anchors = [(_FakeEvent(0.0), time.time_ns())]


@pytest.mark.parametrize("state", ["off", "unanchored", "other_card",
                                   "no_stream"])
def test_card_interval_records_nothing_unless_timed(card_events, state):
    """Off, enabled off the card, anchored on another card than the
    stream's, or without a stream and outside another interval: the block
    runs, and no event is made and no span kept."""
    if state == "unanchored":
        profiling.enable(device="cpu")
    elif state in ("other_card", "no_stream"):
        _anchor_on("cuda:1" if state == "other_card" else "cuda:0")
    stream = None if state == "no_stream" else _Stream("cuda:0")
    ran = []
    with profiling.card_interval("serve.card", 3, stream):
        ran.append(1)
    assert ran == [1] and card_events == []
    assert profiling.collect() == []


def test_card_interval_records_its_block_on_its_stream(card_events):
    """Timed, an interval keeps the span of its name and identifier
    between an event recorded on its stream before the block and one
    after it; a block that raises keeps nothing."""
    _anchor_on("cuda:0")
    stream = _Stream("cuda:0")
    with profiling.card_interval("serve.card", 7, stream):
        inside = len(card_events)
    with pytest.raises(ValueError):
        with profiling.card_interval("serve.card", 8, stream):
            raise ValueError
    spans = profiling.collect()
    assert [(s.name, s.ident, s.parent, s.thread) for s in spans] == [
        ("serve.card", 7, None, "card")]
    assert inside == 1 and spans[0].start_ns < spans[0].end_ns
    assert all(e.stream is stream for e in card_events)


def test_inner_card_interval_takes_the_outer_ones_stream_and_ident(
        card_events):
    """An interval opened inside another on the same thread records on the
    outer one's stream under its identifier, whatever it was given; on
    another thread, or once the outer one has closed, one without a
    stream records nothing."""
    _anchor_on("cuda:0")
    outer = _Stream("cuda:0")

    def alone():
        with profiling.card_interval("gen.dbn_decode"):
            pass
    with profiling.card_interval("serve.card", 4, outer):
        with profiling.card_interval("gen.dbn_decode"):
            pass
        with profiling.card_interval("gen.other", 9, _Stream("cuda:0")):
            pass
        worker = threading.Thread(target=alone)
        worker.start()
        worker.join(10)
    alone()
    spans = profiling.collect()
    assert sorted((s.name, s.ident) for s in spans) == [
        ("gen.dbn_decode", 4), ("gen.other", 4), ("serve.card", 4)]
    by = {s.name: s for s in spans}
    assert (by["serve.card"].start_ns <= by["gen.dbn_decode"].start_ns
            < by["gen.dbn_decode"].end_ns <= by["gen.other"].start_ns
            < by["gen.other"].end_ns <= by["serve.card"].end_ns)
    assert len(card_events) == 6
    assert all(e.stream is outer for e in card_events)


def test_spans_show_in_the_profiler_trace_of_their_thread(tmp_path,
                                                          recorder_off):
    from torch.profiler import ProfilerActivity, profile
    profiling.enable()
    out = {}

    def other():
        out["on"] = torch.autograd._profiler_enabled()
        with profiling.span("elsewhere", 2):
            torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("here", 1):
            torch.ones(4).sum()
        t = threading.Thread(target=other)
        t.start()
        t.join(10)
    assert not t.is_alive() and out["on"] is False
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "here" in names and "elsewhere" not in names
    spans = {s.name: s for s in profiling.collect()}
    assert set(spans) == {"here", "elsewhere"}    # both recorded all the same
