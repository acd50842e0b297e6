"""The device trace of a ``--trace 1`` run and the benchmark's own host
spans.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activities) over a
stretch of the run, marks the measured stretch with the annotation
``WINDOW`` and reads the exported trace back: every device operation
(kernel, copy, fill) with its interval, and the host's operations and
annotations. ``summary`` reduces them to the device's busy seconds (the
union of the operations' intervals inside the window, never their sum),
the time of each kernel by name, and the breakdown the result line
carries: the operations that took the most device time, and the idle
stretches by what the host was doing meanwhile.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
from collections import defaultdict

WINDOW = "portbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
_NAME_CHARS = 120
# idle stretches shorter than this (the spacing of back-to-back launches)
# are summed under one name instead of being matched to a host event
_SHORT_GAP_US = 20.0
_SHORT = "gaps under 20 us between device operations"


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def gaps(busy, start, end):
    """The stretches of [start, end] that merged ``busy`` intervals leave
    uncovered."""
    out, t = [], start
    for a, b in busy:
        if a > t:
            out.append((t, min(a, end)))
        t = max(t, b)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]


def _label(gap, host):
    """The host event that overlaps ``gap`` the longest (the innermost of
    equals)."""
    a, b = gap
    best, best_key = "no traced host operation", (0.0, 0.0)
    for name, s, e in host:
        ov = min(b, e) - max(a, s)
        if ov > 0 and (ov, -(e - s)) > best_key:
            best, best_key = name, (ov, -(e - s))
    return best


def summary(device_ops, host, window, top: int = 10) -> dict:
    """Busy and window seconds, device seconds by operation name inside the
    window (``op_s``), the count and seconds of the operations that lie
    wholly inside it (``op_whole``), and the breakdown: the ``top`` operations by device time and
    the ``top`` host activities by the idle time they overlap. Times in
    microseconds in, seconds out."""
    ws, we = window
    clipped = [(n, max(s, ws), min(e, we)) for n, s, e in device_ops
               if e > ws and s < we]
    busy = union((s, e) for _, s, e in clipped)
    by_name = defaultdict(float)
    whole = defaultdict(lambda: [0, 0.0])      # launches inside the window
    for n, s, e in clipped:
        by_name[n] += (e - s) * 1e-6
    for n, s, e in device_ops:
        if s >= ws and e <= we:
            whole[n][0] += 1
            whole[n][1] += (e - s) * 1e-6
    idle = defaultdict(float)
    inner = [(n, s, e) for n, s, e in host if n != WINDOW]
    for g in gaps(busy, ws, we):
        name = _SHORT if g[1] - g[0] < _SHORT_GAP_US else _label(g, inner)
        idle[name] += (g[1] - g[0]) * 1e-6
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (we - ws) * 1e-6,
        "op_s": dict(by_name),
        "op_whole": {n: tuple(v) for n, v in whole.items()},
        "breakdown": {
            "device_ops": [[n[:_NAME_CHARS], v] for n, v in rank(by_name)],
            "idle_gaps": [[n[:_NAME_CHARS], v] for n, v in rank(idle)],
        },
    }


def read_chrome_trace(path: str):
    """(device operations, host events, window) of an exported trace, each
    event as (name, start, end) in microseconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        item = (ev.get("name", "?"), float(ev["ts"]),
                float(ev["ts"]) + float(ev["dur"]))
        cat = ev.get("cat", "")
        if cat in _DEVICE_CATS:
            dev.append(item)
        elif cat in _HOST_CATS:
            if item[0] == WINDOW:
                window = item[1:]
            host.append(item)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    return dev, host, window


class Tracer:
    """Profiles a stretch of the run when enabled: ``start()`` starts the
    profiler (before a warm-up of the traced work, so that its own start
    falls outside the window); ``with tracer.window(sync):`` marks the
    measured stretch and stops the profiler after ``sync()`` returns, so
    nothing after it is recorded; ``finish()``, called once the run's
    window has closed, reads the trace and keeps ``summary`` of it in
    ``result`` (None when disabled)."""

    def __init__(self, enabled: bool, workdir: str):
        self.enabled = enabled
        self.workdir = workdir
        self.result = None
        self._prof = None
        self._recording = False

    def start(self) -> None:
        if self.enabled and self._prof is None:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
            self._prof.start()
            self._recording = True

    @contextlib.contextmanager
    def window(self, sync):
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function
        self.start()
        try:
            with record_function(WINDOW):
                yield
                sync()
        finally:
            self._prof.stop()
            self._recording = False

    def finish(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        path = os.path.join(self.workdir, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        dev, host, window = read_chrome_trace(path)
        os.remove(path)
        if not dev:
            raise RuntimeError("the profiler recorded no device operation")
        self.result = summary(dev, host, window)

    def close(self) -> None:
        if self._recording:
            self._prof.stop()
        self._prof = None
        shutil.rmtree(self.workdir, ignore_errors=True)
