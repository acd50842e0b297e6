"""Step and kernel timers — the timing half of
multinn_tpu/utils/profiling.py.

PyTorch returns from a CUDA call before the card has run it, so every timer
here waits for the card: ``force`` synchronizes each device the results
live on, and the device timers read CUDA events. Named trace regions and
whole-program traces are the Trainer's ``profile_steps`` (torch.profiler).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

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


class StepTimer:
    """Wall-clock timer for steps. ``lap`` waits for the given results
    (:func:`force`) so device time is counted. Keeps a mean excluding the
    first lap (the warm-up: kernel builds, graph captures, allocator
    growth)."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def lap(self, *block_on) -> float:
        for x in block_on:
            force(x)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self._t0 = time.perf_counter()
        return dt

    @property
    def mean(self) -> float:
        xs = self.times[1:] if len(self.times) > 1 else self.times
        return sum(xs) / max(len(xs), 1)

    def rate(self, units_per_step: float) -> float:
        return units_per_step / self.mean if self.mean else float("inf")


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
