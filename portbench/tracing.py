"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a span
of the measured window, switched on and off at the boundaries the kinds
tick (a decode step, a train step), and its reduction to device
busy time, device time by kernel name, and the longest idle gaps labelled
by the benchmark's own ``record_function`` ranges.

The profiler is started and stopped in the thread that ticks, which is
the thread that drives the program; device events are recorded whatever
thread launched them.  The span ends in a synchronisation, so all work
launched inside it is inside it.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch

from portbench import yardstick as Y

PREFIX = "portbench."
TRACED = PREFIX + "traced"


def span(name: str):
    """A ``record_function`` range of the benchmark's own (``portbench.``
    and ``name``); it costs nothing while the profiler is off."""
    return torch.autograd.profiler.record_function(PREFIX + name)


class Tracer:
    """Traces from the first :meth:`tick` at or after ``start`` (a
    ``time.monotonic`` reading) to the first tick at or after ``start +
    length``; does nothing where ``enabled`` is false.  ``synced`` is when
    the work before the span had finished, ``began`` and ``ended`` when
    the span began and ended.

    A run places the span at the end of its window: starting the profiler
    and, above all, stopping it (which gathers the events) hold the host
    for seconds, so the spans and counters of a traced run are read over
    the window's part before ``synced``."""

    def __init__(self, enabled: bool, length: float, sync):
        self.enabled = enabled
        self.sync = sync
        self.length = length
        self.start: Optional[float] = None
        self.prof = None
        self._range = None
        self.synced = self.began = self.ended = None
        self._summary = None

    def arm(self, start: float) -> None:
        self.start = start

    @property
    def running(self) -> bool:
        return self._range is not None

    def tick(self) -> None:
        if not self.enabled or self.start is None or self.ended is not None:
            return
        now = time.monotonic()
        if self._range is None and now >= self.start:
            from torch.profiler import ProfilerActivity, profile
            self.sync()
            self.synced = time.monotonic()
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities)
            self.prof.start()
            self._range = torch.autograd.profiler.record_function(TRACED)
            self._range.__enter__()
            self.began = time.monotonic()
        elif self._range is not None:
            if now >= self.began + self.length:
                self.stop()

    def stop(self) -> None:
        if self._range is None:
            return
        self.sync()
        self._range.__exit__(None, None, None)
        self._range = None
        self.ended = time.monotonic()
        self.prof.stop()

    def summary(self) -> Optional["TraceSummary"]:
        """The traced span reduced (None where nothing was traced); made
        once, on the first call after the span ended."""
        if self.prof is None or self._range is not None:
            return None
        if self._summary is None:
            self._summary = TraceSummary(self.prof)
        return self._summary


def _events(prof) -> List[Tuple[str, bool, float, float]]:
    """(name, on the device, start s, end s) of every event, read from the
    profiler's raw results (its Python events take far longer to build)."""
    from torch.autograd import DeviceType
    return [(e.name(), e.device_type() == DeviceType.CUDA,
             e.start_ns() * 1e-9, e.end_ns() * 1e-9)
            for e in prof.profiler.kineto_results.events()]


class TraceSummary:
    """The traced span reduced: ``window_s``, ``busy_s`` (the union of
    device spans inside it), ``kernels`` (device seconds and count by
    name, copies and fills included), and ``breakdown``."""

    def __init__(self, prof):
        events = _events(prof)
        host = [(n, a, b) for n, dev, a, b in events
                if not dev and n.startswith(PREFIX)]
        traced = [(a, b) for n, a, b in host if n == TRACED]
        if not traced:
            raise RuntimeError("the traced range is missing from the trace")
        lo, hi = traced[0]
        device = [(n, a, b) for n, dev, a, b in events
                  if dev and not n.startswith(PREFIX)]
        self.window_s = hi - lo
        self.busy_s, gaps = Y.union_busy([(a, b) for _, a, b in device],
                                         lo, hi)
        self.kernels = Y.kernel_totals(device, lo, hi)
        ranges = [(n[len(PREFIX):], a, b) for n, a, b in host if n != TRACED]

        def label(a, b):
            mid = 0.5 * (a + b)
            inside = [(rb - ra, n) for n, ra, rb in ranges if ra <= mid < rb]
            return min(inside)[1] if inside else "outside the ranges"

        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        self.breakdown = {
            "device_ops": [[n, t] for n, (t, _) in top],
            "idle_gaps": [[label(a, b), b - a] for a, b in gaps[:10]]}
