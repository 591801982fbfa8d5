"""Cross-component monitoring (paper §II-B step 3, §III.1).

The paper: "The framework captures and links comprehensive metrics across all
involved components, particularly the edge data generator, broker, and cloud
processing services ... This data allows the easy identification of
bottlenecks."

We reproduce that with a process-wide :class:`MetricsRegistry`. Every message
carries a unique ``msg_id``; each component stamps events
(``produced`` / ``broker_in`` / ``broker_out`` / ``consumed`` /
``processed``) against that id, so end-to-end latency decomposes into
per-hop latencies exactly like the paper's linked metrics. Counters and
gauges cover throughput and resource accounting (bytes through the broker,
task retries, straggler re-executions).

Thread-safe: producers/consumers/runtimes stamp from their own threads.

Two storage modes:

* **exact** (default) — one :class:`MessageTrace` kept per message for the
  whole run.  Arbitrary spans, exact percentiles, and the mode every
  committed golden was pinned under.  Memory grows linearly with run
  length (the dominant RSS term at 1M+ messages).
* **streaming** (``MetricsRegistry(streaming=True)``) — traces live only
  while a message is *in flight*: when its terminal ``processed`` stamp
  lands (or the bounded pending window evicts it), the trace's per-hop
  and end-to-end spans are folded into fixed-bucket log-spaced latency
  sketches (:class:`LatencySketch`) and the trace is dropped.  Memory is
  O(in-flight + sketch buckets), independent of run length; percentiles
  are bucket-resolution approximations (≲4 % relative error) instead of
  exact order statistics.  Aggregation stays deterministic: sketches are
  a pure function of the folded spans.

Beside the message stamps, a registry times the program's own layers as
nested **spans** (:meth:`MetricsRegistry.span`, on the registry's clock):
a registry is a :class:`repro_torch.spans.SpanTable`, whose leaf module
this one re-exports with :class:`LatencySketch`, :func:`spans_between`,
:data:`RANGE_PREFIX` and :data:`REGISTRY`, the process-wide table the LM
stack records into.
"""
from __future__ import annotations

import math
import statistics
import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.sim.clock import NULL_LOCK, as_clock
from repro_torch.spans import (RANGE_PREFIX, REGISTRY,  # noqa: F401
                               LatencySketch, SpanTable, spans_between)


@dataclass
class MessageTrace:
    """Linked per-message timestamps across components (seconds)."""
    msg_id: str
    stamps: Dict[str, float] = field(default_factory=dict)
    meta: Dict[str, float] = field(default_factory=dict)

    def span(self, start: str, end: str) -> Optional[float]:
        if start in self.stamps and end in self.stamps:
            return self.stamps[end] - self.stamps[start]
        return None


# canonical event names, in pipeline order
EVENTS = ("produced", "broker_in", "broker_out", "consumed", "processed")

# the spans folded into sketches when a trace is retired in streaming
# mode: every consecutive hop plus the end-to-end pair
_SKETCH_SPANS: Tuple[Tuple[str, str], ...] = (
    *zip(EVENTS[:-1], EVENTS[1:]), (EVENTS[0], EVENTS[-1]))


class _EventStats:
    """Running per-event aggregates (streaming mode): stamp count,
    first/last stamp time, and bytes attributed to the event."""

    __slots__ = ("count", "first", "last", "bytes")

    def __init__(self):
        self.count = 0
        self.first = math.inf
        self.last = -math.inf
        self.bytes = 0.0


class MetricsRegistry(SpanTable):
    """Process-wide registry: message traces + counters + gauges.

    One registry per pipeline run; injected into broker/runtime/pipeline so
    all components stamp into the same store (the paper's "unique job
    identifier ensures that progress and errors can be consistently
    tracked").

    ``streaming=True`` decouples registry memory from run length: traces
    are retired into :class:`LatencySketch` aggregates at their
    ``processed`` stamp (or when the ``max_pending`` in-flight window
    evicts them — intermediate-hop messages of multi-stage pipelines
    never see ``processed`` and leave through the window), so only
    in-flight messages occupy memory.  ``summary``/``percentile``/
    ``per_hop_latency``/``throughput``/``first_stamp``/``last_stamp``
    keep working (sketch-backed); the exact per-message ``latencies``/
    ``trace`` views are unavailable and raise.
    """

    def __init__(self, clock=None, *, streaming: bool = False,
                 max_pending: int = 100_000):
        # accepts a Clock object, a bare now() callable (seed API), or None
        self.clock = as_clock(clock)
        super().__init__(self.clock.now)    # the spans' clock, lock, state
        self.streaming = streaming
        self.max_pending = max_pending
        self._traces: Dict[str, MessageTrace] = {}
        self._counters: Dict[str, float] = defaultdict(float)
        self._events: List[dict] = []
        # streaming mode state (untouched in exact mode)
        self._sketches: Dict[Tuple[str, str], LatencySketch] = {}
        self._estats: Dict[str, _EventStats] = {}
        self._retired = 0

    # -- message lifecycle ---------------------------------------------------

    def elide_lock(self, elide: bool = True) -> None:
        """Swap the registry lock for a no-op (``elide=True``) or restore a
        real :class:`threading.Lock`.  Only the single-owner DES path may
        elide: the SimExecutor is the sole thread touching the registry, so
        the lock acquire/release per stamp (5 stamps/message) is pure
        overhead there."""
        self._lock = NULL_LOCK if elide else threading.Lock()

    def stamp(self, msg_id: str, event: str, *,
              t: Optional[float] = None, **meta) -> float:
        """Stamp ``event`` on ``msg_id`` at the clock's current time, or at
        an explicit ``t`` (used by sharded runs to re-stamp a boundary
        message at its original production time in the receiving shard)."""
        if t is None:
            t = self._clock()
        with self._lock:
            tr = self._traces.setdefault(msg_id, MessageTrace(msg_id))
            if self.streaming and event not in tr.stamps:
                es = self._estats.get(event)
                if es is None:
                    self._estats[event] = es = _EventStats()
                es.count += 1
                if t < es.first:
                    es.first = t
                if t > es.last:
                    es.last = t
                es.bytes += meta.get("bytes", 0.0)
            tr.stamps[event] = t
            tr.meta.update(meta)
            if self.streaming:
                if event == EVENTS[-1]:
                    self._retire(self._traces.pop(msg_id))
                elif len(self._traces) > self.max_pending:
                    # FIFO window: retire the oldest in-flight trace with
                    # whatever spans it has (dicts are insertion-ordered)
                    oldest = next(iter(self._traces))
                    self._retire(self._traces.pop(oldest))
        return t

    def _retire(self, tr: MessageTrace) -> None:
        """Fold a finished (or window-evicted) trace's spans into the
        sketches and let the trace go.  Caller holds the lock."""
        self._retired += 1
        stamps = tr.stamps
        for a, b in _SKETCH_SPANS:
            ta = stamps.get(a)
            if ta is None:
                continue
            tb = stamps.get(b)
            if tb is None:
                continue
            sk = self._sketches.get((a, b))
            if sk is None:
                self._sketches[(a, b)] = sk = LatencySketch()
            sk.add(tb - ta)

    def trace(self, msg_id: str) -> Optional[MessageTrace]:
        with self._lock:
            return self._traces.get(msg_id)

    # -- counters / events ----------------------------------------------------

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def event(self, kind: str, **data) -> None:
        with self._lock:
            self._events.append({"kind": kind, "t": self._clock(), **data})

    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            if kind is None:
                return list(self._events)
            return [e for e in self._events if e["kind"] == kind]

    # -- aggregation (the paper's Fig 2/3 metrics) ----------------------------

    def latencies(self, start: str = "produced",
                  end: str = "processed") -> List[float]:
        if self.streaming:
            raise RuntimeError(
                "MetricsRegistry(streaming=True) does not keep per-message "
                "latencies; use summary()/percentile()/per_hop_latency()")
        with self._lock:
            out = []
            for tr in self._traces.values():
                s = tr.span(start, end)
                if s is not None:
                    out.append(s)
            return out

    def _sketch(self, start: str, end: str) -> Optional[LatencySketch]:
        """Streaming-mode sketch for a span, or None if never observed.
        Only the spans in ``_SKETCH_SPANS`` are retained."""
        with self._lock:
            return self._sketches.get((start, end))

    def percentile(self, q: float, start: str = "produced",
                   end: str = "processed") -> float:
        """``q``-quantile of the span latency, in either mode.

        Exact order statistic in exact mode; bucket-edge estimate in
        streaming mode (the two agree to within the sketch's ~3.7 %
        bucket width)."""
        if self.streaming:
            sk = self._sketch(start, end)
            return sk.percentile(q) if sk is not None else 0.0
        lat = sorted(self.latencies(start, end))
        if not lat:
            return 0.0
        return lat[min(len(lat) - 1, int(q * len(lat)))]

    def summary(self, start: str = "produced",
                end: str = "processed") -> Dict[str, float]:
        if self.streaming:
            sk = self._sketch(start, end)
            if sk is None or sk.count == 0:
                return {"count": 0}
            return {
                "count": sk.count,
                "mean_s": sk.mean,
                "p50_s": sk.percentile(0.50),
                "p95_s": sk.percentile(0.95),
                "max_s": sk.max,
            }
        lat = self.latencies(start, end)
        if not lat:
            return {"count": 0}
        lat.sort()
        n = len(lat)
        return {
            "count": n,
            "mean_s": statistics.fmean(lat),
            "p50_s": lat[n // 2],
            "p95_s": lat[min(n - 1, int(0.95 * n))],
            "max_s": lat[-1],
        }

    def first_stamp(self, event: str) -> Optional[float]:
        """Earliest timestamp of ``event`` across all traces."""
        with self._lock:
            if self.streaming:
                es = self._estats.get(event)
                return es.first if es is not None else None
            ts = [tr.stamps[event] for tr in self._traces.values()
                  if event in tr.stamps]
        return min(ts) if ts else None

    def last_stamp(self, event: str) -> Optional[float]:
        """Latest timestamp of ``event`` across all traces."""
        with self._lock:
            if self.streaming:
                es = self._estats.get(event)
                return es.last if es is not None else None
            ts = [tr.stamps[event] for tr in self._traces.values()
                  if event in tr.stamps]
        return max(ts) if ts else None

    def event_count(self, event: str) -> int:
        """Number of distinct messages stamped with ``event`` (both modes)."""
        with self._lock:
            if self.streaming:
                es = self._estats.get(event)
                return es.count if es is not None else 0
            return sum(1 for tr in self._traces.values()
                       if event in tr.stamps)

    def throughput(self, event: str = "processed") -> Dict[str, float]:
        """Messages/s and bytes/s over the observed window of ``event``."""
        with self._lock:
            if self.streaming:
                es = self._estats.get(event)
                if es is None or es.count < 2:
                    n = es.count if es is not None else 0
                    return {"msgs_per_s": 0.0, "bytes_per_s": 0.0,
                            "count": n}
                dt = max(es.last - es.first, 1e-9)
                return {"msgs_per_s": es.count / dt,
                        "bytes_per_s": es.bytes / dt, "count": es.count}
            ts = [tr.stamps[event] for tr in self._traces.values()
                  if event in tr.stamps]
            nbytes = sum(tr.meta.get("bytes", 0.0)
                         for tr in self._traces.values()
                         if event in tr.stamps)
        if len(ts) < 2:
            return {"msgs_per_s": 0.0, "bytes_per_s": 0.0, "count": len(ts)}
        dt = max(max(ts) - min(ts), 1e-9)
        return {"msgs_per_s": len(ts) / dt, "bytes_per_s": nbytes / dt,
                "count": len(ts)}

    def per_hop_latency(self) -> Dict[str, Dict[str, float]]:
        """Decomposed latency between consecutive pipeline events — the
        paper's bottleneck-identification view (e.g. broker faster than the
        consuming processing tasks)."""
        out = {}
        if self.streaming:
            for a, b in zip(EVENTS[:-1], EVENTS[1:]):
                sk = self._sketch(a, b)
                if sk is not None and sk.count:
                    out[f"{a}->{b}"] = {
                        "mean_s": sk.mean, "max_s": sk.max,
                        "count": sk.count}
            return out
        for a, b in zip(EVENTS[:-1], EVENTS[1:]):
            lat = self.latencies(a, b)
            if lat:
                out[f"{a}->{b}"] = {
                    "mean_s": statistics.fmean(lat),
                    "max_s": max(lat), "count": len(lat)}
        return out

    @property
    def pending_traces(self) -> int:
        """In-flight (unretired) trace count — bounded by ``max_pending``
        in streaming mode, the full run in exact mode."""
        with self._lock:
            return len(self._traces)

    @property
    def retired_traces(self) -> int:
        """Traces folded into sketches (streaming mode only)."""
        with self._lock:
            return self._retired

