"""Nested spans that time the program's own layers, kept in memory.

A :class:`SpanTable` times blocks as named spans (:meth:`SpanTable.span`):
each name keeps a count, a total, a self time (its total less what its
child spans on the same thread cover), the names of the spans that held
it and a :class:`LatencySketch`.  Spans are off unless ``spans_on`` is
set; off, a span costs one flag test and a shared no-op, and nothing is
timed, kept or locked.  While spans are on and the torch profiler runs,
each span is also a ``record_function`` range named :data:`RANGE_PREFIX`
and its name, on the profiler's clock beside the device's kernels.
:meth:`SpanTable.snapshot` returns every name's figures so far, and
:func:`spans_between` the work between two snapshots.

This module is a leaf: it imports nothing of the package, and torch only
where the profiler already runs, so the kernel loader and the graph
functions record spans without loading ``repro_torch.core``.
``core.monitoring`` re-exports it, and its ``MetricsRegistry`` is a
:class:`SpanTable` too.  :data:`REGISTRY` is the process-wide table that
the LM stack (``graphs``, ``serve``, ``train``, ``kernels``, ``models``)
records into.  :func:`region` is a span of a part of a model step
(``mixer.attn``, ``mixer.ssm``, ``moe.route``, ``moe.experts``,
``moe.shared``) that also counts the kernel nodes a CUDA graph capture
gains inside it, where the capture installs a :class:`NodeTally`.
"""
from __future__ import annotations

import contextlib
import math
import sys
import threading
import time
from typing import Dict, Optional

# the prefix of every ``record_function`` range a span opens
RANGE_PREFIX = "repro_torch."


class LatencySketch:
    """Fixed-memory latency distribution: log-spaced bucket histogram.

    Buckets span ``[LO, HI)`` seconds at ``PER_DECADE`` buckets per decade
    (relative bucket width ``10**(1/PER_DECADE) - 1`` ≈ 3.7 %), with an
    underflow bucket below ``LO`` and an overflow bucket above ``HI``.
    ``count``/``total``/``min``/``max`` are tracked exactly, so ``mean``
    is exact and only the interior percentiles are bucket-resolution
    approximations.  Deterministic: the state is a pure function of the
    added values (no sampling, no randomized compaction)."""

    LO = 1e-7                      # 100 ns: below any virtual hop latency
    HI = 1e6                       # ~11.6 virtual days
    PER_DECADE = 64

    __slots__ = ("counts", "count", "total", "min", "max")

    _N_INTERIOR = int(round((math.log10(HI) - math.log10(LO)) * PER_DECADE))
    _LOG_LO = math.log10(LO)

    def __init__(self):
        # [0] underflow, [1.._N_INTERIOR] interior, [-1] overflow
        self.counts = [0] * (self._N_INTERIOR + 2)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, x: float) -> None:
        self.count += 1
        self.total += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if x < self.LO:
            idx = 0
        else:
            idx = 1 + int((math.log10(x) - self._LOG_LO) * self.PER_DECADE)
            if idx > self._N_INTERIOR:
                idx = self._N_INTERIOR + 1
        self.counts[idx] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket holding the ``q``-quantile (``q`` in
        [0, 1]); exact ``min``/``max`` are returned at the extremes and
        every estimate is clamped into ``[min, max]``."""
        if self.count == 0:
            return 0.0
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        # the rank the exact-mode percentile uses: sorted()[int(q * n)]
        rank = min(self.count - 1, int(q * self.count))
        cum = 0
        for idx, c in enumerate(self.counts):
            cum += c
            if cum > rank:
                if idx == 0:
                    edge = self.LO
                else:
                    edge = 10.0 ** (self._LOG_LO
                                    + idx / self.PER_DECADE)
                return min(max(edge, self.min), self.max)
        return self.max              # unreachable (cum ends at count)

    # -- cross-process merging (sharded DES) ------------------------------

    def state(self) -> dict:
        """Picklable snapshot for shipping a worker's sketch over a pipe."""
        return {"counts": list(self.counts), "count": self.count,
                "total": self.total, "min": self.min, "max": self.max}

    @classmethod
    def from_state(cls, st: dict) -> "LatencySketch":
        sk = cls()
        sk.counts = list(st["counts"])
        sk.count = int(st["count"])
        sk.total = float(st["total"])
        sk.min = float(st["min"])
        sk.max = float(st["max"])
        return sk

    def minus(self, other: "LatencySketch") -> "LatencySketch":
        """The values added to this sketch since it was ``other`` (an
        earlier state of it): bucket counts, count and total are exact,
        ``min`` and ``max`` the edges of the outermost buckets holding a
        value, within this sketch's own."""
        if len(other.counts) != len(self.counts):
            raise ValueError("cannot subtract sketches with different "
                             "layouts")
        sk = LatencySketch()
        sk.counts = [a - b for a, b in zip(self.counts, other.counts)]
        sk.count = self.count - other.count
        sk.total = self.total - other.total
        held = [i for i, c in enumerate(sk.counts) if c]
        if held:
            sk.min = max(self._edge(held[0]), self.min)
            sk.max = min(self._edge(held[-1] + 1), self.max)
        return sk

    @classmethod
    def _edge(cls, idx: int) -> float:
        """The lower edge of bucket ``idx`` (0 for the underflow)."""
        if idx == 0:
            return 0.0
        if idx > cls._N_INTERIOR + 1:
            return math.inf
        return 10.0 ** (cls._LOG_LO + (idx - 1) / cls.PER_DECADE)

    def merge(self, other: "LatencySketch") -> None:
        """Fold another sketch in.  Bucket counts, count, min and max merge
        exactly, so merged percentiles are bit-identical to a single sketch
        fed the union of values; only ``total`` (hence ``mean``) depends on
        float summation order."""
        if len(other.counts) != len(self.counts):
            raise ValueError("cannot merge sketches with different layouts")
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.count += other.count
        self.total += other.total
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max


class _SpanStats:
    """What a table keeps of one span name: how many ended, their
    seconds (``total``, ``self_s``, and their distribution), and how many
    each enclosing span's name held (None: none held it)."""

    __slots__ = ("count", "total", "self_s", "sketch", "parents")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.self_s = 0.0
        self.sketch = LatencySketch()
        self.parents: Dict[Optional[str], int] = {}

    def snapshot(self) -> dict:
        return {"count": self.count, "total_s": self.total,
                "self_s": self.self_s, "parents": dict(self.parents),
                "sketch": self.sketch.state()}


class _NoSpan:
    """The span of a table whose spans are off: nothing happens."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """One span while it is open: its name, its start and end on the
    table's clock, and its parent, the span open around it on the same
    thread (None at the top).  Its children add their seconds to
    ``child_s`` as they end."""

    __slots__ = ("table", "name", "parent", "start", "end", "child_s",
                 "_range")

    def __init__(self, table: "SpanTable", name: str):
        self.table = table
        self.name = name
        self.parent: Optional[_Span] = None
        self.start = self.end = 0.0
        self.child_s = 0.0
        self._range = None

    def __enter__(self):
        stack = self.table._span_stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        # a profiler runs only where torch is loaded
        torch = sys.modules.get("torch")
        if torch is not None and torch._C._autograd._profiler_enabled():
            self._range = torch.autograd.profiler.record_function(
                RANGE_PREFIX + self.name)
            self._range.__enter__()
        self.start = self.table._clock()
        return self

    def __exit__(self, *exc):
        self.end = self.table._clock()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.table._span_stack().pop()
        seconds = self.end - self.start
        if self.parent is not None:
            self.parent.child_s += seconds
        self.table._end_span(self, seconds)
        return False


def spans_between(before: Dict[str, dict],
                  after: Dict[str, dict]) -> Dict[str, dict]:
    """The spans that ended between two :meth:`SpanTable.snapshot`
    results of one table, by name (only names that have one):
    ``count``, ``total_s``, ``self_s``, ``mean_s``, ``p50_s``, ``p95_s``
    and ``max_s`` (the last three to the sketch's bucket width), and
    ``parents``."""
    out = {}
    for name, a in after.items():
        b = before.get(name)
        count = a["count"] - (b["count"] if b else 0)
        if count <= 0:
            continue
        sk = LatencySketch.from_state(a["sketch"])
        if b:
            sk = sk.minus(LatencySketch.from_state(b["sketch"]))
        parents = {p: n - (b["parents"].get(p, 0) if b else 0)
                   for p, n in a["parents"].items()}
        out[name] = {
            "count": count,
            "total_s": a["total_s"] - (b["total_s"] if b else 0.0),
            "self_s": a["self_s"] - (b["self_s"] if b else 0.0),
            "mean_s": sk.mean, "p50_s": sk.percentile(0.50),
            "p95_s": sk.percentile(0.95), "max_s": sk.max,
            "parents": {p: n for p, n in parents.items() if n}}
    return out


class SpanTable:
    """Spans by name (module docstring), timed on ``clock`` (a ``now()``
    callable in seconds) and kept under one lock."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        # off until set: per name, and each thread's open spans
        self.spans_on = False
        self._spans: Dict[str, _SpanStats] = {}
        self._local = threading.local()

    def span(self, name: str):
        """A context manager that times its block as the span ``name``,
        nested in the span open around it on this thread.  With
        ``spans_on`` false it is a shared no-op: nothing is timed, kept or
        locked."""
        if not self.spans_on:
            return _NO_SPAN
        return _Span(self, name)

    def _span_stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _end_span(self, span: _Span, seconds: float) -> None:
        parent = span.parent.name if span.parent is not None else None
        with self._lock:
            st = self._spans.get(span.name)
            if st is None:
                self._spans[span.name] = st = _SpanStats()
            st.count += 1
            st.total += seconds
            st.self_s += seconds - span.child_s
            st.sketch.add(seconds)
            st.parents[parent] = st.parents.get(parent, 0) + 1

    def snapshot(self) -> Dict[str, dict]:
        """Every span name's figures so far: ``count``, ``total_s``,
        ``self_s``, ``parents`` (the enclosing span's name, None at the
        top, to how many it held) and ``sketch`` (a
        :meth:`LatencySketch.state`).  :func:`spans_between` reads the
        work between two snapshots."""
        with self._lock:
            return {name: st.snapshot() for name, st in self._spans.items()}


# the process-wide table of the LM stack's spans
REGISTRY = SpanTable()


class NodeTally:
    """The kernel nodes a CUDA graph capture gains inside each named
    :func:`region`, while :func:`tallying` installs it on the capturing
    thread.  ``read()`` returns the kernel nodes the capture holds so far
    (a set of node handles, ``graphs.capture_kernel_nodes``); ``nodes``
    maps each region's name to the kernel nodes captured inside it,
    summed over its entries."""

    def __init__(self, read):
        self.read = read
        self.nodes: Dict[str, int] = {}


_TALLY = threading.local()


@contextlib.contextmanager
def tallying(tally: Optional[NodeTally]):
    """Installs a :class:`NodeTally` on this thread until the block ends
    (None installs nothing)."""
    was = getattr(_TALLY, "tally", None)
    _TALLY.tally = tally
    try:
        yield tally
    finally:
        _TALLY.tally = was


class _Region:
    """A region while a tally is installed: its span, and the kernel
    nodes the capture gained between its entry and its exit."""

    __slots__ = ("name", "tally", "span", "before")

    def __init__(self, name: str, tally: NodeTally):
        self.name, self.tally = name, tally
        self.span = REGISTRY.span(name)

    def __enter__(self):
        self.span.__enter__()
        self.before = self.tally.read()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            gained = len(self.tally.read() - self.before)
            self.tally.nodes[self.name] = \
                self.tally.nodes.get(self.name, 0) + gained
        return self.span.__exit__(*exc)


def region(name: str):
    """The span ``name`` of :data:`REGISTRY` around a part of a model
    step; while a capture on this thread tallies its nodes
    (:func:`tallying`), it also counts the kernel nodes captured inside
    it.  Otherwise it is ``REGISTRY.span(name)`` itself."""
    tally = getattr(_TALLY, "tally", None)
    if tally is None:
        return REGISTRY.span(name)
    return _Region(name, tally)
