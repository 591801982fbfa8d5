"""Discrete-event scheduler over a :class:`~repro_torch.sim.clock.SimClock`.

A classic DES loop: a heap of ``(time, seq, event)`` entries; ``run`` pops
the earliest event, jumps the virtual clock to its timestamp, and executes
it.  ``seq`` (insertion order) breaks time ties, so a run is a pure
function of the scenario + seed — the bit-reproducibility the emulator is
built on.

The hot path is engineered for million-event runs:

* heap entries are plain ``(t, seq, event)`` tuples, so every sift
  comparison happens in C instead of a Python ``__lt__``;
* cancelled events are counted (``__len__`` is O(1), not a heap scan) and
  *compacted* out of the heap once they outnumber the live events — a
  long run with heavy cancellation traffic (actor wakeup rewrites, poll
  timeouts raced by appends) keeps its heap proportional to the live
  event count instead of accumulating garbage for the whole run;
* an actor reuses its step :class:`_Event` slot across wakeups (one
  pre-bound callback per actor, no per-wakeup lambda closure or event
  allocation).

Events are plain callbacks: handlers schedule follow-up events, which keeps
the whole machine single-threaded and deterministic while reusing the
*real* broker / metrics / placement objects under virtual time.

On top of the callback loop sits a cooperative-actor layer
(:class:`Actor`, :meth:`EventScheduler.spawn`): a Python generator is
driven as a DES process. Each ``yield`` suspends the actor —

* ``yield <seconds>`` resumes it that much virtual time later,
* ``yield PARK`` parks it until an external ``resume``/``throw``,
* any other yielded value is handed to the spawner's ``interpret``
  callback (the execution strategy's effect vocabulary — e.g. the
  pipeline executors' ``Poll``/``Service`` effects).

This is how the *genuine* ``EdgeToCloudPipeline`` task loops run inside
the DES: the same generator bodies that thread executors drive with
blocking calls are spawned here as deterministic single-threaded actors.
"""
from __future__ import annotations

import heapq
import itertools
import math
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.sim.clock import SimClock

# compaction trigger: dead (cancelled, still-heaped) events must exceed
# both this floor and the live event count before the heap is rebuilt —
# small runs never pay the rebuild, long cancellation-heavy runs stay
# proportional to their live set
_COMPACT_MIN = 64


class _Event:
    """Handle for one scheduled callback.  ``cancel()`` marks it dead in
    place (O(1)); the scheduler skips dead entries on pop and compacts
    them out wholesale when they pile up."""

    __slots__ = ("t", "seq", "fn", "cancelled", "_sched")

    def __init__(self, t: float, seq: int, fn: Callable[[], Any],
                 sched: "EventScheduler"):
        self.t = t
        self.seq = seq
        self.fn = fn
        self.cancelled = False
        self._sched = sched

    def cancel(self) -> None:
        if not self.cancelled:
            self.cancelled = True
            self._sched._on_cancel()


class EventScheduler:
    """Deterministic event loop bound to a virtual clock."""

    def __init__(self, clock: Optional[SimClock] = None):
        self.clock = clock if clock is not None else SimClock()
        if not self.clock.auto_advance:
            raise ValueError("EventScheduler needs an auto-advance SimClock")
        self._heap: List[Tuple[float, int, _Event]] = []
        self._seq = itertools.count()
        self._live = 0          # scheduled, not cancelled, not yet run
        self._dead = 0          # cancelled but still occupying a heap slot
        self.executed = 0
        self.compactions = 0    # heap rebuilds (observability / tests)

    # -- scheduling --------------------------------------------------------

    def at(self, t: float, fn: Callable[[], Any]) -> _Event:
        """Schedule ``fn`` at absolute virtual time ``t`` (clamped to now:
        the clock never runs backwards)."""
        t = max(t, self.clock.now())
        ev = _Event(t, next(self._seq), fn, self)
        heapq.heappush(self._heap, (t, ev.seq, ev))
        self._live += 1
        return ev

    def after(self, dt: float, fn: Callable[[], Any]) -> _Event:
        """Schedule ``fn`` ``dt`` seconds of virtual time from now."""
        return self.at(self.clock.now() + max(dt, 0.0), fn)

    def reschedule(self, ev: _Event, t: float) -> _Event:
        """Re-arm a *fired or cancelled-and-compacted* event handle at
        ``t`` with a fresh insertion seq (slot reuse: the actor layer
        recycles its step event instead of allocating one per wakeup).
        The handle must not currently sit in the heap."""
        t = max(t, self.clock.now())
        ev.t = t
        ev.seq = next(self._seq)
        ev.cancelled = False
        heapq.heappush(self._heap, (t, ev.seq, ev))
        self._live += 1
        return ev

    def __len__(self) -> int:
        return self._live

    # -- cancellation bookkeeping -----------------------------------------

    def _on_cancel(self) -> None:
        self._live -= 1
        self._dead += 1
        if self._dead > _COMPACT_MIN and self._dead > self._live:
            self._compact()

    def _compact(self) -> None:
        """Rebuild the heap without its cancelled entries.  (t, seq) keys
        are preserved, so execution order is unchanged.  In place (slice
        assignment): ``run`` holds a local reference to the heap list, so
        the list object's identity must survive compaction."""
        self._heap[:] = [e for e in self._heap if not e[2].cancelled]
        heapq.heapify(self._heap)
        self._dead = 0
        self.compactions += 1

    @property
    def next_time(self) -> Optional[float]:
        heap = self._heap
        while heap and heap[0][2].cancelled:
            heapq.heappop(heap)
            self._dead -= 1
        return heap[0][0] if heap else None

    # -- running -----------------------------------------------------------

    def run(self, until: float = math.inf,
            max_events: Optional[int] = None,
            stop: Optional[Callable[[], bool]] = None) -> int:
        """Execute events in (time, insertion) order until the queue
        drains, virtual time would pass ``until``, ``max_events`` (a
        runaway-scenario backstop) fire, or ``stop()`` returns True
        (checked before each event).  Returns events executed.

        When the run ends because the queue drained or every remaining
        event lies beyond ``until``, the clock is advanced to ``until``
        (for finite ``until``): the caller asked to simulate *through*
        that instant, so ``clock.now()`` reflects it even if no event
        happened to land there.  ``max_events``/``stop`` exits leave the
        clock at the last executed event."""
        # hot loop: every per-event attribute chain hoisted into locals
        # (heap, clock.advance_to, heapq.heappop) and the executed counter
        # accumulated locally, flushed once — at millions of events these
        # lookups are a measurable slice of the profile
        n = 0
        heap = self._heap
        advance_to = self.clock.advance_to
        pop = heapq.heappop
        exhausted = False
        try:
            while heap:
                if stop is not None and stop():
                    break
                entry = heap[0]
                ev = entry[2]
                if ev.cancelled:
                    pop(heap)
                    self._dead -= 1
                    continue
                t = entry[0]
                if t > until:
                    exhausted = True
                    break
                pop(heap)
                self._live -= 1
                # mark fired before fn() runs: a later cancel() on this
                # handle must be a no-op (not a counter decrement), and
                # fn() itself may reschedule() the handle, which clears
                # the flag for the fresh heap entry
                ev.cancelled = True
                advance_to(t)
                ev.fn()
                n += 1
                if max_events is not None and n >= max_events:
                    break
            else:
                exhausted = True
        finally:
            self.executed += n
        if exhausted and until != math.inf:
            # drained (or next event beyond the horizon): time still
            # passed up to `until` — composed scenarios read clock.now()
            # after run(until=...) and must not see a stale timestamp
            advance_to(until)
        return n

    def step(self) -> bool:
        """Execute exactly the next pending event. Returns False if none."""
        return self.run(max_events=1) == 1

    # -- actors ------------------------------------------------------------

    def spawn(self, gen, *, name: str = "actor",
              at: Optional[float] = None,
              interpret: Optional[Callable[["Actor", Any], None]] = None,
              on_exit: Optional[Callable[["Actor", Optional[BaseException],
                                          Any], None]] = None) -> "Actor":
        """Drive generator ``gen`` as a cooperative DES actor, starting at
        virtual time ``at`` (default: now)."""
        actor = Actor(self, gen, name=name, interpret=interpret,
                      on_exit=on_exit)
        actor._schedule_step(self.clock.now() if at is None else at)
        return actor


# sentinel: an actor yielding PARK (or None) suspends until an external
# resume()/throw()
PARK = object()


class ActorKilled(Exception):
    """Injected termination (crash/rebalance injection mid-run)."""


class Actor:
    """A generator driven by the scheduler as a DES process.

    The generator communicates by yielding: a number (sleep that many
    virtual seconds), :data:`PARK`/``None`` (suspend until ``resume``), or
    an arbitrary effect object handed to ``interpret`` (which must
    eventually ``resume``/``throw``/``kill`` the actor). ``on_exit`` fires
    exactly once with ``(actor, exception_or_None, return_value)``.

    Hot-path note: an actor schedules every step through one pre-bound
    callback and recycles its fired step event (``reschedule``) — zero
    per-wakeup closure/event allocation.
    """

    __slots__ = ("sched", "gen", "name", "interpret", "on_exit", "alive",
                 "parked", "_pending", "_spare", "_payload", "_exc",
                 "_step_cb")

    def __init__(self, sched: EventScheduler, gen, *, name: str = "actor",
                 interpret=None, on_exit=None):
        self.sched = sched
        self.gen = gen
        self.name = name
        self.interpret = interpret
        self.on_exit = on_exit
        self.alive = True
        self.parked = False
        self._pending: Optional[_Event] = None
        self._spare: Optional[_Event] = None    # fired event, reusable
        self._payload: Any = None
        self._exc: Optional[BaseException] = None
        self._step_cb = self._on_event          # bound once, reused

    # -- external control --------------------------------------------------

    def resume(self, payload: Any = None, delay: float = 0.0) -> None:
        """Wake a suspended actor with ``payload`` after ``delay`` virtual
        seconds.  Only a *parked* actor (or one idling with no pending
        wakeup — e.g. suspended on an interpreted effect) can be resumed:
        an actor mid-``yield <seconds>`` keeps its timed wakeup — a resume
        racing a timed sleep must not silently rewrite the wakeup time
        (use :meth:`throw`/:meth:`kill` to interrupt a sleep)."""
        if not self.alive:
            return
        if self._pending is not None and not self.parked:
            return
        self.parked = False
        self._schedule_step(self.sched.clock.now() + max(delay, 0.0),
                            payload=payload)

    def throw(self, exc: BaseException) -> None:
        """Deliver ``exc`` into the generator at its suspension point."""
        if not self.alive:
            return
        self.parked = False
        self._schedule_step(self.sched.clock.now(), exc=exc)

    def kill(self, exc: Optional[BaseException] = None) -> None:
        """Crash injection: raise :class:`ActorKilled` inside the actor."""
        self.throw(exc if exc is not None else ActorKilled(self.name))

    def drop(self) -> None:
        """Silent failure: stop driving the actor *without* running any
        cleanup or ``on_exit`` — the process just goes dark (the way a lost
        node does). Failure detection (heartbeat monitors) must notice."""
        self.alive = False
        self.parked = False
        self._cancel_pending()

    # -- machinery ---------------------------------------------------------

    def _cancel_pending(self) -> None:
        if self._pending is not None:
            self._pending.cancel()
            self._pending = None

    def _schedule_step(self, t: float, payload: Any = None,
                       exc: Optional[BaseException] = None) -> None:
        if not self.alive:
            return
        self._cancel_pending()
        self._payload = payload
        self._exc = exc
        spare = self._spare
        if spare is not None:
            self._spare = None
            spare.fn = self._step_cb
            self._pending = self.sched.reschedule(spare, t)
        else:
            self._pending = self.sched.at(t, self._step_cb)

    def _on_event(self) -> None:
        """The step event fired: recycle its slot and drive the
        generator one step."""
        ev = self._pending
        self._pending = None
        if ev is not None:
            self._spare = ev        # out of the heap — safe to reuse
        payload, exc = self._payload, self._exc
        self._payload = self._exc = None
        if not self.alive:
            return
        try:
            if exc is not None:
                eff = self.gen.throw(exc)
            else:
                eff = self.gen.send(payload)
        except StopIteration as s:
            self._finish(None, getattr(s, "value", None))
            return
        except BaseException as e:  # noqa: BLE001 — routed to on_exit
            self._finish(e, None)
            return
        self._dispatch(eff)

    def _step(self, payload: Any, exc: Optional[BaseException]) -> None:
        """Back-compat shim (tests drive actors directly): one generator
        step with an explicit payload/exception."""
        self._payload, self._exc = payload, exc
        self._on_event()

    def _dispatch(self, eff: Any) -> None:
        if eff is PARK or eff is None:
            self.parked = True
            return
        if isinstance(eff, (int, float)):
            self._schedule_step(self.sched.clock.now() + max(float(eff), 0.0))
            return
        if self.interpret is not None:
            self.interpret(self, eff)
            return
        self._finish(TypeError(f"actor {self.name!r} yielded {eff!r} "
                               f"with no interpreter"), None)

    def _finish(self, exc: Optional[BaseException], result: Any) -> None:
        self.alive = False
        self.parked = False
        self._cancel_pending()
        self.gen.close()
        if self.on_exit is not None:
            self.on_exit(self, exc, result)
