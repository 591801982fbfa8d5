"""The injected-clock API: one coherent notion of time for the whole stack.

Every core component (broker, task runtime, pilot liveness, autoscaler,
metrics, pipeline) reads time through a :class:`Clock` object instead of
calling ``time.monotonic()`` / ``time.sleep()`` directly.  Three
implementations:

* :class:`SystemClock` — wall clock; the default everywhere.  Behaviour is
  exactly the pre-refactor code.
* :class:`SimClock` (``auto_advance=True``) — *fast-forward* virtual time:
  ``sleep``/``wait`` advance the clock instantly instead of blocking.  A
  single-threaded discrete-event run (see :mod:`repro_torch.sim.scheduler`)
  replays hours of simulated pipeline in milliseconds of wall time with
  bit-reproducible timestamps.
* :class:`SimClock` (``auto_advance=False``) — *manually driven* virtual
  time for multi-threaded tests: ``sleep`` blocks the calling thread until
  the test calls :meth:`SimClock.advance`.  Timing-dependent behaviour
  (heartbeat loss, straggler speculation, autoscaler cooldowns) is then
  triggered by advancing virtual time, not by real waiting.

Back-compat: the seed's half-finished hooks passed a bare ``now()``
callable as ``clock=``.  :func:`as_clock` coerces those (and ``None``)
into Clock objects so the old call sites keep working.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Union


class _NullLock:
    """A no-op drop-in for :class:`threading.Lock` used on single-owner
    paths: when an auto-advance :class:`SimClock` DES run owns every
    component outright, the components' internal locks are pure overhead
    (the profile shows them as the top non-algorithmic cost of the event
    loop).  The executor swaps this in for the run and restores the real
    locks afterwards, so threaded use is untouched."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return True

    def release(self) -> None:
        pass

    def locked(self) -> bool:
        return False


NULL_LOCK = _NullLock()


class Clock:
    """Interface. ``virtual`` tells components whether time is free to
    advance (e.g. the broker honors WAN visibility times only when the
    clock can jump there at zero wall cost)."""

    virtual: bool = False

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, dt: float) -> None:
        raise NotImplementedError

    def wait(self, cond: threading.Condition, timeout: float) -> bool:
        """Clock-aware ``Condition.wait`` (``cond`` must be held).  Returns
        True if (possibly) notified, False on timeout."""
        raise NotImplementedError


class SystemClock(Clock):
    """Wall clock — delegates to :mod:`time`."""

    virtual = False

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)

    def wait(self, cond: threading.Condition, timeout: float) -> bool:
        return cond.wait(timeout=max(timeout, 0.0))


SYSTEM_CLOCK = SystemClock()


class _CallableClock(SystemClock):
    """A bare ``now()`` callable (the seed's ``clock=`` kwarg) promoted to
    the Clock interface; sleeps stay real."""

    def __init__(self, fn: Callable[[], float]):
        self._fn = fn

    def now(self) -> float:
        return float(self._fn())


def as_clock(clock: Union[Clock, Callable[[], float], None]) -> Clock:
    """Coerce ``None`` / a Clock / a bare ``now()`` callable to a Clock.
    Duck-typed objects must implement the *full* interface (``now``,
    ``sleep``, ``wait``, ``virtual``); a partial object exposing only
    ``now`` is wrapped like a bare callable (real sleeps/waits)."""
    if clock is None:
        return SYSTEM_CLOCK
    if isinstance(clock, Clock) or all(
            hasattr(clock, a) for a in ("now", "sleep", "wait", "virtual")):
        return clock  # type: ignore[return-value]
    if hasattr(clock, "now"):
        return _CallableClock(clock.now)
    if callable(clock):
        return _CallableClock(clock)
    raise TypeError(f"cannot interpret {clock!r} as a clock")


class SimClock(Clock):
    """Virtual monotonic clock.

    ``auto_advance=True`` (default): ``sleep(dt)`` jumps time forward by
    ``dt`` and returns immediately; ``wait(cond, t)`` jumps by ``t`` and
    reports a timeout.  Single-threaded event-driven code runs at memory
    speed while all timestamps remain exact.

    ``auto_advance=False``: ``sleep(dt)`` blocks (on a real condition)
    until another thread moves time past the deadline via :meth:`advance` /
    :meth:`advance_to`, or the clock is :meth:`close`-d.  ``wait`` performs
    a short *real* wait (capped at ``max_real_wait``) so polling loops stay
    responsive while the test drives time.

    Thread-safe; ``advance`` wakes all virtual sleepers whose deadline has
    passed.
    """

    virtual = True

    def __init__(self, start: float = 0.0, *, auto_advance: bool = True,
                 max_real_wait: float = 0.05):
        self._now = float(start)
        self.auto_advance = auto_advance
        self.max_real_wait = max_real_wait
        self._cond = threading.Condition()
        self._closed = False
        self._n_sleepers = 0

    # -- reading / driving time ------------------------------------------

    def now(self) -> float:
        # auto-advance clocks are single-threaded by construction (the DES
        # owns them; ThreadedExecutor rejects them), so the hot read skips
        # the lock — a float attribute read is atomic under the GIL anyway
        if self.auto_advance:
            return self._now
        with self._cond:
            return self._now

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds; wakes sleepers."""
        if dt < 0:
            raise ValueError(f"cannot advance by {dt}")
        if self.auto_advance:
            self._now += float(dt)          # no sleepers to wake
            return self._now
        with self._cond:
            self._now += float(dt)
            self._cond.notify_all()
            return self._now

    def advance_to(self, t: float) -> float:
        """Move time to ``t`` (no-op if ``t`` is in the past)."""
        if self.auto_advance:
            if t > self._now:
                self._now = float(t)
            return self._now
        with self._cond:
            if t > self._now:
                self._now = float(t)
                self._cond.notify_all()
            return self._now

    def close(self) -> None:
        """Release every blocked sleeper (used at test teardown so hung
        virtual tasks don't outlive the test)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def sleepers(self) -> int:
        """Number of threads currently blocked in :meth:`sleep` (manual
        mode) — lets a time-driving test wait for quiescence."""
        with self._cond:
            return self._n_sleepers

    # -- Clock interface --------------------------------------------------

    def sleep(self, dt: float) -> None:
        if dt <= 0:
            return
        if self.auto_advance:
            self._now += dt
            return
        with self._cond:
            deadline = self._now + dt
            self._n_sleepers += 1
            try:
                while self._now < deadline and not self._closed:
                    self._cond.wait(timeout=self.max_real_wait)
            finally:
                self._n_sleepers -= 1

    def wait(self, cond: threading.Condition, timeout: float) -> bool:
        if self.auto_advance:
            # Nothing else can run while this (virtual) thread waits, so
            # the only way forward is to advance time and report a timeout;
            # the caller's loop re-checks its predicate at the new time.
            self.advance(max(timeout, 0.0))
            return False
        return cond.wait(timeout=min(max(timeout, 0.0), self.max_real_wait))
