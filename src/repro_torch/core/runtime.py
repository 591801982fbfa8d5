"""Per-pilot task runtime — the framework's Dask analog (paper §II-B 2.2).

The paper executes tasks "using a managed Dask cluster on the specified
location". Inside a pilot we run an executor with:

* futures-based submission (``TaskRuntime.submit`` → :class:`TaskFuture`),
* heartbeat-based failure detection (a task that stops heartbeating past
  ``heartbeat_timeout_s`` is marked lost and retried),
* bounded retries with exponential backoff,
* **straggler mitigation** by speculative re-execution: if a task runs longer
  than ``speculative_factor ×`` the trailing median runtime, a duplicate
  attempt is launched and the first result wins (classic MapReduce-style
  backup tasks — this is the between-pilot survival of Dask work stealing,
  see DESIGN.md §2),
* a context object passed to every task (the paper's "further information on
  the resource topology and shared state are via a context object").

SPMD note: *within* a mesh pilot a task is one jitted program — the runtime's
unit is the whole task, not a shard. Mesh pilots therefore run tasks serially
(capacity 1) while edge pilots run ``n_workers`` concurrent Python tasks.
"""
from __future__ import annotations

import inspect
import itertools
import statistics
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.monitoring import MetricsRegistry
from repro_torch.core.pilot import Pilot
from repro_torch.sim.clock import Clock, as_clock

_task_ids = itertools.count()


class TaskFailed(RuntimeError):
    pass


@dataclass
class TaskContext:
    """Paper's context object: topology + shared state + heartbeat hook.
    ``clock`` is the runtime's injected clock — long-running tasks should
    wait through it (``ctx.clock.sleep``) so emulated runs stay virtual."""
    pilot_id: str
    tier: str
    task_id: str
    attempt: int
    shared: dict = field(default_factory=dict)
    clock: Optional[Clock] = None
    _heartbeat: Optional[Callable[[], None]] = None

    def heartbeat(self) -> None:
        """Long-running tasks call this to stay alive past the timeout."""
        if self._heartbeat is not None:
            self._heartbeat()


@dataclass
class _Attempt:
    attempt_id: int
    started: float
    last_beat: float
    done: bool = False
    speculative: bool = False


class TaskFuture:
    def __init__(self, task_id: str):
        self.task_id = task_id
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self.attempts = 0
        self.speculated = False

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(self.task_id)
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, result: Any) -> bool:
        """First completion wins (speculative duplicates race here)."""
        if self._event.is_set():
            return False
        self._result = result
        self._event.set()
        return True

    def _fail(self, err: BaseException) -> bool:
        if self._event.is_set():
            return False
        self._error = err
        self._event.set()
        return True


class TaskRuntime:
    """Executor bound to one pilot."""

    def __init__(self, pilot: Pilot, metrics: Optional[MetricsRegistry] = None,
                 *, max_retries: int = 2,
                 heartbeat_timeout_s: float = 30.0,
                 speculative_factor: float = 0.0,
                 monitor_interval_s: float = 0.05,
                 clock: Optional[Clock] = None,
                 interpreter: Optional[Callable[["TaskContext", Any],
                                                Any]] = None):
        self.pilot = pilot
        self._clock = as_clock(clock)
        # cooperative task bodies: a submitted generator function is driven
        # to completion on the worker thread, its yielded effects resolved
        # by ``interpreter`` (numbers are always interpreted as clock
        # sleeps). The same bodies run as DES actors under SimExecutor.
        self.interpreter = interpreter
        self.metrics = metrics or MetricsRegistry(clock=self._clock)
        self.max_retries = max_retries
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.speculative_factor = speculative_factor
        self._pool = ThreadPoolExecutor(
            max_workers=max(pilot.capacity, 1) * 2,   # headroom for backups
            thread_name_prefix=f"{pilot.pilot_id}-worker")
        self._lock = threading.Lock()
        self._durations: List[float] = []
        self._inflight: Dict[str, dict] = {}
        self._shared: dict = {}
        self._shutdown = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, args=(monitor_interval_s,),
            daemon=True)
        self._monitor.start()

    # -- public API ----------------------------------------------------------

    def submit(self, fn: Callable[..., Any], *args,
               **kwargs) -> TaskFuture:
        self.pilot.require_active()
        task_id = f"{self.pilot.pilot_id}-task-{next(_task_ids)}"
        fut = TaskFuture(task_id)
        rec = {"fn": fn, "args": args, "kwargs": kwargs, "future": fut,
               "attempts": {}, "retries_left": self.max_retries}
        with self._lock:
            self._inflight[task_id] = rec
        self._launch_attempt(task_id, rec)
        self.metrics.incr("runtime.submitted")
        return fut

    def map(self, fn: Callable, items) -> List[TaskFuture]:
        return [self.submit(fn, x) for x in items]

    def shutdown(self, wait: bool = True) -> None:
        self._shutdown.set()
        self._pool.shutdown(wait=wait, cancel_futures=not wait)

    @property
    def shared(self) -> dict:
        return self._shared

    # -- attempt machinery ----------------------------------------------------

    def _launch_attempt(self, task_id: str, rec: dict,
                        speculative: bool = False) -> None:
        fut: TaskFuture = rec["future"]
        attempt_no = fut.attempts
        fut.attempts += 1
        now = self._clock.now()
        att = _Attempt(attempt_id=attempt_no, started=now, last_beat=now,
                       speculative=speculative)
        with self._lock:
            rec["attempts"][attempt_no] = att
        if speculative:
            fut.speculated = True
            self.metrics.incr("runtime.speculative_launches")

        def run():
            ctx = TaskContext(
                pilot_id=self.pilot.pilot_id, tier=self.pilot.tier,
                task_id=task_id, attempt=attempt_no, shared=self._shared,
                clock=self._clock,
                _heartbeat=lambda: self._beat(att))
            try:
                result = rec["fn"](ctx, *rec["args"], **rec["kwargs"])
                if inspect.isgenerator(result):
                    result = self._drive(ctx, result)
            except BaseException as e:  # noqa: BLE001 — retried below
                att.done = True
                self._on_attempt_error(task_id, rec, e)
                return
            att.done = True
            dur = self._clock.now() - att.started
            with self._lock:
                self._durations.append(dur)
                if len(self._durations) > 256:
                    del self._durations[:128]
            if fut._complete(result):
                self.metrics.incr("runtime.completed")
                if fut.speculated:
                    # first-completion-wins accounting, resolved per
                    # *launch* so wins + losses + cancelled == launches
                    # even when the monitor speculated more than once: a
                    # winning backup scores one win, every other backup
                    # launched for this task lost its race
                    n_spec = self._n_speculative(rec)
                    if att.speculative:
                        self.metrics.incr("runtime.speculative_wins")
                        n_spec -= 1
                    if n_spec > 0:
                        self.metrics.incr("runtime.speculative_losses",
                                          n_spec)
                with self._lock:
                    self._inflight.pop(task_id, None)

        self._pool.submit(run)

    def _drive(self, ctx: TaskContext, gen) -> Any:
        """Blocking interpretation of a cooperative task body: numbers are
        clock sleeps, everything else goes through ``self.interpreter``
        (the thread-strategy counterpart of a DES actor step)."""
        try:
            eff = next(gen)
            while True:
                if eff is None:
                    val = None
                elif isinstance(eff, (int, float)):
                    self._clock.sleep(max(float(eff), 0.0))
                    val = None
                elif self.interpreter is not None:
                    val = self.interpreter(ctx, eff)
                else:
                    raise TypeError(f"task {ctx.task_id} yielded {eff!r} "
                                    f"but the runtime has no interpreter")
                eff = gen.send(val)
        except StopIteration as s:
            return getattr(s, "value", None)

    def _beat(self, att: _Attempt) -> None:
        att.last_beat = self._clock.now()

    def _n_speculative(self, rec: dict) -> int:
        with self._lock:
            return sum(1 for a in rec["attempts"].values()
                       if a.speculative)

    def _on_attempt_error(self, task_id: str, rec: dict,
                          err: BaseException) -> None:
        fut: TaskFuture = rec["future"]
        self.metrics.incr("runtime.task_errors")
        self.metrics.event("task_error", task_id=task_id,
                           error=repr(err)[:200])
        with self._lock:
            retries = rec["retries_left"]
            rec["retries_left"] = retries - 1
        if retries > 0 and not fut.done():
            self.metrics.incr("runtime.retries")
            delay = 0.01 * (2 ** (self.max_retries - retries))
            self._clock.sleep(delay)
            if not fut.done():
                self._launch_attempt(task_id, rec)
        else:
            if fut._fail(TaskFailed(
                    f"{task_id} failed after {fut.attempts} attempts: "
                    f"{err!r}")):
                if fut.speculated:
                    # the task never completed: its backups' races were
                    # never decided — cancelled, keeping the invariant
                    # wins + losses + cancelled == launches (tasks still
                    # in flight at process shutdown are real threads and
                    # stay unaccounted; the DES has no such escape hatch)
                    n_spec = self._n_speculative(rec)
                    if n_spec > 0:
                        self.metrics.incr("runtime.speculative_cancelled",
                                          n_spec)
                with self._lock:
                    self._inflight.pop(task_id, None)

    # -- monitor: heartbeat timeouts + stragglers ------------------------------

    def _median_duration(self) -> Optional[float]:
        with self._lock:
            if len(self._durations) < 3:
                return None
            return statistics.median(self._durations)

    def _monitor_loop(self, interval: float) -> None:
        # the monitor thread wakes on a *real* cadence (it must stay live
        # while virtual time is driven from outside) but reads *clock*
        # time, so heartbeat loss / stragglers trigger on virtual advances
        while not self._shutdown.wait(interval):
            now = self._clock.now()
            median = self._median_duration()
            with self._lock:
                snapshot = list(self._inflight.items())
            for task_id, rec in snapshot:
                fut: TaskFuture = rec["future"]
                if fut.done():
                    continue
                running = [a for a in rec["attempts"].values()
                           if not a.done]
                # heartbeat failure detection
                for att in running:
                    if now - att.last_beat > self.heartbeat_timeout_s:
                        att.done = True   # declare lost
                        self._on_attempt_error(
                            task_id, rec,
                            TimeoutError(
                                f"heartbeat lost (attempt {att.attempt_id})"))
                # straggler speculation
                if (self.speculative_factor > 0 and median is not None
                        and len(running) == 1):
                    att = running[0]
                    if (now - att.started
                            > self.speculative_factor * median):
                        self._launch_attempt(task_id, rec, speculative=True)
