"""Execution strategies for :class:`~repro_torch.core.faas.ContinuumPipeline`
(and its two-stage :class:`~repro_torch.core.faas.EdgeToCloudPipeline` wrapper).

The pipeline's task loops (source devices, per-stage consumers) are
written once, as *cooperative generator bodies* (``faas._source_body`` /
``faas._stage_body``) that yield effects instead of blocking:

* :class:`Sleep`   — wait a number of seconds,
* :class:`Service` — charge a stage's service time (priced by the
  strategy's ``service_model``; zero by default),
* :class:`Poll`    — fetch the next message from a consumer group.

Both strategies accept any ``service_model(stage, ctx, payload) -> s``
callable; :meth:`repro_torch.cost.model.CostModel.service_model` builds the
*calibrated* one — per-stage times derived from the measured ``repro_torch.ml``
kernel costs, optionally with the calibrated lognormal service-time noise
(seeded, so DES runs stay bit-reproducible).

Two strategies interpret those effects:

* :class:`ThreadedExecutor` — real threads on :class:`TaskRuntime`
  (production / live-demo behaviour; effects resolve to blocking calls).
  This is the default and matches the pre-refactor pipeline exactly.
* :class:`SimExecutor` — a single-threaded discrete-event simulation on
  :class:`~repro_torch.sim.scheduler.EventScheduler`: bodies run as DES actors,
  consumers are *event-driven* (woken by broker append notifications and
  exact WAN-visibility times — no polling sleeps), heartbeat monitoring,
  retries, crash/rebalance injection and the lag-driven
  :class:`~repro_torch.core.elastic.AutoScaler` all run as scheduled events on
  one virtual clock. A run is a pure function of (pipeline config,
  executor config, seed): metrics are bit-identical across repeats.

``pipe.run(scheduler=SimExecutor(...))`` therefore exercises the *genuine*
pipeline — same broker offsets, consumer-group rebalances, dedup and
metrics stamps as production — under reproducible virtual time.

Both strategies speculate on stragglers at service-charge granularity
(``speculative_factor``, mirroring :class:`TaskRuntime`'s knob): a charge
running past ``factor × trailing median`` races a backup draw of the
service model, first completion wins, with deterministic win/loss/cancel
accounting (see :class:`SpeculationStats`).  Speculation is
**capacity-aware** (Dask-style work stealing): a backup occupies a
*different, idle* consumer slot of the same stage — under the DES the
first parked stage-mate is stolen for the duration of the race (it is
not woken for new messages until the race resolves); when no stage-mate
is idle the backup is not launched at all
(``runtime.speculative_no_capacity`` counts those skips).
"""
from __future__ import annotations

import itertools
import statistics
import threading
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.broker import WanShaper
from repro_torch.core.runtime import TaskContext, TaskRuntime
from repro_torch.sim.clock import NULL_LOCK, SimClock
from repro_torch.sim.scheduler import ActorKilled, EventScheduler

# service_model(stage, ctx, payload) -> seconds of service time to charge
ServiceModel = Callable[[str, TaskContext, Any], float]


# ---------------------------------------------------------------------------
# straggler speculation (shared between the strategies)
# ---------------------------------------------------------------------------


class SpeculationStats:
    """Trailing per-stage service durations + win/loss accounting.

    Mirrors :class:`~repro_torch.core.runtime.TaskRuntime`'s straggler rule at
    *service-charge* granularity: once a stage has ``min_samples``
    completed charges, any charge still running past
    ``speculative_factor × trailing median`` gets a backup launched with a
    fresh service-model draw; the first completion wins.  Counters
    (``runtime.speculative_launches`` / ``_wins`` / ``_losses`` /
    ``_cancelled``) land in the run's MetricsRegistry; wins + losses +
    cancelled always equals launches.
    """

    MIN_SAMPLES = 3          # TaskRuntime._median_duration's warmup bar
    WINDOW = 256             # trailing window, trimmed like TaskRuntime

    def __init__(self, factor: float, metrics):
        self.factor = factor
        self.metrics = metrics
        self._durations: Dict[str, List[float]] = defaultdict(list)
        self._lock = threading.Lock()

    def record(self, stage: str, duration_s: float) -> None:
        if duration_s <= 0.0:
            return
        with self._lock:
            d = self._durations[stage]
            d.append(duration_s)
            if len(d) > self.WINDOW:
                del d[:self.WINDOW // 2]

    def threshold(self, stage: str) -> Optional[float]:
        """``factor × trailing median`` — or None during warmup."""
        with self._lock:
            d = self._durations[stage]
            if len(d) < self.MIN_SAMPLES:
                return None
            return self.factor * statistics.median(d)

    # -- accounting -------------------------------------------------------

    def launched(self) -> None:
        self.metrics.incr("runtime.speculative_launches")

    def resolved(self, backup_won: bool) -> None:
        self.metrics.incr("runtime.speculative_wins" if backup_won
                          else "runtime.speculative_losses")

    def cancelled(self) -> None:
        self.metrics.incr("runtime.speculative_cancelled")

    def no_capacity(self) -> None:
        """A straggler qualified for a backup but no idle slot of its
        stage existed to steal — the backup was not launched."""
        self.metrics.incr("runtime.speculative_no_capacity")

    # -- inline form (ThreadedExecutor) -----------------------------------

    def charge(self, stage: str, primary_s: float,
               redraw: Callable[[], float], *,
               try_steal: Optional[Callable[[], bool]] = None) -> float:
        """First-completion-wins arithmetic for a blocking strategy: a
        charge that would run past the threshold launches a backup
        (``redraw`` — a fresh draw of the same service model) at the
        threshold, and the effective charge is whichever finishes first.
        Threads can't race two sleeps for one generator step, so the race
        is resolved inline — same accounting, same clock outcome as the
        DES's event-scheduled race.

        Capacity awareness: when ``try_steal`` is given, the backup only
        launches if it returns True (an idle slot of this stage was
        claimed).  The claim is *kept* — the caller releases it after
        sleeping the effective charge, so the slot stays occupied for
        the race's duration like the DES helper.  Without the hook
        capacity is unconstrained (the pre-work-stealing behaviour, kept
        for unit use)."""
        if primary_s <= 0.0:
            return primary_s
        th = self.threshold(stage)
        if th is None or primary_s <= th:
            self.record(stage, primary_s)
            return primary_s
        if try_steal is not None and not try_steal():
            self.no_capacity()
            self.record(stage, primary_s)
            return primary_s
        self.launched()
        backup_total = th + max(redraw(), 0.0)
        backup_won = backup_total < primary_s
        self.resolved(backup_won)
        effective = min(primary_s, backup_total)
        self.record(stage, effective)
        return effective


# ---------------------------------------------------------------------------
# effects
# ---------------------------------------------------------------------------


class Sleep:
    """Wait ``seconds`` (virtual under SimExecutor, clock-real otherwise).

    Effects are mutable slotted records on purpose: a pipeline body
    allocates one per effect kind and rewrites its fields per iteration
    (the interpreter consumes an effect synchronously at the yield point,
    so reuse is safe) — at a million messages the per-yield dataclass
    churn was a measurable slice of the event loop."""

    __slots__ = ("seconds",)

    def __init__(self, seconds: float):
        self.seconds = seconds


class Service:
    """Charge the strategy's service model for one ``stage`` invocation."""

    __slots__ = ("stage", "payload")

    def __init__(self, stage: str, payload: Any = None):
        self.stage = stage
        self.payload = payload


class Poll:
    """Next message from ``group`` for ``consumer_id`` — or ``None``.

    Threaded: a blocking ``group.poll(timeout_s)`` (periodic ``None``
    returns let the body re-check stop/idle conditions). Sim: the actor
    parks until an append notification, the message's WAN ``ready_at``, a
    stop, or ``wake_at`` (the body's idle deadline) — no idle ticking.

    ``stage`` names the polling stage so the threaded strategy can keep
    its per-stage idle-slot ledger (capacity-aware speculation).
    """

    __slots__ = ("group", "consumer_id", "timeout_s", "wake_at", "stage")

    def __init__(self, group: Any, consumer_id: str, timeout_s: float = 0.2,
                 wake_at: Optional[float] = None,
                 stage: Optional[str] = None):
        self.group = group
        self.consumer_id = consumer_id
        self.timeout_s = timeout_s
        self.wake_at = wake_at
        self.stage = stage


# ---------------------------------------------------------------------------
# threaded strategy (today's behaviour)
# ---------------------------------------------------------------------------


class ThreadedExecutor:
    """Run the pipeline bodies on real threads via :class:`TaskRuntime`.

    ``service_model`` is optional wall-pacing (used by live demos to make
    stage costs real — ``examples/edge_to_cloud_outlier.py`` paces with
    the calibrated continuum costs, and a slow-marked test pins its
    throughput against the SimExecutor prediction); by default effects
    cost nothing and behaviour is identical to the historical
    thread-scheduled pipeline.

    ``speculative_factor`` (default: the pipeline's) enables straggler
    speculation at service-charge granularity when a service model is
    set: a charge running past ``factor × trailing median`` launches a
    backup draw, first completion wins (see :class:`SpeculationStats`).
    Charge-level speculation supersedes :class:`TaskRuntime`'s whole-body
    speculation (re-running an entire consumer loop only manufactures
    duplicates), so the runtimes get ``speculative_factor=0`` then.
    """

    def __init__(self, *, service_model: Optional[ServiceModel] = None,
                 speculative_factor: Optional[float] = None):
        self.service_model = service_model
        self.speculative_factor = speculative_factor
        self.speculation: Optional[SpeculationStats] = None

    def run(self, pipe, *, n_messages: int, timeout_s: float,
            collect_results: bool):
        clock = pipe._clock
        if getattr(clock, "auto_advance", False):
            # concurrent waiters would race a fast-forward clock past the
            # run deadline while work is in flight; auto-advance virtual
            # time belongs to the single-threaded SimExecutor.
            raise ValueError(
                "ThreadedExecutor needs a wall clock or a manually driven "
                "SimClock(auto_advance=False); pass "
                "scheduler=SimExecutor(...) for auto-advance virtual time")
        state = pipe._setup_run(n_messages, timeout_s, collect_results)
        t0 = clock.now()
        factor = (self.speculative_factor
                  if self.speculative_factor is not None
                  else pipe._runtime_kw["speculative_factor"])
        runtime_kw = dict(pipe._runtime_kw)
        # per-run reset: a reused executor must not carry the previous
        # pipeline's stats (or metrics registry) into this run
        self.speculation = None
        # the executor-level factor overrides the pipeline's for *all*
        # speculation (an explicit 0.0 disables it outright, matching
        # SimExecutor); with a service model the charge-level race
        # supersedes TaskRuntime's whole-body speculation, without one
        # the runtimes speculate bodies at the resolved factor
        runtime_kw["speculative_factor"] = factor
        if factor > 0 and self.service_model is not None:
            self.speculation = SpeculationStats(factor, pipe.metrics)
            runtime_kw["speculative_factor"] = 0.0

        def _try_steal(stage: str) -> bool:
            """Claim an idle slot of ``stage`` for a backup (work
            stealing): only consumers currently parked in a poll count."""
            with state.lock:
                if state.idle.get(stage, 0) > 0:
                    state.idle[stage] -= 1
                    return True
            return False

        def _release_slot(stage: str) -> None:
            with state.lock:
                state.idle[stage] = state.idle.get(stage, 0) + 1

        def interpret(ctx: TaskContext, eff: Any) -> Any:
            if isinstance(eff, Sleep):
                clock.sleep(max(eff.seconds, 0.0))
                return None
            if isinstance(eff, Service):
                s = (self.service_model(eff.stage, ctx, eff.payload)
                     if self.service_model else 0.0)
                stole = False
                if self.speculation is not None and s > 0:
                    def steal():
                        nonlocal stole
                        stole = _try_steal(eff.stage)
                        return stole
                    # the claim is held for the duration of the
                    # effective charge (released below, after the
                    # sleep), mirroring the DES's helper occupancy —
                    # overlapping stragglers cannot all steal one slot
                    s = self.speculation.charge(
                        eff.stage, s,
                        lambda: self.service_model(eff.stage, ctx,
                                                   eff.payload),
                        try_steal=steal)
                try:
                    if s > 0:
                        clock.sleep(s)
                finally:
                    if stole:
                        _release_slot(eff.stage)
                return None
            if isinstance(eff, Poll):
                # idle-slot ledger: a consumer blocked in a poll is a
                # steal target for capacity-aware speculation
                if eff.stage is not None:
                    with state.lock:
                        state.idle[eff.stage] = \
                            state.idle.get(eff.stage, 0) + 1
                try:
                    return eff.group.poll(eff.consumer_id,
                                          timeout_s=eff.timeout_s)
                finally:
                    if eff.stage is not None:
                        with state.lock:
                            state.idle[eff.stage] -= 1
            raise TypeError(f"unknown pipeline effect {eff!r}")

        runtimes = [TaskRuntime(stage.pilot, pipe.metrics,
                                interpreter=interpret, **runtime_kw)
                    for stage in pipe.stages]
        producer_futs = [
            runtimes[0].submit(pipe._source_body, state, i,
                               state.per_device[i])
            for i in range(pipe.stage_tasks(0))]
        consumer_futs = []
        for si in range(1, len(pipe.stages)):
            consumer_futs.extend(
                runtimes[si].submit(pipe._stage_body, state, si,
                                    pipe.stage_cid(si, i))
                for i in range(pipe.stage_tasks(si)))

        # online re-advisory: a daemon monitor thread ticks the attached
        # ReAdvisor against the wall clock; a decision re-binds the
        # watched stage, bumps its placement epoch (old threads drain at
        # their next poll loop-top) and submits a replacement fleet on a
        # fresh TaskRuntime bound to the winning pilot
        rv = pipe._readvise
        rv_thread = None
        if rv is not None:
            rv_si = next(i for i, st in enumerate(pipe.stages)
                         if st.name == rv.stage)
            if rv_si == 0:
                raise ValueError("the source stage cannot be re-advised — "
                                 "watch a consumer stage")
            stage_seq = {si: itertools.count(pipe.stage_tasks(si))
                         for si in range(1, len(pipe.stages))}
            rv.begin(t0)

            def _rv_loop():
                while not state.stop.wait(rv.interval_s):
                    dec = rv.step(
                        now=clock.now(), metrics=pipe.metrics,
                        topic=state.topics[rv_si - 1].name,
                        current_tier=pipe.stages[rv_si].pilot.tier,
                        src_tier=pipe.stages[rv_si - 1].pilot.tier)
                    if dec is None:
                        continue
                    pipe.metrics.event(
                        "readvise_decision", stage=pipe.stages[rv_si].name,
                        from_tier=dec.from_tier, to_tier=dec.to_tier)
                    if rv.apply_delay_s > 0 and state.stop.wait(
                            rv.apply_delay_s):
                        return
                    pipe.rebind_stage(pipe.stages[rv_si].name,
                                      rv.pilot_for(dec.to_tier))
                    with state.lock:
                        state.stage_epoch[rv_si] = \
                            state.stage_epoch.get(rv_si, 0) + 1
                    rt = TaskRuntime(pipe.stages[rv_si].pilot, pipe.metrics,
                                     interpreter=interpret, **runtime_kw)
                    runtimes.append(rt)
                    for _ in range(pipe.stage_tasks(rv_si)):
                        cid = pipe.stage_cid(rv_si, next(stage_seq[rv_si]))
                        pipe.metrics.event("consumer_spawned", consumer=cid)
                        consumer_futs.append(
                            rt.submit(pipe._stage_body, state, rv_si, cid))
                    rv.applied(dec, clock.now())

            rv_thread = threading.Thread(target=_rv_loop, daemon=True,
                                         name="readvise-monitor")
            rv_thread.start()

        # the semaphore wait is real (worker threads are real) but the
        # deadline is measured on the injected clock; with a virtual clock
        # the real wait must stay short so deadline advances (driven from
        # another thread) are observed promptly
        deadline = t0 + timeout_s
        remaining = n_messages
        while remaining > 0:
            wait_s = min(deadline - clock.now(), timeout_s)
            if clock.virtual:
                wait_s = min(wait_s, 0.05)
            if state.processed_sem.acquire(timeout=max(wait_s, 0.01)):
                remaining -= 1
            elif clock.now() >= deadline:
                break
        state.stop.set()
        wall = (state.t_done if state.t_done is not None
                else clock.now()) - t0     # before any shutdown nudging
        if rv_thread is not None:
            rv_thread.join(timeout=5.0)
        for f in producer_futs + consumer_futs:
            # with a manual virtual clock, workers may be parked inside
            # clock.sleep waiting for time the external driver will never
            # provide once the run is over — tick the clock while joining
            # so their poll loops observe stop and exit
            for _ in range(1000):           # ~10 s real bound per future
                if clock.virtual:
                    clock.advance(0.01)
                try:
                    f.result(timeout=0.01)
                    break
                except TimeoutError:
                    continue
                except Exception:  # noqa: BLE001 — task errors already counted
                    break
        for rt in runtimes:
            rt.shutdown(wait=False)
        return pipe._finish(state, wall)


# ---------------------------------------------------------------------------
# DES strategy
# ---------------------------------------------------------------------------


class _PollWait:
    """A consumer actor parked on an empty Poll, waiting to be woken.
    ``timeout_ev`` is the scheduled fallback wake (WAN ready_at or the
    body's idle deadline), cancelled when something wakes the wait first.

    One instance per consumer record, reused across parks: ``gen`` is
    bumped on every re-park so wake callbacks scheduled for an earlier
    park (an append's wake event racing a timeout, say) recognise
    themselves as stale instead of waking the *next* park early.
    ``topic_id``/``parts`` record where the wait is registered in the
    run's per-(topic, partition) waiter index."""

    __slots__ = ("rec", "actor", "eff", "resolved", "timeout_ev", "gen",
                 "topic_id", "parts")

    def __init__(self, rec: dict, actor, eff: Poll):
        self.rec = rec
        self.actor = actor
        self.eff = eff
        self.resolved = False
        self.timeout_ev = None
        self.gen = 0
        self.topic_id = 0
        self.parts: Sequence[int] = ()


class _ServiceOp:
    """One in-flight Service charge racing an (eventual) speculative
    backup.  ``primary_ev`` fires at the primary draw's completion;
    ``check_ev`` fires at ``factor × trailing median`` and — if an idle
    stage-mate's slot can be stolen — launches the backup on that slot;
    ``backup_ev`` fires at the backup's completion.  Whichever completion
    event fires first resolves the op, cancels the loser, releases the
    stolen slot, and resumes the actor."""

    __slots__ = ("rec", "actor", "stage", "ctx", "payload", "t0",
                 "primary_ev", "check_ev", "backup_ev", "backup_launched",
                 "resolved", "helper", "helper_eff")

    def __init__(self, rec: dict, actor, stage: str, payload: Any,
                 t0: float):
        self.rec = rec
        self.actor = actor
        self.stage = stage
        self.payload = payload
        self.t0 = t0
        self.primary_ev = None
        self.check_ev = None
        self.backup_ev = None
        self.backup_launched = False
        self.resolved = False
        self.helper = None         # the stage-mate whose slot the backup runs on
        self.helper_eff = None     # its interrupted Poll, re-attempted on release

    def cancel_events(self) -> None:
        for ev in (self.primary_ev, self.check_ev, self.backup_ev):
            if ev is not None:
                ev.cancel()
        self.primary_ev = self.check_ev = self.backup_ev = None


class _NullSemaphore:
    """No-op semaphore for the single-owner DES path: the DES never
    blocks on ``processed_sem`` (completion is observed via
    ``state.stop``), so the per-message release is pure lock traffic."""

    __slots__ = ()

    def release(self, n: int = 1) -> None:
        pass

    def acquire(self, blocking: bool = True,
                timeout: Optional[float] = None) -> bool:
        return True


class SimExecutor:
    """Single-threaded DES strategy: the whole pipeline run — producers,
    consumers, WAN visibility, heartbeat monitoring, retries, crash
    injection, autoscaling — executes as events on one auto-advance
    :class:`SimClock`, bit-reproducibly. Single use: build one per run.

    Parameters
    ----------
    clock: the pipeline's auto-advance ``SimClock`` (adopted from the
        pipeline if omitted — the pipeline must then have been constructed
        with one, so broker/metrics stamps share the virtual timeline).
    service_model: prices ``Service`` effects (seconds per stage call) —
        how emulated runs charge compute time for stages whose real
        execution is instantaneous in virtual time.
    producer_offsets: per-device start offsets (virtual seconds) so edge
        devices don't boot in lockstep.
    crash_plan: objects with ``at_s`` / ``consumer_idx`` /
        ``restart_after_s`` / optional ``kind`` (``"crash"`` raises inside
        the consumer mid-run; ``"silent"`` goes dark so the heartbeat
        monitor must detect the loss). ``repro_torch.sim.scenarios.FailureSpec``
        matches this shape.
    drift_plan: mid-run environment drift events — objects with ``at_s``
        and ``kind`` (``"band"``: re-price a hop's live
        :class:`~repro_torch.core.broker.WanShaper` in place —
        ``hop``/``bandwidth_bps``/``rtt_s``; ``"churn"``: grow/shrink a
        consumer stage's fleet by ``delta`` — ``stage`` defaults to the
        final stage; ``"outage"``: kill every consumer of stages bound
        to ``tier``), each with optional ``restore_after_s``.
        ``repro_torch.sim.scenarios.DriftSpec`` matches this shape.  Scheduled
        as ordinary events, so drifted runs stay bit-reproducible.
    readvisor: a :class:`~repro_torch.cost.readvisor.ReAdvisor` watching the
        run's observed hop delay against the cost-model prediction; the
        executor ticks it every ``readvisor.interval_s`` of virtual time
        and applies its hot-swap decisions (stage re-bind + consumer
        migration).  ``pipe.run(readvise=...)`` is the other way to
        attach one.
    autoscaler: an :class:`~repro_torch.core.elastic.AutoScaler` for the *final*
        stage, stepped every ``autoscale_interval_s`` of virtual time;
        after each resize the executor grows/shrinks the live consumer
        pool to the pilot's worker count (scaling decisions visibly
        change the dataflow).
    autoscalers: per-stage policies — a mapping of stage (index, negative
        index, or stage name) to AutoScaler, each reconciling *its* stage's
        consumer pool.  Stage 0 (the sources) cannot be autoscaled.  May be
        combined with ``autoscaler`` (which is shorthand for the final
        stage); a bursty open-loop arrival process typically wants a
        policy on every consumer stage so traffic doesn't just queue at
        the first hop.
    speculative_factor: straggler speculation at service-charge
        granularity (default: the pipeline's ``speculative_factor``,
        mirroring :class:`TaskRuntime`'s knob under virtual time).  A
        Service charge still running past ``factor × trailing median``
        of its stage's completed charges spawns a backup — a fresh draw
        of the service model racing the primary as scheduled events,
        first completion wins (see :class:`SpeculationStats`).  The
        backup is capacity-aware work stealing: it occupies the first
        *idle* (parked) stage-mate's slot, which stops taking new
        messages until the race resolves — and when no stage-mate is
        idle the backup is skipped (``runtime.speculative_no_capacity``).
        Win / loss / cancel counts land in the run metrics and stay
        bit-identical across repeats.
    """

    def __init__(self, clock: Optional[SimClock] = None, *,
                 service_model: Optional[ServiceModel] = None,
                 producer_offsets: Sequence[float] = (),
                 crash_plan: Sequence[Any] = (),
                 drift_plan: Sequence[Any] = (),
                 readvisor=None,
                 autoscaler=None,
                 autoscalers: Optional[Dict[Any, Any]] = None,
                 autoscale_interval_s: float = 0.2,
                 monitor_interval_s: float = 0.5,
                 speculative_factor: Optional[float] = None):
        self.clock = clock
        self.service_model = service_model
        self.producer_offsets = tuple(producer_offsets)
        self.crash_plan = tuple(crash_plan)
        self.drift_plan = tuple(drift_plan)
        self.readvisor = readvisor
        self.autoscaler = autoscaler
        self.autoscalers = dict(autoscalers) if autoscalers else {}
        self.autoscale_interval_s = autoscale_interval_s
        self.monitor_interval_s = monitor_interval_s
        self.speculative_factor = speculative_factor
        self.speculation: Optional[SpeculationStats] = None
        self.sched: Optional[EventScheduler] = None

    def _prepare(self, pipe, n_messages: int, timeout_s: float,
                 collect_results: bool):
        clock = pipe._clock
        if self.clock is None:
            self.clock = clock
        if self.clock is not clock:
            raise ValueError(
                "SimExecutor clock must be the pipeline's clock object "
                "(broker/metrics/autoscaler all stamp the same timeline)")
        if not (isinstance(clock, SimClock) and clock.auto_advance):
            raise ValueError(
                "SimExecutor needs the pipeline built on an auto-advance "
                "SimClock: EdgeToCloudPipeline(..., clock=SimClock())")
        self.sched = EventScheduler(clock)
        return pipe._setup_run(n_messages, timeout_s, collect_results)

    def run(self, pipe, *, n_messages: int, timeout_s: float,
            collect_results: bool):
        state = self._prepare(pipe, n_messages, timeout_s, collect_results)
        return _SimRun(self, pipe, state).execute()

    def begin(self, pipe, *, n_messages: int, timeout_s: float,
              collect_results: bool) -> "_SimRun":
        """Windowed entry point (sharded DES): set up and *start* a run —
        spawn every actor, subscribe topic callbacks — without draining
        the scheduler.  The caller advances virtual time in bounded
        windows via ``advance_to(t)`` (conservative time-window
        synchronization), injects cross-shard boundary messages between
        windows, and calls ``finish()`` when ``done``."""
        state = self._prepare(pipe, n_messages, timeout_s, collect_results)
        run = _SimRun(self, pipe, state)
        run.start()
        return run


class _SimRun:
    """One SimExecutor pipeline run's actor/task bookkeeping."""

    def __init__(self, ex: SimExecutor, pipe, state):
        self.ex = ex
        self.pipe = pipe
        self.state = state
        self.sched = ex.sched
        self.clock = ex.clock
        self.metrics = pipe.metrics
        self.max_retries = pipe._runtime_kw["max_retries"]
        self.heartbeat_timeout_s = pipe._runtime_kw["heartbeat_timeout_s"]
        self.tasks: Dict[str, dict] = {}
        self.consumer_recs: List[dict] = []       # spawn order (autoscale)
        self._task_seq = itertools.count()
        self._subs: List = []                     # per-topic callbacks
        # (id(topic), partition) -> {id(wait): wait}: which parked
        # consumers an append to that partition can possibly wake — the
        # O(1) replacement for scanning every task per message
        self._waiters: Dict[Any, Dict[int, _PollWait]] = {}
        self._rebal_ev = None        # coalesced pending rebalance wake-all
        self.shared: dict = {}
        # per-stage autoscaling: the legacy single `autoscaler` is
        # shorthand for the final stage; `autoscalers` maps stage
        # index/name to a scaler. cid counters continue each stage's
        # static numbering.
        self.autoscalers: Dict[int, Any] = {}
        if ex.autoscaler is not None:
            self.autoscalers[len(pipe.stages) - 1] = ex.autoscaler
        for key, scaler in ex.autoscalers.items():
            si = self._resolve_stage(key)
            if si == 0:
                raise ValueError("stage 0 (the sources) cannot be "
                                 "autoscaled — sources are not consumers")
            self.autoscalers[si] = scaler
        # every consumer stage gets a cid counter continuing its static
        # numbering: autoscaling, churn drift, outage recovery and swap
        # migration all mint fresh cids from it
        self._stage_seq: Dict[int, Any] = {
            si: itertools.count(pipe.stage_tasks(si))
            for si in range(1, len(pipe.stages))}
        # online re-advisory: executor-level readvisor wins; otherwise the
        # one run(readvise=...) parked on the pipeline (captured here —
        # launch() clears pipe._readvise when begin() returns)
        self.readvisor = (ex.readvisor if ex.readvisor is not None
                          else getattr(pipe, "_readvise", None))
        self._rv_stage: Optional[int] = None
        factor = (ex.speculative_factor if ex.speculative_factor is not None
                  else pipe._runtime_kw["speculative_factor"])
        self.speculation = (SpeculationStats(factor, pipe.metrics)
                            if factor > 0 and ex.service_model is not None
                            else None)
        ex.speculation = self.speculation

    def _resolve_stage(self, key) -> int:
        stages = self.pipe.stages
        if isinstance(key, str):
            for i, st in enumerate(stages):
                if st.name == key:
                    return i
            raise ValueError(f"unknown stage {key!r} "
                             f"(have {[s.name for s in stages]})")
        si = int(key)
        if si < 0:
            si += len(stages)
        if not 0 <= si < len(stages):
            raise ValueError(f"stage index {key} out of range")
        return si

    # -- lifecycle ---------------------------------------------------------

    def _elide_locks(self) -> None:
        """Single-owner lock elision: this DES run is the only thread
        touching its pipeline, broker topics, metrics and run state, so
        every internal lock on the per-event path is pure overhead (the
        ``--profile`` mode shows lock acquire/release and the locked
        ``poll_nowait`` variant as the top non-algorithmic costs).  Real
        locks are restored in :meth:`finish` so the pipeline objects stay
        safe for a later threaded run."""
        state, pipe = self.state, self.pipe
        state.lock = NULL_LOCK
        state.processed_sem = _NullSemaphore()
        pipe._fn_lock = NULL_LOCK
        self.metrics.elide_lock(True)
        for topic in state.topics:
            topic.single_owner = True
        if self.speculation is not None:
            self.speculation._lock = NULL_LOCK

    def _restore_locks(self) -> None:
        self.pipe._fn_lock = threading.Lock()
        self.metrics.elide_lock(False)
        self.state.lock = threading.Lock()
        if self.speculation is not None:
            self.speculation._lock = threading.Lock()

    def start(self) -> None:
        """Spawn every actor and periodic tick; events run on the first
        ``advance_to`` call."""
        pipe, state = self.pipe, self.state
        t0 = self.t0 = self.clock.now()
        self.deadline = t0 + state.timeout_s
        self._finished = False
        self._elide_locks()
        for topic in state.topics:
            cb = (lambda partition, ready_at, topic=topic:
                  self._on_append(topic, partition, ready_at))
            self._subs.append((topic, cb))
            topic.subscribe(cb)
        offs = self.ex.producer_offsets
        for i, count in enumerate(state.per_device):
            off = offs[i] if i < len(offs) else 0.0
            self._spawn("producer", None, stage=0,
                        at=t0 + max(off, 0.0),
                        body=lambda ctx, i=i, c=count:
                        pipe._source_body(ctx, state, i, c))
        for si in range(1, len(pipe.stages)):
            for i in range(pipe.stage_tasks(si)):
                self._spawn_consumer(pipe.stage_cid(si, i), si, at=t0)
        for f in self.ex.crash_plan:
            self.sched.at(t0 + float(f.at_s), lambda f=f: self._inject(f))
        for d in self.ex.drift_plan:
            self.sched.at(t0 + float(d.at_s),
                          lambda d=d: self._apply_drift(d))
        rv = self.readvisor
        if rv is not None:
            self._rv_stage = self._resolve_stage(rv.stage)
            if self._rv_stage == 0:
                raise ValueError("the source stage cannot be re-advised — "
                                 "watch a consumer stage")
            rv.begin(t0)
            self.sched.at(t0 + rv.interval_s, self._readvise_tick)
        if self.autoscalers:
            self.sched.after(self.ex.autoscale_interval_s,
                             self._autoscale_tick)
        self.sched.after(self.ex.monitor_interval_s, self._monitor_tick)

    def advance_to(self, t: float) -> None:
        """Drain events up to virtual time ``min(t, deadline)``.  On a
        window that drains early the clock still advances to the window
        edge (``EventScheduler.run(until=)`` semantics), so every shard
        observes the same window boundary."""
        self.sched.run(until=min(t, self.deadline),
                       stop=self.state.stop.is_set)

    @property
    def done(self) -> bool:
        """The run can make no more progress on its own: the pipeline
        reported completion (``stop``) or no events remain scheduled
        (an injected boundary message re-arms the scheduler)."""
        return self.state.stop.is_set() or len(self.sched) == 0

    def finish(self):
        """Close the run and return its :class:`PipelineResult`."""
        state = self.state
        if self._finished:
            return self._result
        self._finished = True
        if state.t_done is None:
            state.t_done = min(self.clock.now(), self.deadline)
        state.stop.set()
        for topic, cb in self._subs:
            topic.unsubscribe(cb)
        # unresolved speculation races at run end: the loser was never
        # decided — account the launched backups as cancelled so
        # wins + losses + cancelled always equals launches
        for rec in list(self.tasks.values()):
            self._cancel_service(rec)
        self._restore_locks()
        self._result = self.pipe._finish(state, state.t_done - self.t0)
        return self._result

    def execute(self):
        # the whole run is one scheduler call: the loop stays inside
        # EventScheduler.run (no per-event next_time/step round-trip),
        # stopping the moment the pipeline reports completion
        self.start()
        try:
            self.advance_to(self.deadline)
        finally:
            result = self.finish()
        return result

    # -- task spawning -----------------------------------------------------

    def _spawn(self, kind: str, cid: Optional[str], *, stage: int, body,
               at: Optional[float] = None) -> dict:
        pilot = self.pipe.stages[stage].pilot
        pilot.require_active()
        rec = {"task_id": f"{pilot.pilot_id}-sim-{next(self._task_seq)}",
               "kind": kind, "cid": cid, "stage": stage,
               "make_body": body, "pilot": pilot,
               "group": (self.state.groups[stage - 1]
                         if kind == "consumer" else None),
               "attempt": 0, "retries_left": self.max_retries,
               "actor": None, "ctx": None, "wait": None, "svc": None,
               "pollwait": None,                  # reusable _PollWait slot
               "helping": None,
               "sleep_until": 0.0,   # framework-scheduled wake (timed sleep)
               "last_beat": self.clock.now(), "exit_reason": None}
        self.tasks[rec["task_id"]] = rec
        if kind == "consumer":
            self.consumer_recs.append(rec)
        self.metrics.incr("runtime.submitted")
        self._launch(rec, at=at)
        return rec

    def _spawn_consumer(self, cid: str, stage: int,
                        at: Optional[float] = None) -> dict:
        pipe, state = self.pipe, self.state
        return self._spawn(
            "consumer", cid, stage=stage, at=at,
            body=lambda ctx, cid=cid, stage=stage:
            pipe._stage_body(ctx, state, stage, cid))

    def _launch(self, rec: dict, at: Optional[float] = None) -> None:
        if self.state.stop.is_set() or rec["task_id"] not in self.tasks:
            return
        pilot = rec["pilot"]
        ctx = TaskContext(
            pilot_id=pilot.pilot_id, tier=pilot.tier,
            task_id=rec["task_id"], attempt=rec["attempt"],
            shared=self.shared, clock=self.clock,
            _heartbeat=lambda: self._beat(rec))
        rec["ctx"] = ctx
        rec["last_beat"] = self.clock.now()
        rec["actor"] = self.sched.spawn(
            rec["make_body"](ctx), name=rec["task_id"], at=at,
            interpret=lambda actor, eff: self._interpret(rec, actor, eff),
            on_exit=lambda actor, exc, res: self._on_exit(rec, exc))
        if rec["kind"] == "consumer":
            # the new member's join rebalances partition assignments —
            # parked survivors may now own pending messages. Scheduled at
            # the same timestamp (later insertion seq), this runs right
            # after the actor's first step, i.e. after its group.join.
            # Coalesced: a fleet of same-instant launches (startup, an
            # autoscale burst) triggers ONE wake-all, after the *last*
            # join — reschedule (cancel + re-push, later seq) instead of
            # stacking an O(fleet) wake-all per member. Any not-yet-fired
            # wake is for this same instant (events run in time order),
            # so moving it behind the newest join loses nothing.
            if self._rebal_ev is not None:
                self._rebal_ev.cancel()
            self._rebal_ev = self.sched.at(
                self.clock.now() if at is None else at, self._rebal_wake)

    def _beat(self, rec: dict) -> None:
        rec["last_beat"] = self.clock.now()

    # -- effect interpretation --------------------------------------------

    def _interpret(self, rec: dict, actor, eff: Any) -> None:
        self._beat(rec)
        if isinstance(eff, Sleep):
            # a timed sleep is framework-scheduled, not hung: record the
            # wake time so the monitor leaves the actor alone (open-loop
            # trace replay sleeps out arbitrarily long arrival gaps)
            delay = max(eff.seconds, 0.0)
            rec["sleep_until"] = self.clock.now() + delay
            actor.resume(None, delay=delay)
            return
        if isinstance(eff, Service):
            model = self.ex.service_model
            secs = (model(eff.stage, rec["ctx"], eff.payload)
                    if model is not None else 0.0)
            if self.speculation is not None and secs > 0.0:
                self._begin_service(rec, actor, eff, max(secs, 0.0))
                return
            secs = max(secs, 0.0)
            rec["sleep_until"] = self.clock.now() + secs
            actor.resume(None, delay=secs)
            return
        if isinstance(eff, Poll):
            self._attempt_poll(rec, actor, eff)
            return
        actor.kill(TypeError(f"unknown pipeline effect {eff!r}"))

    def _attempt_poll(self, rec: dict, actor, eff: Poll) -> None:
        if not actor.alive:
            return
        state = self.state
        if state.stop.is_set() or state.n_processed >= state.n_messages:
            rec["wait"] = None
            actor.resume(None)
            return
        msg, ready = eff.group.poll_nowait(eff.consumer_id)
        if msg is not None:
            rec["wait"] = None
            self._beat(rec)
            actor.resume(msg)
            return
        # park until an append / stop / the fallback wake. Parked on the
        # framework — including waiting out a WAN-crossing message's exact
        # ready_at — is not a hung task: the monitor skips recs with a
        # live wait, and _beat keeps the timestamps honest.
        self._beat(rec)
        wait = rec["pollwait"]
        if wait is None:
            wait = _PollWait(rec, actor, eff)
            rec["pollwait"] = wait
        else:
            wait.actor = actor
            wait.eff = eff
            wait.resolved = False
            wait.timeout_ev = None
            wait.gen += 1
        rec["wait"] = wait
        # index the wait under its assigned (topic, partition) keys so an
        # append wakes exactly the consumers that can see the message
        group = eff.group
        tid = id(group.topic)
        parts = group.partitions_for(eff.consumer_id)
        wait.topic_id = tid
        wait.parts = parts
        waiters = self._waiters
        for p in parts:
            d = waiters.get((tid, p))
            if d is None:
                waiters[(tid, p)] = d = {}
            d[id(wait)] = wait
        if ready is not None:
            # message in flight across the WAN: exact wakeup at ready_at
            wait.timeout_ev = self.sched.at(
                ready, lambda w=wait, g=wait.gen: self._wake(w, False, g))
        elif eff.wake_at is not None:
            wait.timeout_ev = self.sched.at(
                eff.wake_at,
                lambda w=wait, g=wait.gen: self._wake(w, True, g))

    def _unregister(self, wait: _PollWait) -> None:
        waiters, tid = self._waiters, wait.topic_id
        for p in wait.parts:
            d = waiters.get((tid, p))
            if d is not None:
                d.pop(id(wait), None)
        wait.parts = ()

    def _wake(self, wait: _PollWait, timed_out: bool,
              gen: Optional[int] = None) -> None:
        if gen is not None and gen != wait.gen:
            return                      # wake scheduled for an earlier park
        if wait.resolved or not wait.actor.alive:
            return
        wait.resolved = True
        self._unregister(wait)
        wait.rec["wait"] = None
        if wait.timeout_ev is not None:
            wait.timeout_ev.cancel()
            wait.timeout_ev = None
        self._beat(wait.rec)
        if timed_out or self.state.stop.is_set():
            wait.actor.resume(None)
            return
        self._attempt_poll(wait.rec, wait.actor, wait.eff)

    def _on_append(self, topic, partition: int, ready_at: float) -> None:
        d = self._waiters.get((id(topic), partition))
        if not d:
            return
        now = self.clock.now()
        if ready_at < now:
            ready_at = now
        for wait in d.values():
            if wait.resolved:
                continue
            # a registration can outlive a rebalance for an instant (the
            # rebalance's _wake_all_parked is what re-registers) — only
            # wake waiters actually assigned this partition right now
            if partition not in wait.eff.group.partitions_for(
                    wait.eff.consumer_id):
                continue
            self.sched.at(ready_at,
                          lambda w=wait, g=wait.gen: self._wake(w, False, g))

    def _rebal_wake(self) -> None:
        self._rebal_ev = None
        self._wake_all_parked()

    def _wake_all_parked(self) -> None:
        """Rebalance wakeup: membership changed (join/leave), so parked
        consumers may now be assigned partitions with pending messages."""
        for rec in list(self.tasks.values()):
            wait = rec["wait"]
            if wait is not None and not wait.resolved:
                self._wake(wait, False)

    # -- speculative Service races ----------------------------------------

    def _begin_service(self, rec: dict, actor, eff: Service,
                       primary_s: float) -> None:
        """Charge a Service effect as a cancellable completion event so a
        speculative backup can race it (the no-speculation path stays the
        plain ``resume(delay=secs)`` — identical event count)."""
        op = _ServiceOp(rec, actor, eff.stage, eff.payload,
                        self.clock.now())
        rec["svc"] = op
        op.primary_ev = self.sched.after(
            primary_s, lambda: self._svc_done(op, backup_won=False))
        th = self.speculation.threshold(eff.stage)
        # schedule the straggler check even when threshold >= primary_s:
        # the DES doesn't peek at the draw, it observes the deadline pass
        # (the completion event fires first and cancels the check)
        if th is not None:
            op.check_ev = self.sched.after(
                th, lambda: self._svc_speculate(op))

    def _idle_helper(self, rec: dict) -> Optional[dict]:
        """The first stage-mate (spawn order — deterministic) currently
        parked in a poll whose slot a backup can steal."""
        for r in self.consumer_recs:
            if r is rec or r["stage"] != rec["stage"]:
                continue
            if r["task_id"] not in self.tasks or r["helping"] is not None:
                continue
            wait = r["wait"]
            if (wait is not None and not wait.resolved
                    and r["actor"] is not None and r["actor"].alive):
                return r
        return None

    def _svc_speculate(self, op: _ServiceOp) -> None:
        """The primary charge outlived ``factor × median``: steal an idle
        stage-mate's slot (work stealing — the backup occupies a
        *different* consumer slot, never the straggler's own), launch the
        backup — a fresh draw of the service model — and let the two
        completion events race.  No idle slot → no backup."""
        op.check_ev = None
        if op.resolved or not op.actor.alive or self.state.stop.is_set():
            return
        helper = self._idle_helper(op.rec)
        if helper is None:
            self.speculation.no_capacity()
            return
        # steal the slot: the helper stops listening for new messages
        # until the race resolves (its suspended Poll is re-attempted on
        # release)
        op.helper = helper
        op.helper_eff = helper["wait"].eff
        self._clear_wait(helper)
        helper["helping"] = op
        self._beat(helper)
        backup_s = max(self.ex.service_model(op.stage, op.rec["ctx"],
                                             op.payload), 0.0)
        op.backup_launched = True
        self.speculation.launched()
        self._beat(op.rec)                 # the backup is making progress
        op.backup_ev = self.sched.after(
            backup_s, lambda: self._svc_done(op, backup_won=True))

    def _release_helper(self, op: _ServiceOp) -> None:
        """Hand a stolen slot back: the helper resumes polling (unless
        the run is over or the helper died meanwhile)."""
        helper, eff = op.helper, op.helper_eff
        op.helper = op.helper_eff = None
        if helper is None:
            return
        if helper["helping"] is op:
            helper["helping"] = None
        self._beat(helper)
        if (helper["task_id"] in self.tasks
                and helper["actor"] is not None and helper["actor"].alive
                and not self.state.stop.is_set()):
            self._attempt_poll(helper, helper["actor"], eff)

    def _abort_lend(self, rec: dict) -> None:
        """A lent-out helper died (crash / silent loss / heartbeat): the
        slot its backup was running on is gone, so the backup dies with
        it — accounted as cancelled; the primary keeps running."""
        op = rec["helping"]
        if op is None:
            return
        rec["helping"] = None
        if op.resolved or not op.backup_launched:
            return
        if op.backup_ev is not None:
            op.backup_ev.cancel()
            op.backup_ev = None
        op.backup_launched = False
        op.helper = op.helper_eff = None
        self.speculation.cancelled()

    def _svc_done(self, op: _ServiceOp, backup_won: bool) -> None:
        if op.resolved or not op.actor.alive:
            return
        op.resolved = True
        op.cancel_events()
        op.rec["svc"] = None
        if op.backup_launched:
            self.speculation.resolved(backup_won)
        self._release_helper(op)
        self.speculation.record(op.stage, self.clock.now() - op.t0)
        self._beat(op.rec)
        op.actor.resume(None)

    def _cancel_service(self, rec: dict) -> None:
        """Abort an in-flight Service race (actor died / run ended): a
        launched-but-unresolved backup counts as cancelled and its stolen
        slot is handed back."""
        op = rec["svc"]
        if op is None:
            return
        rec["svc"] = None
        if op.resolved:
            return
        op.resolved = True
        op.cancel_events()
        if op.backup_launched:
            self.speculation.cancelled()
        self._release_helper(op)

    def _clear_wait(self, rec: dict) -> None:
        wait = rec["wait"]
        if wait is not None:
            wait.resolved = True
            self._unregister(wait)
            if wait.timeout_ev is not None:
                wait.timeout_ev.cancel()
                wait.timeout_ev = None
            rec["wait"] = None

    def _release_inflight(self, rec: dict) -> None:
        """A silently-dropped consumer can die holding a dedup reservation
        (its generator is never thrown into, so the body's exception
        handler can't release it). Release it here or the redeliveries of
        that message would be dropped as duplicates forever."""
        mid = self.state.inflight.pop(
            (rec["stage"], rec["cid"], rec["attempt"]), None)
        if mid is not None:
            with self.state.lock:
                self.state.seen[rec["stage"] - 1].discard(mid)

    # -- exits / failures / retries ---------------------------------------

    def _on_exit(self, rec: dict, exc: Optional[BaseException]) -> None:
        rec["actor"] = None
        self._clear_wait(rec)
        self._cancel_service(rec)
        self._abort_lend(rec)
        if exc is None:
            self.tasks.pop(rec["task_id"], None)
            self.metrics.incr("runtime.completed")
            return
        if isinstance(exc, ActorKilled):
            self.tasks.pop(rec["task_id"], None)
            if rec["kind"] == "consumer":
                rec["group"].leave(rec["cid"])
                self._wake_all_parked()
            if rec["exit_reason"] == "retire":
                self.metrics.event("consumer_retired", consumer=rec["cid"])
            else:
                self.metrics.event("consumer_crashed", consumer=rec["cid"])
            return
        self._task_error(rec, exc)

    def _task_error(self, rec: dict, exc: BaseException) -> None:
        self.metrics.incr("runtime.task_errors")
        self.metrics.event("task_error", task_id=rec["task_id"],
                           error=repr(exc)[:200])
        retries = rec["retries_left"]
        rec["retries_left"] = retries - 1
        if retries > 0 and not self.state.stop.is_set():
            self.metrics.incr("runtime.retries")
            rec["attempt"] += 1
            delay = 0.01 * (2 ** (self.max_retries - retries))
            self.sched.after(delay, lambda: self._launch(rec))
        else:
            self.tasks.pop(rec["task_id"], None)
            if rec["kind"] == "consumer":
                # free the failed member's partitions for the survivors
                rec["group"].leave(rec["cid"])
                self._wake_all_parked()
            self.metrics.event("task_failed", task_id=rec["task_id"])

    # -- crash / rebalance injection --------------------------------------

    def _inject(self, f: Any) -> None:
        if self.state.stop.is_set():
            return
        cid = f"consumer-{f.consumer_idx}"
        rec = next((r for r in self.consumer_recs
                    if r["cid"] == cid and r["actor"] is not None
                    and r["actor"].alive), None)
        if rec is not None:
            if getattr(f, "kind", "crash") == "silent":
                # the node goes dark: no exception, no cleanup — only the
                # heartbeat monitor can notice (frozen last_beat)
                rec["actor"].drop()
                self._clear_wait(rec)
                self._cancel_service(rec)
                self._abort_lend(rec)
                self._release_inflight(rec)
                rec["sleep_until"] = 0.0   # dark node: no known wake
            else:
                rec["exit_reason"] = "crash"
                rec["actor"].kill()
        restart = getattr(f, "restart_after_s", None)
        if restart is not None:
            self.sched.after(float(restart),
                             lambda: self._restart(f"{cid}-r"))

    def _restart(self, cid: str) -> None:
        if self.state.stop.is_set():
            return
        self.metrics.event("consumer_restarted", consumer=cid)
        self._spawn_consumer(cid, len(self.pipe.stages) - 1)

    # -- drift injection ---------------------------------------------------

    def _apply_drift(self, d: Any) -> None:
        """Apply one scheduled drift event (band / churn / outage) — an
        ordinary DES event, so drifted runs stay bit-reproducible."""
        if self.state.stop.is_set():
            return
        kind = getattr(d, "kind", "band")
        if kind == "band":
            self._drift_band(d)
        elif kind == "churn":
            self._drift_churn(d)
        elif kind == "outage":
            self._drift_outage(d)
        else:
            raise ValueError(f"unknown drift kind {kind!r}")

    def _drift_band(self, d: Any) -> None:
        """Re-price a hop's live shaper in place: the token bucket's
        ``_available_at`` backlog survives, so traffic already queued
        behind the old band drains at the *new* rate — what a real link
        degradation does to in-flight transfers."""
        topics = self.state.topics
        hop = int(getattr(d, "hop", -1) if getattr(d, "hop", None)
                  is not None else -1)
        if hop < 0:
            hop += len(topics)
        if not 0 <= hop < len(topics):
            raise ValueError(f"drift hop {hop} out of range "
                             f"(pipeline has {len(topics)} hops)")
        topic = topics[hop]
        shaper = topic.shaper
        old = None
        if shaper is None:
            shaper = WanShaper(bandwidth_bps=float(d.bandwidth_bps),
                               rtt_s=float(d.rtt_s), sleep=False)
            topic.shaper = shaper
            self.pipe._shapers[hop] = shaper
        else:
            old = (shaper.bandwidth_bps, shaper.rtt_s)
            if getattr(d, "bandwidth_bps", None) is not None:
                shaper.bandwidth_bps = float(d.bandwidth_bps)
            if getattr(d, "rtt_s", None) is not None:
                shaper.rtt_s = float(d.rtt_s)
        self.metrics.event("drift_band", hop=hop,
                           bandwidth_bps=shaper.bandwidth_bps,
                           rtt_s=shaper.rtt_s)
        restore = getattr(d, "restore_after_s", None)
        if restore is not None and old is not None:
            def _restore(shaper=shaper, old=old, hop=hop):
                if self.state.stop.is_set():
                    return
                shaper.bandwidth_bps, shaper.rtt_s = old
                self.metrics.event("drift_band_restored", hop=hop)
            self.sched.after(float(restore), _restore)

    def _churn(self, si: int, delta: int) -> None:
        """Grow (``delta > 0``) or retire (``delta < 0``) stage ``si``'s
        live consumer fleet — the shared core of churn drift and its
        restore."""
        if delta > 0:
            for _ in range(delta):
                cid = self.pipe.stage_cid(si, next(self._stage_seq[si]))
                self.metrics.event("consumer_spawned", consumer=cid)
                self._spawn_consumer(cid, si)
        elif delta < 0:
            alive = self._alive_consumers(si)
            for rec in alive[delta:]:          # retire the newest first
                if rec["actor"] is not None and rec["actor"].alive:
                    rec["exit_reason"] = "retire"
                    rec["actor"].kill()

    def _drift_churn(self, d: Any) -> None:
        si = (self._resolve_stage(d.stage)
              if getattr(d, "stage", None) is not None
              else len(self.pipe.stages) - 1)
        if si == 0:
            raise ValueError("stage 0 (the sources) cannot churn — "
                             "sources are not consumers")
        delta = int(getattr(d, "delta", 0))
        self._churn(si, delta)
        self.metrics.event("drift_churn", stage=self.pipe.stages[si].name,
                           delta=delta)
        restore = getattr(d, "restore_after_s", None)
        if restore is not None and delta:
            def _restore(si=si, delta=delta):
                if self.state.stop.is_set():
                    return
                self._churn(si, -delta)
                self.metrics.event("drift_churn_restored",
                                   stage=self.pipe.stages[si].name)
            self.sched.after(float(restore), _restore)

    def _drift_outage(self, d: Any) -> None:
        """A whole tier goes dark: every live consumer of stages bound to
        that tier is killed at once (crash semantics — group rebalance
        frees their partitions immediately).  ``restore_after_s`` brings
        the same head-counts back as fresh members."""
        tier = d.tier
        counts: Dict[int, int] = {}
        for si in range(1, len(self.pipe.stages)):
            if self.pipe.stages[si].pilot.tier != tier:
                continue
            alive = self._alive_consumers(si)
            counts[si] = len(alive)
            for rec in alive:
                if rec["actor"] is not None and rec["actor"].alive:
                    rec["exit_reason"] = "outage"
                    rec["actor"].kill()
        self.metrics.event("drift_outage", tier=tier,
                           consumers=sum(counts.values()))
        restore = getattr(d, "restore_after_s", None)
        if restore is not None:
            def _restore(counts=counts, tier=tier):
                if self.state.stop.is_set():
                    return
                for si, n in counts.items():
                    self._churn(si, n)
                self.metrics.event("drift_outage_restored", tier=tier)
            self.sched.after(float(restore), _restore)

    # -- online re-advisory (hot-swap) ------------------------------------

    def _readvise_tick(self) -> None:
        # like _monitor_tick: stop rescheduling once the run is over (or,
        # in a sharded run with no local sources, was never fed) so the
        # scheduler can drain and the shard can report done
        if self.state.stop.is_set() or not self.tasks:
            return
        rv, si, pipe = self.readvisor, self._rv_stage, self.pipe
        dec = rv.step(now=self.clock.now(), metrics=self.metrics,
                      topic=self.state.topics[si - 1].name,
                      current_tier=pipe.stages[si].pilot.tier,
                      src_tier=pipe.stages[si - 1].pilot.tier)
        if dec is not None:
            self.metrics.event("readvise_decision",
                               stage=pipe.stages[si].name,
                               from_tier=dec.from_tier,
                               to_tier=dec.to_tier)
            self.sched.after(rv.apply_delay_s,
                             lambda: self._apply_swap(dec))
        self.sched.after(rv.interval_s, self._readvise_tick)

    def _apply_swap(self, dec: Any) -> None:
        """Execute a re-advisory decision: re-bind the watched stage to
        the winning tier's pilot, then migrate its consumer fleet."""
        if self.state.stop.is_set():
            return
        rv, si, pipe = self.readvisor, self._rv_stage, self.pipe
        pipe.rebind_stage(pipe.stages[si].name, rv.pilot_for(dec.to_tier))
        self._migrate_stage(si)
        rv.applied(dec, self.clock.now())

    def _migrate_stage(self, si: int) -> None:
        """Epoch-based graceful migration: bump the stage's placement
        epoch (old-generation consumers drain out at their next loop top
        — any message they hold finishes and commits under the swapped
        binding first), nudge parked members so they notice now instead
        of at their idle deadline, and spawn a same-size replacement
        fleet on the new pilot.  The overlap window is covered by the
        hop's at-least-once + dedup machinery."""
        state = self.state
        state.stage_epoch[si] = state.stage_epoch.get(si, 0) + 1
        old = self._alive_consumers(si)
        for rec in old:
            wait = rec["wait"]
            if wait is not None and not wait.resolved:
                # timed_out=True resumes None: the body loops without
                # grabbing a message and hits the epoch check
                self._wake(wait, True)
        for _ in range(len(old)):
            cid = self.pipe.stage_cid(si, next(self._stage_seq[si]))
            self.metrics.event("consumer_spawned", consumer=cid)
            self._spawn_consumer(cid, si)

    # -- periodic machinery: heartbeats + autoscaler ----------------------

    def _monitor_tick(self) -> None:
        if self.state.stop.is_set() or not self.tasks:
            return
        now = self.clock.now()
        for rec in list(self.tasks.values()):
            if rec["wait"] is not None:        # parked = framework-idle
                continue
            if rec["helping"] is not None:     # lent to a backup race —
                continue                       # framework-busy, not hung
            if rec["actor"] is None:           # between retry launches
                continue
            if rec["sleep_until"] > now:       # timed sleep, known wake
                continue
            if now - rec["last_beat"] > self.heartbeat_timeout_s:
                rec["actor"].drop()
                rec["actor"] = None
                self._cancel_service(rec)
                self._abort_lend(rec)
                if rec["kind"] == "consumer":
                    self._release_inflight(rec)
                    # session timeout: rebalance the lost member out
                    rec["group"].leave(rec["cid"])
                    self._wake_all_parked()
                    self.metrics.event("consumer_lost", consumer=rec["cid"])
                self._task_error(
                    rec, TimeoutError(
                        f"heartbeat lost ({rec['task_id']})"))
        self.sched.after(self.ex.monitor_interval_s, self._monitor_tick)

    def _alive_consumers(self, stage: Optional[int] = None) -> List[dict]:
        """Consumers of ``stage`` (default: final) still alive — the pool
        that stage's autoscaler grows/shrinks (stages without a policy
        keep their static pools)."""
        if stage is None:
            stage = len(self.pipe.stages) - 1
        return [r for r in self.consumer_recs
                if r["stage"] == stage and r["task_id"] in self.tasks]

    def _autoscale_tick(self) -> None:
        if self.state.stop.is_set():
            return
        for si in sorted(self.autoscalers):
            scaler = self.autoscalers[si]
            scaler.step_once()
            target = self.pipe.stages[si].pilot.resource.n_workers
            alive = self._alive_consumers(si)
            if target > len(alive):
                for _ in range(target - len(alive)):
                    cid = self.pipe.stage_cid(si, next(self._stage_seq[si]))
                    self.metrics.event("consumer_spawned", consumer=cid)
                    self._spawn_consumer(cid, si)
            elif target < len(alive):
                for rec in alive[target:]:     # retire the newest first
                    if rec["actor"] is not None and rec["actor"].alive:
                        rec["exit_reason"] = "retire"
                        rec["actor"].kill()
        self.sched.after(self.ex.autoscale_interval_s, self._autoscale_tick)
