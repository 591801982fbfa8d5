"""FaaS API: ContinuumPipeline (N tiers) + EdgeToCloudPipeline (paper
§II-C, Listings 1 & 2).

The paper's pilot abstraction places tasks *anywhere along the
edge-to-cloud continuum*, so the pipeline is an N-stage dataflow, not a
hardwired edge→cloud pair:

* :class:`StageSpec` — one stage: a plain Python handler bound to a pilot
  (or ``placement='auto'`` to let the :class:`PlacementEngine` bind it),
* :class:`ContinuumPipeline` — N ordered stages connected by broker
  topics; every hop between consecutive stage tiers rides the continuum
  topology's *routed* link (multi-hop paths collapse to their
  serialized-equivalent bandwidth + accumulated latency) and stamps the
  shared MetricsRegistry,
* :class:`EdgeToCloudPipeline` — the paper's Listing-2 object, now a thin
  two-stage wrapper (``produce``[+``process_edge``] → broker →
  ``process_cloud``) so the historical API and every Fig-3 golden keep
  working unchanged.

A 4-tier device/edge/fog/cloud run is just four StageSpecs::

    ContinuumPipeline(stages=[
        StageSpec("sense", sense_fn, pilot=pilot_device),
        StageSpec("edge_agg", edge_fn, pilot=pilot_edge),
        StageSpec("fog_agg", fog_fn, pilot=pilot_fog),
        StageSpec("train", train_fn, pilot=pilot_cloud),
    ], function_context={...}).run(n_messages=512)

Execution strategy: the stage loops are cooperative generator bodies (see
:mod:`repro_torch.core.executor`) selected by ``run(scheduler=)``:

* ``ThreadedExecutor`` (default) — real threads;
* ``SimExecutor`` — the same genuine pipeline as a single-threaded
  discrete-event simulation under an auto-advance
  :class:`~repro_torch.sim.clock.SimClock`, bit-reproducible run to run.

Dynamism (paper §II-D): ``replace_function(stage, fn)`` hot-swaps a
stage's payload at runtime *without* re-allocating pilots, and pilots can
be resized through the PilotManager while the pipeline runs (the
AutoScaler drives the final stage's pool inside the DES — see
``SimExecutor(autoscaler=...)``).
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from repro_torch.core.broker import Broker, ConsumerGroup, Topic, WanShaper
from repro_torch.core.executor import Poll, Service, Sleep, ThreadedExecutor
from repro_torch.core.monitoring import MetricsRegistry
from repro_torch.core.params_service import ParameterService
from repro_torch.core.pilot import Pilot
from repro_torch.core.placement import PlacementEngine, TaskProfile
from repro_torch.core.runtime import TaskContext
from repro_torch.sim.clock import Clock, as_clock

ProduceFn = Callable[[TaskContext], Any]
ProcessFn = Callable[..., Any]

_run_ids = itertools.count()


@dataclass(frozen=True)
class StageSpec:
    """One stage of a :class:`ContinuumPipeline`.

    The source stage's ``handler`` has the produce signature
    ``f(ctx) -> data``; every later stage processes:
    ``f(ctx, data=None) -> data`` (the last stage's return value is the
    collected result).  Bind the stage to a ``pilot`` explicitly, or set
    ``placement='auto'`` and let the pipeline's
    :class:`~repro_torch.core.placement.PlacementEngine` pick from the
    candidates handed to the constructor.  ``n_tasks`` is the stage's
    parallel task count (source: devices; consuming stages: consumers) —
    default: the bound pilot's worker count.
    """
    name: str
    handler: ProcessFn
    pilot: Optional[Pilot] = None
    placement: str = "explicit"        # explicit | auto
    n_tasks: Optional[int] = None


@dataclass
class PipelineResult:
    """What ``run`` returns: results + the linked metrics for Fig 2/3."""
    results: List[Any]
    metrics: MetricsRegistry
    n_produced: int
    n_processed: int
    wall_s: float

    def throughput(self):
        return self.metrics.throughput("processed")

    def latency(self):
        return self.metrics.summary("produced", "processed")

    def per_hop(self):
        return self.metrics.per_hop_latency()


@dataclass
class _RunState:
    """Per-``run`` shared state between the task bodies and the strategy.
    One topic/group/dedup-set per hop (stage ``i`` consumes
    ``topics[i-1]`` and produces into ``topics[i]``)."""
    topics: List[Topic]
    groups: List[ConsumerGroup]
    per_device: List[int]
    n_messages: int
    timeout_s: float
    collect: bool
    # open-loop traffic: per-device sorted absolute arrival times (seconds
    # from run start). None = closed-loop (devices produce back-to-back,
    # paced only by the service model).
    arrivals: Optional[List[Sequence[float]]] = None
    results: List[Any] = field(default_factory=list)
    seen: List[set] = field(default_factory=list)
    # (stage_idx, cid, attempt) -> msg_id currently holding a dedup
    # reservation, so the executor can release it if the attempt dies
    # without unwinding
    inflight: Dict = field(default_factory=dict)
    # stage name -> consumers currently parked in a poll (the threaded
    # strategy's idle-slot ledger for capacity-aware speculation)
    idle: Dict[str, int] = field(default_factory=dict)
    # stage idx -> placement epoch: bumped by a live hot-swap
    # (rebind_stage + executor migration). Consumers capture the epoch at
    # spawn and drain out gracefully when it moves past them, so swapped
    # stages never have two generations pulling from one group at once
    # beyond the hand-off window.
    stage_epoch: Dict[int, int] = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)
    stop: threading.Event = field(default_factory=threading.Event)
    processed_sem: threading.Semaphore = field(
        default_factory=lambda: threading.Semaphore(0))
    n_processed: int = 0
    t_done: Optional[float] = None      # clock time the target was reached


class ContinuumPipeline:
    """N ordered stages along the continuum, connected by broker topics.

    Each hop ``stage[i] → stage[i+1]`` gets its own topic; when the two
    stages sit on different tiers the hop is shaped by a
    :class:`~repro_torch.core.broker.WanShaper` priced from the continuum
    topology's *routed* path between the tiers (multi-hop routes collapse
    to their serialized-equivalent bandwidth and accumulated latency).
    Pass ``shapers=[...]`` (one entry per hop, ``None`` = unshaped) to
    override.

    ``placement='auto'`` stages are bound at construction by scoring
    ``candidate_pilots`` through the placement engine (data flows from
    the previous stage's tier).
    """

    def __init__(self, *,
                 stages: Sequence[StageSpec],
                 function_context: Optional[dict] = None,
                 n_partitions: Optional[int] = None,
                 topic_name: str = "continuum",
                 shapers: Optional[Sequence[Optional[WanShaper]]] = None,
                 broker: Optional[Broker] = None,
                 parameter_service: Optional[ParameterService] = None,
                 placement: str = "explicit",
                 placement_engine: Optional[PlacementEngine] = None,
                 candidate_pilots: Optional[Mapping[str, Sequence[Pilot]]]
                 = None,
                 metrics: Optional[MetricsRegistry] = None,
                 max_retries: int = 2,
                 speculative_factor: float = 0.0,
                 heartbeat_timeout_s: float = 30.0,
                 truncate_logs: Optional[int] = None,
                 clock: Optional[Clock] = None):
        if len(stages) < 2:
            raise ValueError("a pipeline needs a source stage and at "
                             "least one processing stage")
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"stage names must be unique, got {names}")
        if "consumer" in names[:-1]:
            # the final stage owns the "consumer-{i}" cid namespace that
            # crash injection, restarts and autoscaling address — an
            # intermediate stage of that name would collide with it
            raise ValueError(
                "'consumer' is reserved for the final stage's task ids; "
                "rename the intermediate stage")
        # an auto-advance SimClock here means the pipeline is destined for
        # run(scheduler=SimExecutor(...)); ThreadedExecutor re-checks and
        # rejects it at run time (threads can't coordinate on a clock that
        # fast-forwards under them).
        self._clock = as_clock(clock)
        self.metrics = metrics or MetricsRegistry(clock=self._clock)
        self.broker = broker or Broker(metrics=self.metrics,
                                       clock=self._clock)
        self.params = parameter_service or ParameterService(
            metrics=self.metrics)
        self.context = dict(function_context or {})
        self.placement_engine = placement_engine or PlacementEngine()
        self.placement = placement
        self.stages: List[StageSpec] = self._resolve_stages(
            list(stages), candidate_pilots or {})
        self.topic_name = topic_name
        # paper baseline: one partition per source device, the ratio kept
        # constant along every hop
        self.n_partitions = n_partitions or self.stage_tasks(0)
        if self.n_partitions <= 0:
            raise ValueError(
                "pipeline needs n_partitions >= 1; pass n_partitions= "
                "explicitly when the source stage has n_tasks=0")
        self._fns: Dict[str, Optional[ProcessFn]] = {
            s.name: s.handler for s in self.stages}
        self._fn_lock = threading.Lock()
        if shapers is None:
            self._shapers = [
                self._hop_shaper(a.pilot.tier, b.pilot.tier)
                for a, b in zip(self.stages[:-1], self.stages[1:])]
        else:
            if len(shapers) != len(self.stages) - 1:
                raise ValueError(
                    f"need one shaper per hop ({len(self.stages) - 1}), "
                    f"got {len(shapers)}")
            self._shapers = list(shapers)
        self._runtime_kw = dict(max_retries=max_retries,
                                speculative_factor=speculative_factor,
                                heartbeat_timeout_s=heartbeat_timeout_s,
                                clock=self._clock)
        # broker-log retention: reclaim hop-topic prefixes below the
        # group-minimum committed offset in batches of this many messages
        # (None = keep everything, the historical behavior).  Reclaimed
        # msg_ids are also evicted from the per-hop dedup sets, so pipeline
        # memory stays bounded — at the cost of windowed (not run-long)
        # duplicate suppression; see README "DES at 10M".
        self.truncate_logs = truncate_logs
        self._topics: List[Topic] = []
        self._topic: Optional[Topic] = None
        self._group: Optional[ConsumerGroup] = None
        self._run_groups: List[ConsumerGroup] = []
        self._arrival_plan: Optional[List[Sequence[float]]] = None
        # live online re-advisory: run(readvise=...) parks the ReAdvisor
        # here for the duration of the call; executors pick it up in
        # begin()/run() exactly like _arrival_plan
        self._readvise = None

    # -- construction helpers ------------------------------------------------

    def _resolve_stages(self, stages: List[StageSpec],
                        candidates: Mapping[str, Sequence[Pilot]]
                        ) -> List[StageSpec]:
        """Bind ``placement='auto'`` stages to the best candidate pilot
        (late binding, the paper's placement decision)."""
        import dataclasses
        resolved: List[StageSpec] = []
        for i, st in enumerate(stages):
            if st.pilot is not None:
                resolved.append(st)
                continue
            if st.placement != "auto":
                raise ValueError(
                    f"stage {st.name!r} has no pilot; bind one or set "
                    f"placement='auto' with candidate_pilots")
            cands = list(candidates.get(st.name, ()))
            if not cands:
                raise ValueError(
                    f"stage {st.name!r} is placement='auto' but no "
                    f"candidate_pilots[{st.name!r}] were provided")
            in_tier = (resolved[i - 1].pilot.tier if i > 0 else "edge")
            profile = TaskProfile(
                flops=float(self.context.get("task_flops", 1e9)),
                input_bytes=float(self.context.get("message_bytes", 1e6)),
                input_tier=in_tier,
                preferred_tiers=tuple(
                    self.context.get("preferred_tiers", ())))
            pilot = self.placement_engine.place(profile, cands).pilot
            resolved.append(dataclasses.replace(st, pilot=pilot))
        return resolved

    def _hop_shaper(self, src_tier: str,
                    dst_tier: str) -> Optional[WanShaper]:
        """Shape a hop by the routed link between its tiers (None for
        intra-tier hops — local traffic is not shaped)."""
        if src_tier == dst_tier:
            return None
        link = self.placement_engine.cost.route(src_tier,
                                                dst_tier).as_link()
        return WanShaper(bandwidth_bps=link.bandwidth_bps,
                         rtt_s=link.latency_s, sleep=False)

    def stage_tasks(self, idx: int) -> int:
        """Parallel task count of stage ``idx`` (negative ok).  An
        explicit ``n_tasks=0`` is honored (a sharded run's remote half
        owns that stage's tasks); only ``None`` falls back to the bound
        pilot's worker count."""
        st = self.stages[idx]
        if st.n_tasks is not None:
            return st.n_tasks
        return st.pilot.resource.n_workers

    def stage_cid(self, idx: int, i: int) -> str:
        """Consumer id of stage ``idx``'s ``i``-th task — the one naming
        rule both executors share.  The final stage owns the
        ``consumer-{i}`` namespace (crash injection, restarts and
        autoscaling address final-stage members by it); intermediate
        stages prefix with their own (reserved-checked) name."""
        if idx % len(self.stages) == len(self.stages) - 1:
            return f"consumer-{i}"
        return f"{self.stages[idx].name}-{i}"

    @property
    def n_source_tasks(self) -> int:
        return self.stage_tasks(0)

    @property
    def n_edge_devices(self) -> int:
        """Legacy alias: the source stage's device count."""
        return self.stage_tasks(0)

    @property
    def cloud_consumers(self) -> int:
        """Legacy alias: the final stage's consumer count."""
        return self.stage_tasks(-1)

    @property
    def stage_tiers(self) -> List[str]:
        """The per-stage execution tier vector (placement advisories and
        bench rows carry this)."""
        return [s.pilot.tier for s in self.stages]

    # -- dynamism ------------------------------------------------------------

    def replace_function(self, stage: str, fn: ProcessFn) -> None:
        """Hot-swap a stage payload at runtime (paper §II-D). No pilot
        re-allocation; in-flight messages finish under the old function."""
        if stage not in self._fns:
            raise KeyError(stage)
        with self._fn_lock:
            self._fns[stage] = fn
        self.metrics.event("function_replaced", stage=stage,
                           fn=getattr(fn, "__name__", repr(fn)))

    def _fn(self, stage: str) -> Optional[ProcessFn]:
        with self._fn_lock:
            return self._fns[stage]

    def rebind_stage(self, stage: str, pilot: Pilot) -> int:
        """Re-bind a stage to a different pilot at runtime — the placement
        half of a hot-swap (``replace_function`` is the payload half).
        Re-prices the adjacent hops' shapers from the routed link between
        the *new* tier pair, mutating the live run's hop topics in place
        so queued-but-unsent traffic rides the new link.  Returns the
        stage index.  The executors' migration machinery (epoch bump +
        consumer respawn) is what actually moves the running tasks; this
        method only flips the bindings."""
        import dataclasses
        names = [s.name for s in self.stages]
        try:
            idx = names.index(stage)
        except ValueError:
            raise KeyError(stage) from None
        old_tier = self.stages[idx].pilot.tier
        self.stages[idx] = dataclasses.replace(self.stages[idx],
                                               pilot=pilot)
        for hop in (idx - 1, idx):
            if not 0 <= hop < len(self.stages) - 1:
                continue
            shaper = self._hop_shaper(self.stages[hop].pilot.tier,
                                      self.stages[hop + 1].pilot.tier)
            old = self._shapers[hop]
            if old is not None and shaper is not None:
                # keep the live shaper object (its _available_at token
                # bucket holds queued traffic) and re-price it
                old.bandwidth_bps = shaper.bandwidth_bps
                old.rtt_s = shaper.rtt_s
            else:
                self._shapers[hop] = shaper
                if hop < len(self._topics):
                    self._topics[hop].shaper = shaper
        self.metrics.event("stage_rebound", stage=stage,
                           from_tier=old_tier, to_tier=pilot.tier)
        return idx

    def current_lag(self) -> int:
        """Broker lag of the live run's final consumer group — the
        natural ``lag_fn`` for an :class:`~repro_torch.core.elastic.AutoScaler`
        watching this pipeline (0 when no run is active)."""
        g = self._group
        return g.lag() if g is not None else 0

    def stage_lag(self, stage_idx: int) -> int:
        """Broker lag of stage ``stage_idx``'s consumer group in the live
        run (0 when no run is active) — the per-stage ``lag_fn`` for
        per-stage autoscaling policies.  Stage 1..N-1 (stage 0, the
        sources, consumes nothing)."""
        groups = self._run_groups
        if not groups:
            return 0
        if not 1 <= stage_idx < len(self.stages):
            raise ValueError(f"stage_lag wants a consumer stage index in "
                             f"[1, {len(self.stages) - 1}], got {stage_idx}")
        return groups[stage_idx - 1].lag()

    # -- task bodies (cooperative; interpreted by the strategy) ---------------

    def _invoke_source(self, ctx: TaskContext) -> Any:
        return self._fn(self.stages[0].name)(ctx)

    def _source_body(self, ctx: TaskContext, state: _RunState,
                     device_idx: int, count: int):
        """One source device: generate → first topic, ``count`` times.

        Closed-loop (``state.arrivals is None``): produce back-to-back,
        each message charged ``Service(<source stage>)`` — the strategy's
        per-message generation cost (zero unless a service model is set).

        Open-loop (``state.arrivals`` set): the device releases messages
        at its pre-drawn absolute arrival times — traffic intensity is a
        property of the *arrival process*, not of how fast the pipeline
        drains, so bursts genuinely queue.  Generation cost is not
        charged (the arrival time already embodies when the message
        exists).

        One reused effect record per kind: the interpreter consumes the
        effect synchronously at the yield, so mutating it next iteration
        is safe — and a million-message run skips a million allocations.
        """
        topic = state.topics[0]
        partition = device_idx % self.n_partitions
        stage_name = self.stages[0].name
        arrivals = (state.arrivals[device_idx]
                    if state.arrivals is not None else None)
        if arrivals is not None:
            t0 = ctx.clock.now()
            slp = Sleep(0.0)
            for t_arr in arrivals:
                dt = t0 + t_arr - ctx.clock.now()
                if dt > 0:
                    slp.seconds = dt
                    yield slp
                if state.stop.is_set():
                    return
                data = self._invoke_source(ctx)
                topic.produce(data, partition=partition)
                ctx.heartbeat()
            return
        svc = Service(stage_name)
        for _ in range(count):
            if state.stop.is_set():
                return
            data = self._invoke_source(ctx)
            svc.payload = data
            yield svc
            svc.payload = None
            if state.stop.is_set():
                return
            topic.produce(data, partition=partition)
            ctx.heartbeat()

    def _stage_body(self, ctx: TaskContext, state: _RunState,
                    stage_idx: int, cid: str):
        """One consumer of stage ``stage_idx``: join the group, then
        poll → dedup → process → forward/collect → commit until the run
        stops or goes idle.  Every hop is at-least-once across
        rebalances; per-stage dedup by msg_id gives exactly-once *effect*
        end to end.  Intermediate stages forward their output into the
        next hop's topic under the originating message's identity, so
        produced→processed latency spans the whole continuum path."""
        group = state.groups[stage_idx - 1]
        group.join(cid)
        final = stage_idx == len(self.stages) - 1
        out_topic = None if final else state.topics[stage_idx]
        seen = state.seen[stage_idx - 1]
        stage_name = self.stages[stage_idx].name
        clock = ctx.clock
        # per-event attribute lookups hoisted into locals: this loop body
        # runs once per message and the bound-method/attribute chains
        # (state.stop.is_set, clock.now, metrics, heartbeat) are a
        # measurable slice of the profiled event loop at 1M+ messages
        now = clock.now
        stopped = state.stop.is_set
        metrics = self.metrics
        heartbeat = ctx.heartbeat
        commit = group.commit
        timeout_s = state.timeout_s
        inflight = state.inflight
        idle_deadline = now() + timeout_s
        # reused effect records (see _source_body): the interpreter reads
        # them synchronously at the yield point
        poll = Poll(group, cid, timeout_s=0.2, stage=stage_name)
        svc = Service(stage_name)
        epochs = state.stage_epoch
        my_epoch = epochs.get(stage_idx, 0)
        while not stopped():
            if epochs.get(stage_idx, 0) != my_epoch:
                # a hot-swap moved this stage to a new placement epoch:
                # any message this consumer finished is already committed,
                # so leaving the group here hands its partitions to the
                # replacement generation with at-least-once semantics
                # (dedup absorbs any redelivery overlap).
                group.leave(cid)
                metrics.event("consumer_drained", cid=cid,
                              stage=stage_name, epoch=my_epoch)
                return
            poll.wake_at = idle_deadline
            msg = yield poll
            if msg is None:
                if (state.n_processed >= state.n_messages
                        or now() >= idle_deadline):
                    return
                continue
            idle_deadline = now() + timeout_s
            with state.lock:
                dup = msg.msg_id in seen
                seen.add(msg.msg_id)               # reserve
            if dup:
                group.commit_reserved(msg, seen)
                metrics.incr("pipeline.duplicates_dropped")
                continue
            inflight_key = (stage_idx, cid, ctx.attempt)
            inflight[inflight_key] = msg.msg_id
            try:
                data = msg.value()
                svc.payload = data
                yield svc
                svc.payload = None
                fn = self._fn(stage_name)
                out = fn(ctx, data=data)
            except BaseException as exc:
                # release the dedup reservation so the redelivery (from
                # this task's retry or a rebalance) is processed, then let
                # the strategy's retry machinery handle the failure.
                with state.lock:
                    seen.discard(msg.msg_id)
                if not isinstance(exc, GeneratorExit):
                    # a consumer that dropped it as a duplicate meanwhile
                    # may have committed past it
                    group.redeliver(msg)
                inflight.pop(inflight_key, None)
                raise
            # hop identity: forwarded messages carry the originating
            # msg_id in their key so the final stamp links end to end
            origin = msg.key or msg.msg_id
            if final:
                metrics.stamp(origin, "processed", bytes=msg.nbytes)
                commit(msg)
                inflight.pop(inflight_key, None)
                with state.lock:
                    state.n_processed += 1
                    if state.collect:
                        state.results.append(out)
                    if (state.n_processed >= state.n_messages
                            and state.t_done is None):
                        state.t_done = now()
                        state.stop.set()
                state.processed_sem.release()
            else:
                out_topic.produce(out, key=origin, partition=msg.partition,
                                  msg_id=f"{origin}+h{stage_idx}")
                commit(msg)
                inflight.pop(inflight_key, None)
            heartbeat()

    # -- run -------------------------------------------------------------------

    def _setup_run(self, n_messages: int, timeout_s: float,
                   collect_results: bool) -> _RunState:
        """Create the per-run topics/groups/state (called by the
        strategy)."""
        # run-counter suffix, not a wall-time suffix: virtual runs restart
        # the clock at 0 and must not collide on topic names
        run_id = next(_run_ids)
        topics: List[Topic] = []
        groups: List[ConsumerGroup] = []
        seen: List[set] = []
        lock = threading.Lock()
        for i, stage in enumerate(self.stages[1:], start=1):
            suffix = "" if i == 1 else f"-h{i - 1}"
            topics.append(self.broker.create_topic(
                f"{self.topic_name}-{run_id}{suffix}",
                n_partitions=self.n_partitions,
                shaper=self._shapers[i - 1],
                truncate_batch=self.truncate_logs))
            groups.append(ConsumerGroup(topics[-1],
                                        group_id=f"{stage.name}-group"))
            seen.append(set())
            if self.truncate_logs is not None:
                # a reclaimed message can never be redelivered, so its
                # dedup entry is dead weight — evict it.  This bounds the
                # other linear memory term (hop dedup sets) and narrows
                # exactly-once *effect* to the retention window.
                topics[-1].on_truncate(
                    self._make_dedup_evictor(seen[-1], lock))
        # paper: messages split across devices, one partition per device
        n_src = self.stage_tasks(0)
        arrivals = self._arrival_plan
        if arrivals is not None:
            if len(arrivals) != n_src:
                raise ValueError(
                    f"arrival plan has {len(arrivals)} device streams, "
                    f"pipeline has {n_src} source tasks")
            per_device = [len(a) for a in arrivals]
            n_messages = sum(per_device)
        elif n_src == 0:
            # a source-less shard (the producing half lives in another
            # process): messages arrive via Topic.inject only
            per_device = []
        else:
            per_device = [n_messages // n_src] * n_src
            for i in range(n_messages % n_src):
                per_device[i] += 1
        self._topics = topics
        self._topic = topics[0]
        self._group = groups[-1]
        self._run_groups = groups
        return _RunState(topics=topics, groups=groups,
                         per_device=per_device,
                         seen=seen, lock=lock,
                         n_messages=n_messages, timeout_s=timeout_s,
                         collect=collect_results, arrivals=arrivals)

    @staticmethod
    def _make_dedup_evictor(seen: set, lock: threading.Lock):
        """Truncation callback: drop dedup entries of reclaimed msg_ids
        (they can never be redelivered). ``lock`` is the run state's lock
        guarding ``seen``."""
        def _evict(partition: int, msg_ids: List[str]) -> None:
            with lock:
                seen.difference_update(msg_ids)
        return _evict

    def _finish(self, state: _RunState, wall_s: float) -> PipelineResult:
        self._group = None        # current_lag() reads 0 between runs
        self._run_groups = []     # stage_lag() likewise
        n_prod = int(self.metrics.counter(
            f"topic.{state.topics[0].name}.msgs_in"))
        return PipelineResult(results=state.results, metrics=self.metrics,
                              n_produced=n_prod,
                              n_processed=state.n_processed, wall_s=wall_s)

    def run(self, n_messages: Optional[int] = None,
            timeout_s: float = 600.0,
            collect_results: bool = True,
            scheduler=None, placement: Optional[str] = None,
            latency_budget: Optional[float] = None,
            wan_budget: Optional[float] = None,
            hybrid_reduce: Optional[List[int]] = None,
            arrival_plan: Optional[List[Sequence[float]]] = None,
            readvise=None):
        """Drive ``n_messages`` end-to-end (default 512 — what the paper
        sends per run).

        ``arrival_plan`` switches the sources to *open-loop* traffic: one
        sorted sequence of absolute arrival times (seconds from run
        start) per source device — e.g. drawn from
        :class:`repro_torch.sim.scenarios.PoissonArrivals` /
        ``DiurnalArrivals`` / ``FlashCrowdArrivals``.  ``n_messages`` is
        then taken from the plan (and must not disagree if given).

        ``scheduler`` selects the execution strategy:
        :class:`~repro_torch.core.executor.ThreadedExecutor` (default — real
        threads) or :class:`~repro_torch.core.executor.SimExecutor`
        (single-threaded virtual time, bit-reproducible metrics).

        ``placement='advise'`` does not execute this pipeline at all:
        instead the :class:`~repro_torch.cost.advisor.PlacementAdvisor`
        emulates a pipeline of this shape (devices/consumers; workload from
        ``function_context['model']`` / ``['n_points']``; straggler
        speculation from this pipeline's ``speculative_factor``) under
        its own ``SimExecutor`` across placements × WAN bands — every
        advisory cell carries its per-stage tier vector — and returns
        the ranked :class:`~repro_torch.cost.advisor.AdvisorReport` — the
        paper's "evaluate task placement based on multiple factors" knob,
        multi-objectively: ``latency_budget`` caps predicted p95 latency
        (seconds), ``wan_budget`` caps advisory WAN megabytes (cells over
        budget are flagged infeasible and ranked last, never dropped),
        and ``hybrid_reduce`` sweeps the hybrid/fog placements' edge
        pre-aggregation factor.  An explicit ``n_messages`` sets the
        per-cell advisory fidelity (default 32 — the whole grid in a few
        hundred ms); ``timeout_s``/``collect_results`` do not apply and
        ``scheduler`` is rejected.

        ``readvise=ReAdvisor(...)`` attaches an *online* re-advisor
        (:class:`~repro_torch.cost.readvisor.ReAdvisor`) for the duration of
        the run: the executor ticks it periodically (SimExecutor: a
        scheduled virtual-time event; ThreadedExecutor: a monitor
        thread), and when observed hop latency flips the placement
        ranking beyond hysteresis the watched stage is hot-swapped live
        via :meth:`rebind_stage` + consumer migration.
        """
        if placement == "advise":
            if scheduler is not None:
                raise ValueError(
                    "placement='advise' runs its own SimExecutor grid; "
                    "scheduler= does not apply")
            model = self.context.get("model")
            if model is None:
                raise ValueError(
                    "placement='advise' needs function_context['model'] "
                    "to name a calibrated workload (e.g. 'kmeans') — "
                    "advising for a guessed model would silently rank "
                    "the wrong trade-off")
            # imported lazily: the advisor rides the sim/scenarios stack,
            # which imports this module
            from repro_torch.cost.advisor import PlacementAdvisor
            kw = {} if n_messages is None else {"n_messages": n_messages}
            return PlacementAdvisor.from_pipeline(self, **kw).advise(
                model, latency_budget=latency_budget,
                wan_budget=wan_budget, hybrid_reduce=hybrid_reduce)
        if (latency_budget is not None or wan_budget is not None
                or hybrid_reduce is not None):
            raise ValueError(
                "latency_budget/wan_budget/hybrid_reduce are advisory "
                "knobs — they only apply with placement='advise'")
        if placement is not None and placement != self.placement:
            raise ValueError(
                f"unsupported run-time placement {placement!r} "
                f"(constructor placement is {self.placement!r}; "
                f"run-time only supports 'advise')")
        if arrival_plan is not None:
            plan_total = sum(len(a) for a in arrival_plan)
            if n_messages is not None and n_messages != plan_total:
                raise ValueError(
                    f"n_messages={n_messages} disagrees with the arrival "
                    f"plan's {plan_total} arrivals — omit n_messages")
            n_messages = plan_total
        n_messages = 512 if n_messages is None else n_messages
        self._arrival_plan = arrival_plan
        self._readvise = readvise
        try:
            strategy = (scheduler if scheduler is not None
                        else ThreadedExecutor())
            return strategy.run(self, n_messages=n_messages,
                                timeout_s=timeout_s,
                                collect_results=collect_results)
        finally:
            self._arrival_plan = None
            self._readvise = None

    def launch(self, scheduler, *, n_messages: Optional[int] = None,
               timeout_s: float = 600.0, collect_results: bool = False,
               arrival_plan: Optional[List[Sequence[float]]] = None,
               readvise=None):
        """Start this pipeline under a :class:`SimExecutor` *without*
        draining it: returns the executor's windowed run handle
        (``start``-ed), which a caller advances in bounded virtual-time
        windows via ``advance_to(t)`` and closes with ``finish()``.

        This is the shard-aware entry point: a
        :class:`repro.sim.shard.ShardCoordinator` drives one handle per
        process in conservative time-window lock-step, delivering
        cross-shard boundary messages between windows.  ``run()`` is
        exactly ``launch(...)`` advanced to the deadline in one window.
        """
        if arrival_plan is not None:
            plan_total = sum(len(a) for a in arrival_plan)
            if n_messages is not None and n_messages != plan_total:
                raise ValueError(
                    f"n_messages={n_messages} disagrees with the arrival "
                    f"plan's {plan_total} arrivals — omit n_messages")
            n_messages = plan_total
        n_messages = 512 if n_messages is None else n_messages
        self._arrival_plan = arrival_plan
        self._readvise = readvise
        try:
            return scheduler.begin(self, n_messages=n_messages,
                                   timeout_s=timeout_s,
                                   collect_results=collect_results)
        finally:
            self._arrival_plan = None
            self._readvise = None


class EdgeToCloudPipeline(ContinuumPipeline):
    """Listing 2's object: the historical two-stage edge→cloud pipeline,
    kept as a thin :class:`ContinuumPipeline` wrapper.  Parameter names
    follow the paper's API; ``process_edge`` runs fused into the source
    stage (pre-aggregation next to the generator), exactly as before."""

    def __init__(self, *,
                 pilot_cloud_processing: Pilot,
                 pilot_edge: Pilot,
                 pilot_cloud_broker: Optional[Pilot] = None,
                 produce_function_handler: ProduceFn,
                 process_cloud_function_handler: ProcessFn,
                 process_edge_function_handler: Optional[ProcessFn] = None,
                 function_context: Optional[dict] = None,
                 n_edge_devices: Optional[int] = None,
                 n_partitions: Optional[int] = None,
                 topic_name: str = "edge-to-cloud",
                 wan_shaper: Optional[WanShaper] = None,
                 broker: Optional[Broker] = None,
                 parameter_service: Optional[ParameterService] = None,
                 placement: str = "explicit",
                 placement_engine: Optional[PlacementEngine] = None,
                 cloud_consumers: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 max_retries: int = 2,
                 speculative_factor: float = 0.0,
                 heartbeat_timeout_s: float = 30.0,
                 truncate_logs: Optional[int] = None,
                 clock: Optional[Clock] = None):
        self.pilot_edge = pilot_edge
        self.pilot_cloud = pilot_cloud_processing
        self.pilot_broker = pilot_cloud_broker or pilot_cloud_processing
        n_src = n_edge_devices or pilot_edge.resource.n_workers
        n_parts = n_partitions or n_src
        # keep Kafka:Dask partition ratio constant (paper: "we keep the
        # ratio of partitions constant between Kafka and Dask")
        stages = [
            StageSpec("produce", produce_function_handler,
                      pilot=pilot_edge, n_tasks=n_src),
            StageSpec("process_cloud", process_cloud_function_handler,
                      pilot=pilot_cloud_processing,
                      n_tasks=cloud_consumers or n_parts),
        ]
        super().__init__(
            stages=stages, function_context=function_context,
            n_partitions=n_parts, topic_name=topic_name,
            shapers=[wan_shaper], broker=broker,
            parameter_service=parameter_service, placement=placement,
            placement_engine=placement_engine, metrics=metrics,
            max_retries=max_retries,
            speculative_factor=speculative_factor,
            heartbeat_timeout_s=heartbeat_timeout_s,
            truncate_logs=truncate_logs, clock=clock)
        # process_edge is hot-swappable like a stage even though it runs
        # fused into the source body (legacy API)
        self._fns["process_edge"] = process_edge_function_handler

    def _invoke_source(self, ctx: TaskContext) -> Any:
        produce = self._fn("produce")
        data = produce(ctx)
        pe = self._fn("process_edge")
        if pe is not None:
            data = pe(ctx, data=data)
        return data
