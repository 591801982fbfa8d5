"""Sharded DES: conservative time-window parallel simulation across
processes, partitioned by topology.  Ported from ``repro.sim.shard``:
only the import paths differ, and the shard builders' pilot managers
take ``devices=()`` (the DES pilots hold no device; a bare
``PilotManager()`` would inventory the host's CUDA cards and raise on a
host without one).

``mode="mp"`` forks one process per shard
(``multiprocessing.get_context("fork")``), so a caller that also uses
the card runs the sharded DES before anything touches CUDA: a forked
child of a process that has initialised CUDA cannot use it.

The single-process DES (ROADMAP item 1) is CPU-bound: one thread drains
one :class:`~repro_torch.sim.scheduler.EventScheduler`.  This module splits a
run into **shards** — each shard a complete
:class:`~repro_torch.core.faas.ContinuumPipeline` over a disjoint slice of the
topology, driven by its own ``EventScheduler``/``SimExecutor`` on its own
virtual clock — and synchronizes them with the classic *conservative
time-window* protocol:

* **Lookahead.** The minimum latency of any routed inter-shard link
  (:func:`lookahead_s`, priced from ``CostModel``'s
  ``route(a, b).transfer_s``) bounds how early a message produced in one
  shard can become visible in another.  With window ``W <= lookahead``,
  a message produced inside window ``k`` (``[T_k, T_k + W)``) carries
  ``ready_at >= T_k + lookahead >= T_{k+1}`` — so delivering it at the
  ``T_{k+1}`` barrier, *before* any shard simulates past ``T_{k+1}``,
  can never violate causality.  Shards advance in lock-step windows and
  exchange boundary batches at every barrier.

* **Boundary queues.** Cross-shard broker topics become explicit
  boundary queues: after each window a shard scans its export hops'
  partition logs past a watermark and ships ``(ready_at, Message)``
  batches (plus the original ``produced`` stamp time) over
  ``multiprocessing`` pipes; the receiving shard appends them with
  :meth:`~repro_torch.core.broker.Topic.inject` — explicit ``ready_at``, no
  double-charged shaper delay, no double-counted bytes.

* **Determinism.** Every random draw is derived from ``(seed,
  shard_id)`` via :func:`shard_seed` (a SplitMix64 split — the
  Philox-style independent-stream construction), and globally-shared
  draws (the scale benchmark's arrival process) are drawn *once* from
  the global seed and sliced by global device index — so the
  deterministic columns are bit-identical regardless of worker count.

Two partitionings ship:

* :func:`build_scale_shard` — the scale benchmark's device-partition
  cut: each shard owns a contiguous block of devices *and* the matching
  block of consumers, a complete sub-pipeline with **no** cross-shard
  links (lookahead = ∞ → a single window).  Requires
  ``consumers >= devices`` (each partition then has a dedicated
  consumer, so per-partition timelines are independent and the merged
  latency multiset is bit-identical to single-process).
* :func:`build_tier_cut_shard` — the pipeline cut at the edge→cloud
  WAN hop: shard 0 owns the sources and the WAN shaper, shard 1 the
  consumers; lookahead = the WAN's min one-way latency; finite windows
  exercise the full boundary-queue protocol (this is the cut the
  causality property test drives).

When is a workload too chatty to shard?  When state is *shared* across
the cut — e.g. a WAN shaper's token bucket serializes all partitions
through one ``_available_at``, or consumers < devices couples several
partitions through one consumer's service queue.  Splitting either
changes the schedule, so :func:`run_scale_sharded` refuses such
configurations instead of silently de-synchronizing.
"""
from __future__ import annotations

import math
import multiprocessing as mp
import resource
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.broker import WanShaper
from repro_torch.core.executor import SimExecutor
from repro_torch.core.faas import ContinuumPipeline, EdgeToCloudPipeline, StageSpec
from repro_torch.core.monitoring import LatencySketch, MetricsRegistry
from repro_torch.core.pilot import ComputeResource, PilotManager
from repro_torch.sim.clock import SimClock
from repro_torch.sim.scenarios import arrival_process

_MASK64 = (1 << 64) - 1


def shard_seed(seed: int, shard_id: int) -> int:
    """Independent per-shard RNG stream seed: a SplitMix64 mix of
    ``(seed, shard_id)`` — the same construction Philox-style counter
    RNGs use to split one key into independent streams.  Derived, not
    ``seed + shard_id``: neighbouring seeds of the same generator family
    are *not* independent streams, and a run's determinism must not
    depend on how many workers happened to be used."""
    z = (int(seed) + (int(shard_id) + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & _MASK64


def split_blocks(n: int, k: int) -> List[Tuple[int, int]]:
    """Split ``range(n)`` into ``k`` contiguous ``[start, stop)`` blocks,
    sizes differing by at most one (larger blocks first).  Monotone in
    ``n`` per block index — so if global ``consumers >= devices``, every
    shard's consumer block covers its device block."""
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    base, rem = divmod(n, k)
    out, start = [], 0
    for i in range(k):
        size = base + (1 if i < rem else 0)
        out.append((start, start + size))
        start += size
    return out


def lookahead_s(cost, cuts: Sequence[Tuple[str, str]],
                nbytes: float = 0.0) -> float:
    """Conservative-window lookahead: the minimum routed transfer time
    across the inter-shard cut links — ``min`` over ``(src_tier,
    dst_tier)`` pairs of ``cost.route(src, dst).transfer_s(nbytes)``.
    With ``nbytes=0`` this is the pure routed link latency (the safe
    bound: real messages only take longer).  No cuts → ``inf`` (fully
    independent shards need a single window)."""
    if not cuts:
        return math.inf
    return min(cost.route(a, b).transfer_s(nbytes) for a, b in cuts)


# ---------------------------------------------------------------------------
# one shard
# ---------------------------------------------------------------------------


class ShardRunner:
    """One shard: a started windowed pipeline run plus its boundary-queue
    bookkeeping (export watermarks, injected-message ledger)."""

    def __init__(self, shard_id: int, pipe, executor: SimExecutor, handle,
                 metrics: MetricsRegistry, *,
                 export_hops: Optional[Dict[int, int]] = None,
                 streaming: bool = False, mgr: Optional[PilotManager] = None,
                 control_pilots: Optional[Dict[str, object]] = None):
        self.shard_id = shard_id
        self.pipe = pipe
        self.executor = executor
        self.handle = handle                   # started _SimRun
        self.metrics = metrics
        self.streaming = streaming
        self.mgr = mgr
        # tier -> Pilot map for applying *remote* re-advisory swap
        # commands (the control channel); None = this shard never
        # applies controls
        self.control_pilots = dict(control_pilots or {})
        self._ctl_wm = 0                       # decisions already exported
        # hop index -> destination shard id; messages appended to that
        # hop's topic are boundary traffic for the destination shard
        self.export_hops = dict(export_hops or {})
        self.deadline = handle.deadline
        # absolute end offsets already exported, per (hop, partition)
        self._export_wm: Dict[int, List[int]] = {
            hop: [p.base + len(p.log)
                  for p in handle.state.topics[hop].partitions]
            for hop in self.export_hops}
        # msg_id -> (injection clock time, ready_at): the causality
        # ledger the property tests audit
        self.injected: Dict[str, Tuple[float, float]] = {}

    @property
    def done(self) -> bool:
        return self.handle.done

    @property
    def clock_now(self) -> float:
        return self.executor.clock.now()

    def advance(self, t: float) -> None:
        self.handle.advance_to(t)

    def collect_exports(self) -> List[Tuple]:
        """Boundary messages appended since the last collection:
        ``(dest_shard, hop, partition, msg_id, key, raw, ready_at,
        produced_t)`` tuples, in partition-log order."""
        out: List[Tuple] = []
        trace = None if self.streaming else self.metrics.trace
        for hop, dest in self.export_hops.items():
            topic = self.handle.state.topics[hop]
            wm = self._export_wm[hop]
            for p, part in enumerate(topic.partitions):
                end = part.base + len(part.log)
                if end <= wm[p]:
                    continue
                for idx in range(wm[p] - part.base, len(part.log)):
                    m = part.log[idx]
                    produced_t = None
                    if trace is not None:
                        tr = trace(m.msg_id)
                        if tr is not None:
                            produced_t = tr.stamps.get("produced")
                    out.append((dest, hop, p, m.msg_id, m.key, m.raw,
                                part.ready_at[idx], produced_t))
                wm[p] = end
        return out

    def deliver(self, items: Sequence[Tuple]) -> None:
        """Inject boundary messages received at a window barrier:
        ``(hop, partition, msg_id, key, raw, ready_at, produced_t)``."""
        topics = self.handle.state.topics
        now = self.clock_now
        for hop, p, msg_id, key, raw, ready_at, produced_t in items:
            topics[hop].inject(raw, msg_id=msg_id, partition=p,
                               ready_at=ready_at, key=key,
                               produced_t=produced_t)
            self.injected[msg_id] = (now, ready_at)

    def collect_controls(self) -> List[dict]:
        """Re-advisory swap decisions made by this shard's ReAdvisor
        since the last collection — the control-channel counterpart of
        :meth:`collect_exports`.  Each entry carries the absolute virtual
        apply time; with ``window_s <= apply_delay_s`` the receiving
        shard's clock is guaranteed not to have passed it yet."""
        rv = getattr(self.executor, "readvisor", None)
        if rv is None:
            return []
        out = []
        for dec in rv.decisions[self._ctl_wm:]:
            out.append({"stage": dec.stage, "from_tier": dec.from_tier,
                        "to_tier": dec.to_tier,
                        "t_decided": dec.t_decided,
                        "t_apply": dec.t_decided + rv.apply_delay_s})
        self._ctl_wm = len(rv.decisions)
        return out

    def apply_controls(self, items: Sequence[dict]) -> None:
        """Schedule remote swap commands received at a window barrier:
        at ``t_apply`` the named stage re-binds to this shard's pilot for
        the target tier and its local consumer fleet (if any) migrates
        epoch-wise — the same code path the deciding shard runs."""
        h = self.handle
        for c in items:
            pilot = self.control_pilots[c["to_tier"]]

            def _swap(c=c, pilot=pilot):
                si = h.pipe.rebind_stage(c["stage"], pilot)
                h._migrate_stage(si)

            h.sched.at(float(c["t_apply"]), _swap)

    def finish_row(self) -> dict:
        """Close the run and summarize this shard's deterministic
        columns (plus its raw latency data for exact cross-shard
        merging)."""
        res = self.handle.finish()
        m = self.metrics
        topics = self.pipe._topics
        row = {
            "shard_id": self.shard_id,
            "processed": res.n_processed,
            "duplicates": int(m.counter("pipeline.duplicates_dropped")),
            "events": self.executor.sched.executed,
            "truncated_msgs": sum(t.truncated_msgs for t in topics),
            "wan_bytes": m.counter(f"topic.{topics[0].name}.bytes_in"),
            "first_produced": m.first_stamp("produced"),
            "last_processed": m.last_stamp("processed"),
        }
        if self.streaming:
            sk = m._sketch("produced", "processed")
            row["sketch"] = sk.state() if sk is not None else None
        else:
            row["latencies"] = m.latencies("produced", "processed")
        rv = getattr(self.executor, "readvisor", None)
        if rv is not None:
            row["swaps"] = [dict(s) for s in rv.swap_log]
        if self.mgr is not None:
            self.mgr.release_all()
        return row


def merge_rows(rows: Sequence[dict], *, streaming: bool) -> dict:
    """Aggregate per-shard rows into the single-run deterministic
    columns.  Counters sum; the makespan spans min-first-produced to
    max-last-processed; latency percentiles come from the merged
    multiset (exact mode — bit-identical to an unsharded run of the
    same streams) or the merged sketch (streaming mode — bucket counts
    add exactly)."""
    processed = sum(r["processed"] for r in rows)
    firsts = [r["first_produced"] for r in rows
              if r["first_produced"] is not None]
    lasts = [r["last_processed"] for r in rows
             if r["last_processed"] is not None]
    first = min(firsts) if firsts else 0.0
    last = max(lasts) if lasts else first
    if streaming:
        merged: Optional[LatencySketch] = None
        for r in rows:
            st = r.get("sketch")
            if st is None:
                continue
            sk = LatencySketch.from_state(st)
            if merged is None:
                merged = sk
            else:
                merged.merge(sk)
        p50 = merged.percentile(0.50) if merged is not None else 0.0
        p95 = merged.percentile(0.95) if merged is not None else 0.0
    else:
        lat: List[float] = []
        for r in rows:
            lat.extend(r["latencies"])
        lat.sort()
        n = len(lat)
        # the exact-mode rank formula the single-process bench uses
        p50 = lat[n // 2] if n else 0.0
        p95 = lat[min(n - 1, int(0.95 * n))] if n else 0.0
    merged = {
        "processed": processed,
        "duplicates": sum(r["duplicates"] for r in rows),
        "events": sum(r["events"] for r in rows),
        "truncated_msgs": sum(r["truncated_msgs"] for r in rows),
        "makespan_s": max(last - first, 1e-9),
        "lat_p50_s": p50,
        "lat_p95_s": p95,
        "wan_bytes": sum(r["wan_bytes"] for r in rows),
    }
    if any("swaps" in r for r in rows):
        # applied hot-swaps, in shard-id order (only the deciding shard
        # logs them, so this is also decision order)
        merged["swaps"] = [s for r in rows for s in r.get("swaps", ())]
    return merged


# ---------------------------------------------------------------------------
# coordinator: lock-step conservative windows, inline or multiprocessing
# ---------------------------------------------------------------------------


def _shard_worker(conn, build: Callable[[dict], ShardRunner],
                  cfg: dict) -> None:
    """Worker-process loop: build the shard, then serve the barrier
    protocol — ``('put', items)`` injects boundary messages, ``('ctl',
    items)`` schedules remote swap commands, ``('adv', t)`` advances the
    window and returns ``('adv', done, cpu_s, exports, controls)``,
    ``('fin',)`` closes the run and returns its row."""
    runner = build(cfg)
    conn.send(("ready", runner.deadline))
    while True:
        msg = conn.recv()
        op = msg[0]
        if op == "put":
            runner.deliver(msg[1])
        elif op == "ctl":
            runner.apply_controls(msg[1])
        elif op == "adv":
            c0 = time.process_time()
            runner.advance(msg[1])
            cpu = time.process_time() - c0
            conn.send(("adv", runner.done, cpu, runner.collect_exports(),
                       runner.collect_controls()))
        elif op == "fin":
            conn.send(("row", runner.finish_row()))
            conn.close()
            return
        else:                                  # pragma: no cover
            raise ValueError(f"unknown shard command {op!r}")


class ShardCoordinator:
    """Drive N shards in conservative time-window lock-step.

    ``builders`` is one ``(build_fn, cfg)`` per shard (shard ids are the
    list indices — export hop destinations refer to them).  ``window_s``
    must not exceed the partitioning's lookahead (``math.inf`` for
    fully-independent shards → a single window).  ``mode='mp'`` runs one
    OS process per shard over pipes; ``mode='inline'`` runs them
    sequentially in-process (tests introspect the runners afterwards via
    ``self.runners``)."""

    def __init__(self, builders: Sequence[Tuple[Callable, dict]], *,
                 window_s: float, mode: str = "mp"):
        if window_s <= 0.0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if mode not in ("mp", "inline"):
            raise ValueError(f"mode must be 'mp' or 'inline', got {mode!r}")
        self.builders = list(builders)
        self.window_s = window_s
        self.mode = mode
        self.runners: List[ShardRunner] = []   # inline mode only
        self.windows = 0
        self.cpu_s_total = 0.0
        # critical path across the barrier schedule: per window the
        # slowest shard gates the barrier, so the parallel-run CPU bound
        # is the sum over windows of the per-window max — what the wall
        # clock would be with one core per shard
        self.cpu_critical_s = 0.0

    # -- shared window loop ------------------------------------------------

    def _window_loop(self, n: int, horizon: float, deliver, advance_all,
                     control=None):
        pending: Dict[int, List[Tuple]] = {i: [] for i in range(n)}
        # re-advisory swap commands awaiting broadcast: (dest_sid, dict)
        pending_ctl: Dict[int, List[dict]] = {i: [] for i in range(n)}
        t = 0.0
        # +4: slack for barrier rounds that only flush boundary queues
        max_windows = (int(math.ceil(horizon / self.window_s)) + 4
                       if math.isfinite(self.window_s) else 8)
        while self.windows < max_windows:
            for sid, items in pending.items():
                if items:
                    deliver(sid, items)
                    pending[sid] = []
            if control is not None:
                for sid, items in pending_ctl.items():
                    if items:
                        control(sid, items)
                        pending_ctl[sid] = []
            t_next = min(t + self.window_s, horizon)
            done_flags, cpus, exports, controls = advance_all(t_next)
            self.windows += 1
            self.cpu_s_total += sum(cpus)
            self.cpu_critical_s += max(cpus) if cpus else 0.0
            for dest, hop, p, mid, key, raw, ready_at, produced_t in exports:
                pending[dest].append((hop, p, mid, key, raw, ready_at,
                                      produced_t))
            # controls broadcast to every *other* shard (the decider
            # already applied its own swap locally)
            if control is not None:
                for src, ctl in controls:
                    for dest in range(n):
                        if dest != src:
                            pending_ctl[dest].append(ctl)
            have_pending = any(pending.values()) or any(pending_ctl.values())
            if all(done_flags) and not have_pending:
                break
            if t_next >= horizon and not have_pending:
                break
            t = t_next

    # -- modes -------------------------------------------------------------

    def run(self) -> List[dict]:
        """Run all shards to completion; returns the per-shard rows (in
        shard-id order) for :func:`merge_rows`."""
        if self.mode == "inline":
            return self._run_inline()
        return self._run_mp()

    def _run_inline(self) -> List[dict]:
        self.runners = [build(cfg) for build, cfg in self.builders]
        horizon = max(r.deadline for r in self.runners)

        def deliver(sid, items):
            self.runners[sid].deliver(items)

        def control(sid, items):
            self.runners[sid].apply_controls(items)

        def advance_all(t_next):
            done, cpus, exports, controls = [], [], [], []
            for r in self.runners:
                c0 = time.process_time()
                r.advance(t_next)
                cpus.append(time.process_time() - c0)
                done.append(r.done)
                exports.extend(r.collect_exports())
                for ctl in r.collect_controls():
                    controls.append((r.shard_id, ctl))
            return done, cpus, exports, controls

        self._window_loop(len(self.runners), horizon, deliver, advance_all,
                          control)
        return [r.finish_row() for r in self.runners]

    def _run_mp(self) -> List[dict]:
        ctx = mp.get_context("fork")
        conns, procs = [], []
        for build, cfg in self.builders:
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_shard_worker, args=(child, build, cfg),
                               daemon=True)
            proc.start()
            child.close()
            conns.append(parent)
            procs.append(proc)
        try:
            deadlines = []
            for conn in conns:
                tag, deadline = conn.recv()
                if tag != "ready":             # pragma: no cover
                    raise RuntimeError(f"shard handshake got {tag!r}")
                deadlines.append(deadline)
            horizon = max(deadlines)

            def deliver(sid, items):
                conns[sid].send(("put", items))

            def control(sid, items):
                conns[sid].send(("ctl", items))

            def advance_all(t_next):
                for conn in conns:
                    conn.send(("adv", t_next))
                done, cpus, exports, controls = [], [], [], []
                for sid, conn in enumerate(conns):  # parallel workers
                    _, d, cpu, exp, ctl = conn.recv()
                    done.append(d)
                    cpus.append(cpu)
                    exports.extend(exp)
                    controls.extend((sid, c) for c in ctl)
                return done, cpus, exports, controls

            self._window_loop(len(conns), horizon, deliver, advance_all,
                              control)
            rows = []
            for conn in conns:
                conn.send(("fin",))
                tag, row = conn.recv()
                rows.append(row)
            return rows
        finally:
            for conn in conns:
                conn.close()
            for proc in procs:
                proc.join(timeout=60.0)
                if proc.is_alive():            # pragma: no cover
                    proc.terminate()


# ---------------------------------------------------------------------------
# partitioning 1: the scale benchmark's device-partition cut
# ---------------------------------------------------------------------------


def build_scale_shard(cfg: dict) -> ShardRunner:
    """One device-partition shard of the DES scale benchmark cell: a
    contiguous block of devices plus the matching block of consumers,
    as a complete :class:`EdgeToCloudPipeline`.

    Determinism regardless of shard count: the open-loop arrival times
    are drawn **once** from the global seed (the same
    ``arrival_process(...).times(messages, seed)`` cumsum every shard
    count sees) and each device takes its global interleave slice
    ``times[g::devices]`` — shard boundaries never touch the draw."""
    sid, k = cfg["shard_id"], cfg["shards"]
    devices, consumers = cfg["devices"], cfg["consumers"]
    lo, hi = split_blocks(devices, k)[sid]
    clo, chi = split_blocks(consumers, k)[sid]
    n_dev, n_con = hi - lo, chi - clo
    clock = SimClock()
    metrics = MetricsRegistry(clock=clock, streaming=cfg["streaming"])
    mgr = PilotManager(devices=())
    edge = mgr.submit_pilot(ComputeResource(tier="edge", n_workers=n_dev))
    cloud = mgr.submit_pilot(ComputeResource(tier="cloud", n_workers=n_con))
    payload = bytes(cfg["payload_bytes"])
    pipe = EdgeToCloudPipeline(
        pilot_cloud_processing=cloud, pilot_edge=edge,
        produce_function_handler=lambda ctx: payload,
        process_cloud_function_handler=lambda ctx, data=None: None,
        n_edge_devices=n_dev, n_partitions=n_dev,
        cloud_consumers=n_con, topic_name=f"des-scale-s{sid}",
        truncate_logs=cfg["truncate_logs"], metrics=metrics, clock=clock)
    times = arrival_process(cfg["arrival"], cfg["rate_hz"],
                            cfg.get("trace")).times(cfg["messages"],
                                                    cfg["seed"])
    plan = [times[g::devices] for g in range(lo, hi)]
    service_s = cfg["service_s"]
    ex = SimExecutor(
        clock,
        service_model=((lambda stage, ctx, data: service_s)
                       if service_s > 0.0 else None))
    handle = pipe.launch(ex, timeout_s=float(times[-1]) + 120.0,
                         collect_results=False, arrival_plan=plan)
    return ShardRunner(sid, pipe, ex, handle, metrics,
                       export_hops={}, streaming=cfg["streaming"], mgr=mgr)


def run_scale_sharded(*, arrival: str, messages: int, devices: int,
                      consumers: int, rate_hz: float, payload_bytes: int,
                      service_s: float, seed: int, shards: int,
                      streaming: bool = False, truncate_logs=None,
                      trace: Optional[str] = None,
                      mode: str = "mp") -> dict:
    """Run one scale-benchmark cell sharded ``shards`` ways; returns the
    merged row plus the parallel-run accounting columns.

    Requires ``consumers >= devices``: each partition then owns a
    dedicated consumer in *every* shard count, so per-partition
    timelines are independent and the merged deterministic columns are
    bit-identical to the single-process run.  With ``consumers <
    devices`` one consumer's service queue couples several partitions —
    that cross-partition coupling is exactly the "too chatty to shard"
    condition, so the split is refused rather than de-synchronized."""
    if consumers < devices:
        raise ValueError(
            f"sharding needs consumers >= devices ({consumers} < {devices}):"
            f" a consumer serving several partitions couples their "
            f"timelines across the shard cut (too chatty to shard)")
    if not 1 <= shards <= devices:
        raise ValueError(f"need 1 <= shards <= devices, got shards={shards}"
                         f" devices={devices}")
    cfgs = [dict(shard_id=sid, shards=shards, arrival=arrival,
                 messages=messages, devices=devices, consumers=consumers,
                 rate_hz=rate_hz, payload_bytes=payload_bytes,
                 service_s=service_s, seed=seed, streaming=streaming,
                 truncate_logs=truncate_logs, trace=trace)
            for sid in range(shards)]
    coord = ShardCoordinator([(build_scale_shard, c) for c in cfgs],
                             window_s=math.inf, mode=mode)
    t0 = time.perf_counter()
    rows = coord.run()
    wall = time.perf_counter() - t0
    merged = merge_rows(rows, streaming=streaming)
    events = merged["events"]
    if mode == "mp":
        rss_mb = (resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
                  / 1024.0)
    else:
        rss_mb = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                  / 1024.0)
    merged.update({
        "arrival": arrival, "messages": messages, "devices": devices,
        "consumers": consumers, "payload_bytes": payload_bytes,
        "seed": seed, "streaming_metrics": streaming,
        "shards": shards, "mode": mode,
        "windows": coord.windows,
        "wall_s": wall,
        "events_per_s": events / max(wall, 1e-9),
        "cpu_s_total": coord.cpu_s_total,
        "cpu_critical_s": coord.cpu_critical_s,
        # the parallel-run headline: events over the barrier-schedule
        # critical path — the wall rate on a host with >= 1 core per
        # shard (per window only the slowest shard gates the barrier)
        "agg_events_per_s": events / max(coord.cpu_critical_s, 1e-9),
        "rss_mb": rss_mb,
        "peak_rss_mb": rss_mb,
    })
    return merged


# ---------------------------------------------------------------------------
# partitioning 2: the tier cut (sources | WAN | consumers)
# ---------------------------------------------------------------------------


def build_tier_cut_shard(cfg: dict) -> ShardRunner:
    """One side of the edge→cloud tier cut.

    ``cfg['side'] == 'edge'``: the shard owns the source devices and the
    WAN shaper — its pipeline's consumer stage has ``n_tasks=0``, so
    produced messages (already carrying their shaped ``ready_at``) pile
    up in the hop-0 topic as boundary traffic exported to shard 1.  Its
    arrivals are seeded from ``shard_seed(seed, 0)``: a shard-local
    stream, independent of any other shard's draws.

    ``cfg['side'] == 'cloud'``: the shard owns the consumers — its
    source stage has ``n_tasks=0`` and every message arrives via
    :meth:`Topic.inject` at a window barrier.  The hop keeps a (virtual,
    never-charged) shaper object so the broker honors injected
    ``ready_at`` visibility times."""
    side = cfg["side"]
    devices, consumers = cfg["devices"], cfg["consumers"]
    payload = bytes(cfg["payload_bytes"])
    bw, rtt = cfg["bandwidth_bps"], cfg["rtt_s"]
    clock = SimClock()
    metrics = MetricsRegistry(clock=clock)
    mgr = PilotManager(devices=())
    edge = mgr.submit_pilot(ComputeResource(tier="edge",
                                            n_workers=max(devices, 1)))
    cloud = mgr.submit_pilot(ComputeResource(tier="cloud",
                                             n_workers=max(consumers, 1)))
    shaper = WanShaper(bandwidth_bps=bw, rtt_s=rtt, sleep=False)
    if side == "edge":
        pipe = ContinuumPipeline(
            stages=[StageSpec("produce", lambda ctx: payload,
                              pilot=edge, n_tasks=devices),
                    StageSpec("process_cloud", lambda ctx, data=None: None,
                              pilot=cloud, n_tasks=0)],
            n_partitions=devices, topic_name="tier-cut",
            shapers=[shaper], metrics=metrics, clock=clock,
            heartbeat_timeout_s=cfg["timeout_s"])
        times = arrival_process("poisson", cfg["rate_hz"]).times(
            cfg["messages"], shard_seed(cfg["seed"], 0))
        plan = [times[i::devices] for i in range(devices)]
        ex = SimExecutor(clock)
        handle = pipe.launch(ex, timeout_s=cfg["timeout_s"],
                             collect_results=False, arrival_plan=plan)
        export_hops = {0: 1}
    elif side == "cloud":
        pipe = ContinuumPipeline(
            stages=[StageSpec("produce", lambda ctx: payload,
                              pilot=edge, n_tasks=0),
                    StageSpec("process_cloud", lambda ctx, data=None: None,
                              pilot=cloud, n_tasks=consumers)],
            n_partitions=devices, topic_name="tier-cut-dst",
            shapers=[shaper], metrics=metrics, clock=clock,
            heartbeat_timeout_s=cfg["timeout_s"])
        ex = SimExecutor(clock)
        handle = pipe.launch(ex, n_messages=cfg["messages"],
                             timeout_s=cfg["timeout_s"],
                             collect_results=False)
        export_hops = {}
    else:
        raise ValueError(f"side must be 'edge' or 'cloud', got {side!r}")
    sid = 0 if side == "edge" else 1
    return ShardRunner(sid, pipe, ex, handle, metrics,
                       export_hops=export_hops, streaming=False, mgr=mgr)


def tier_cut_builders(cfg: dict) -> List[Tuple[Callable, dict]]:
    """The two-shard tier-cut builder list for a
    :class:`ShardCoordinator` (shard 0: sources+WAN, shard 1:
    consumers).  ``cfg`` needs messages/devices/consumers/rate_hz/
    payload_bytes/seed/bandwidth_bps/rtt_s/timeout_s."""
    return [(build_tier_cut_shard, dict(cfg, side="edge")),
            (build_tier_cut_shard, dict(cfg, side="cloud"))]


# ---------------------------------------------------------------------------
# partitioning 3: the drift tier cut (sources + WAN + ReAdvisor | consumers)
# ---------------------------------------------------------------------------


#: columns a sharded drift run must reproduce bit-identically to the
#: unsharded :func:`~repro_torch.sim.scenarios.run_scenario` of the same
#: scenario (``events`` counts shard machinery and is excluded)
DRIFT_PARITY_COLS = ("processed", "duplicates", "makespan_s", "lat_p50_s",
                     "lat_p95_s", "wan_bytes", "swaps")


def build_drift_shard(cfg: dict) -> ShardRunner:
    """One side of the tier cut for a drift/re-advisory scenario.

    Both sides build the scenario's *full* pipeline via
    :func:`~repro_torch.sim.scenarios.build_pipeline` — same pilots, payload,
    producer phase offsets, shapers and service model as the unsharded
    run — then zero out the stage the other shard owns (an explicit
    ``n_tasks=0``, which :meth:`stage_tasks` honors).

    ``side == 'edge'`` (shard 0) keeps the sources, the live WAN shaper,
    the scheduled drift events **and the ReAdvisor**: every produce-side
    counter the advisor reads (``msgs_in``/``wan_delay_s``/``bytes_in``)
    is stamped locally, so its decision timeline is bit-identical to the
    unsharded run's.  Its swap re-prices the local shaper; the decision
    ships to shard 1 over the control channel at the next barrier.

    ``side == 'cloud'`` (shard 1) keeps the consumers and the tier-aware
    service model; its executor gets no ReAdvisor and no drift plan —
    remote swap commands arrive via :meth:`ShardRunner.apply_controls`
    and re-bind the stage at the same virtual ``t_apply`` the deciding
    shard used (guaranteed still in this shard's future as long as
    ``window_s <= apply_delay_s``)."""
    import dataclasses

    from repro_torch.sim.scenarios import build_pipeline

    sc, side = cfg["sc"], cfg["side"]
    pipe, ex, mgr = build_pipeline(sc)
    rv = ex.readvisor
    if side == "edge":
        pipe.stages[1] = dataclasses.replace(pipe.stages[1], n_tasks=0)
        handle = pipe.launch(ex, n_messages=sc.n_messages,
                             timeout_s=sc.t_max_s, collect_results=False)
        return ShardRunner(0, pipe, ex, handle, pipe.metrics,
                           export_hops={0: 1}, mgr=mgr)
    if side == "cloud":
        pipe.stages[0] = dataclasses.replace(pipe.stages[0], n_tasks=0)
        ex.readvisor = None     # decisions arrive via the control channel
        ex.drift_plan = ()      # the charged WAN shaper lives on shard 0
        handle = pipe.launch(ex, n_messages=sc.n_messages,
                             timeout_s=sc.t_max_s, collect_results=False)
        return ShardRunner(1, pipe, ex, handle, pipe.metrics,
                           export_hops={},
                           control_pilots=dict(rv.targets) if rv else {},
                           mgr=mgr)
    raise ValueError(f"side must be 'edge' or 'cloud', got {side!r}")


def drift_builders(sc) -> List[Tuple[Callable, dict]]:
    """The two-shard builder list for a drift/re-advisory scenario
    (shard 0: sources + WAN + ReAdvisor, shard 1: consumers)."""
    return [(build_drift_shard, {"sc": sc, "side": "edge"}),
            (build_drift_shard, {"sc": sc, "side": "cloud"})]


def _drift_window_s(sc) -> float:
    """Safe conservative window for the drift tier cut: half the minimum
    one-way link latency over every band the run can visit — the current
    WAN band, every drift target band, and the routed link to every
    re-advisory target tier.  The WanShaper charges ``rtt/2`` (plus
    serialization) per message, so any window at or below this bound
    keeps barrier delivery causal; re-advisory additionally requires
    ``window <= apply_delay_s`` so a decision shipped at the next
    barrier still lands in the receiving shard's future."""
    from repro_torch.sim.scenarios import _resolve_drift, _wan_link

    cm = sc.cost_model.with_wan(sc.wan_band)
    rtts = [_wan_link(sc).latency_s]
    for d in _resolve_drift(sc):
        if d.kind == "band" and d.rtt_s is not None:
            rtts.append(d.rtt_s)
    if sc.readvise is not None:
        for tier in sc.readvise.targets:
            if tier != "cloud":
                rtts.append(cm.route("edge", tier).as_link().latency_s)
    window = min(r / 2.0 for r in rtts)
    if sc.readvise is not None:
        window = min(window, sc.readvise.apply_delay_s)
    return window


def run_drift_sharded(sc, *, shards: int = 2, mode: str = "inline") -> dict:
    """Run a drift/re-advisory scenario sharded across the tier cut;
    returns the :data:`DRIFT_PARITY_COLS` projection (plus shard
    accounting).  ``shards=1`` runs the plain unsharded
    :func:`~repro_torch.sim.scenarios.run_scenario` projected onto the same
    columns — the parity baseline.

    Refused configurations (the "too chatty to shard" conditions of
    this cut): non-``cloud`` placements (the cut is the edge→cloud WAN
    hop), open-loop arrivals (the golden's closed-loop producers keep
    shard 0's timeline independent of consumer progress), failure
    injection and autoscaling (both act on consumers the edge shard
    can't see), and ``churn``/``outage`` drift kinds (they mutate the
    consumer fleet — run those unsharded)."""
    from repro_torch.sim.scenarios import run_scenario

    if shards not in (1, 2):
        raise ValueError(f"drift sharding is the 2-way tier cut; "
                         f"got shards={shards}")
    if sc.placement != "cloud":
        raise ValueError(f"drift sharding cuts the edge→cloud WAN hop; "
                         f"placement {sc.placement!r} is not shardable")
    if sc.arrival is not None:
        raise ValueError("drift sharding needs closed-loop producers; "
                         "open-loop arrival scenarios run unsharded")
    if sc.failures or sc.autoscale is not None or sc.autoscale_stages:
        raise ValueError("failure injection / autoscaling act on the "
                         "consumer fleet across the cut — run unsharded")
    for d in sc.drift:
        if d.kind != "band":
            raise ValueError(f"drift kind {d.kind!r} mutates the consumer "
                             f"fleet across the cut — run unsharded")
    if shards == 1:
        res = run_scenario(sc)
        return {
            "processed": res.n_processed,
            "duplicates": res.n_duplicates,
            "makespan_s": res.makespan_s,
            "lat_p50_s": res.latency_p50_s,
            "lat_p95_s": res.latency_p95_s,
            "wan_bytes": res.wan_bytes,
            "swaps": [dict(s) for s in res.swaps],
            "shards": 1, "mode": "unsharded", "windows": 1,
        }
    coord = ShardCoordinator(drift_builders(sc),
                             window_s=_drift_window_s(sc), mode=mode)
    rows = coord.run()
    merged = merge_rows(rows, streaming=False)
    out = {k: merged[k] for k in DRIFT_PARITY_COLS if k != "swaps"}
    out["swaps"] = merged.get("swaps", [])
    out.update({"shards": 2, "mode": mode, "windows": coord.windows})
    return out
