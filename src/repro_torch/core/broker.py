"""Partitioned message broker — the framework's Kafka analog (paper §II-B).

The paper routes all edge→cloud dataflow through a pilot-managed Kafka broker
with one partition per edge device. On the TPU-fabric adaptation the broker's
role is *flow decoupling + placement boundary + byte accounting*, not disk
durability (the checkpoint layer owns durability; see DESIGN.md §2). So:

* a :class:`Topic` is a set of partitions; each partition is an ordered
  in-memory queue with offsets (Kafka log semantics minus the disk),
* producers append to a partition (keyed or round-robin),
* consumer groups own partition→consumer assignments and track committed
  offsets, so replayed/failed consumers resume exactly like Kafka rebalance,
* every hop stamps the shared :class:`MetricsRegistry` (produced/broker_in/
  broker_out/consumed) with serialized byte sizes, which is what the paper's
  Fig 2 throughput/latency curves measure,
* an optional :class:`WanShaper` models the XSEDE↔LRZ geo hop (140–160 ms
  RTT, 60–100 Mbit/s iPerf band) with a token bucket + latency stamp —
  the paper's geographic-distribution experiment (Fig 3 right).

Serialization is real (numpy ``tobytes``): message size on the wire equals
the paper's 8 B/point accounting, and the WAN shaper charges the actual
serialized bytes.
"""
from __future__ import annotations

import io
import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.monitoring import MetricsRegistry
from repro_torch.sim.clock import Clock, as_clock


# ---------------------------------------------------------------------------
# message + serialization
# ---------------------------------------------------------------------------

_msg_counter = itertools.count()


def _serialize(payload: Any) -> bytes:
    """numpy-first serialization; sizes match the paper's 8 B/float64 points."""
    if isinstance(payload, np.ndarray):
        buf = io.BytesIO()
        np.save(buf, payload, allow_pickle=False)
        return buf.getvalue()
    if isinstance(payload, bytes):
        return payload
    import pickle
    return pickle.dumps(payload)


def _deserialize(raw: bytes) -> Any:
    if raw[:6] == b"\x93NUMPY":
        return np.load(io.BytesIO(raw), allow_pickle=False)
    if raw[:1] == b"\x80":
        # our own _serialize always emits protocol>=2 pickles, which start
        # with the PROTO opcode — cheaper than a try/except pickle probe,
        # and raw bytes payloads (which can't start with \x80 unless they
        # really are pickles) round-trip untouched
        import pickle
        try:
            return pickle.loads(raw)
        except Exception:
            return raw
    return raw


@dataclass(slots=True)
class Message:
    msg_id: str
    key: Optional[str]
    raw: bytes
    offset: int = -1
    partition: int = -1

    @property
    def nbytes(self) -> int:
        return len(self.raw)

    def value(self) -> Any:
        return _deserialize(self.raw)


# ---------------------------------------------------------------------------
# WAN shaper (geo-distribution model)
# ---------------------------------------------------------------------------


@dataclass
class WanShaper:
    """Token-bucket bandwidth + fixed-latency model of the paper's
    intercontinental hop. ``bandwidth_bps`` is bits/s; ``rtt_s`` one-way
    latency is rtt/2 applied per message. Deterministic when ``sleep=False``
    (latency is *accounted* in the metrics clock instead of slept) so tests
    and benchmarks can run fast while still measuring the paper's numbers."""
    bandwidth_bps: float = 80e6          # 60–100 Mbit/s band midpoint
    rtt_s: float = 0.150                 # 140–160 ms band midpoint
    sleep: bool = False                  # real sleeps (live demo) or virtual
    _available_at: float = field(default=0.0, init=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, init=False)

    def delay_for(self, nbytes: int, now: float) -> float:
        """Seconds until the message clears the WAN, from ``now``."""
        tx = nbytes * 8.0 / self.bandwidth_bps
        with self._lock:
            start = max(now, self._available_at)
            self._available_at = start + tx       # serialize on the link
        return (start - now) + tx + self.rtt_s / 2.0


# ---------------------------------------------------------------------------
# broker
# ---------------------------------------------------------------------------


class _Partition:
    def __init__(self):
        self.log: List[Message] = []
        self.ready_at: List[float] = []      # WAN-shaped visibility time
        self.base = 0                        # absolute offset of log[0]
        self.truncated = 0                   # messages reclaimed so far
        self.cond = threading.Condition()

    def append(self, msg: Message, ready_at: float) -> int:
        with self.cond:
            msg.offset = self.base + len(self.log)
            # ready_at first: lock-free readers (poll_nowait) gate on
            # len(log), so by the time a message is observable its
            # visibility time is already in place
            self.ready_at.append(ready_at)
            self.log.append(msg)
            self.cond.notify_all()
            return msg.offset

    def append_unlocked(self, msg: Message, ready_at: float) -> int:
        """Single-owner append: no condition lock, no notify.  Only valid
        when one thread owns the whole broker (``Topic.single_owner``) —
        nobody blocks in ``poll`` then, so the notify is dead weight and
        the lock pure overhead."""
        msg.offset = self.base + len(self.log)
        self.ready_at.append(ready_at)
        self.log.append(msg)
        return msg.offset


class Topic:
    def __init__(self, name: str, n_partitions: int,
                 metrics: MetricsRegistry,
                 shaper: Optional[WanShaper] = None,
                 clock: Optional[Clock] = None,
                 truncate_batch: Optional[int] = None):
        self.name = name
        self.partitions = [_Partition() for _ in range(n_partitions)]
        self.metrics = metrics
        self.shaper = shaper
        # single-owner mode: set by the DES executor when exactly one
        # thread drives every producer/consumer of this topic.  Elides the
        # partition condition locks on the append / locked-poll / truncate
        # paths (the locked poll_nowait variant the truncation feature
        # added is the profiled hot spot this removes).
        self.single_owner = False
        self._clock = as_clock(clock)
        self._rr = itertools.count()
        # dict-keyed (insertion-ordered) so subscribe is idempotent and
        # unsubscribe is O(1); produce iterates an immutable snapshot tuple
        # rebuilt only on membership change — no per-message lock/copy
        self._subs: Dict[Any, None] = {}
        self._subs_cache: Tuple = ()
        self._subs_lock = threading.Lock()
        # log truncation (Kafka retention analog): entries strictly below
        # the minimum committed offset across registered consumer groups
        # are reclaimed in ``truncate_batch``-sized chunks.  None disables
        # truncation (the default: logs grow unboundedly, exactly the
        # pre-truncation behavior, and readers stay lock-free).
        self.truncate_batch = truncate_batch
        self._groups: Dict["ConsumerGroup", None] = {}
        self._groups_cache: Tuple = ()
        self._trunc_cbs: Dict[Any, None] = {}
        self._trunc_cbs_cache: Tuple = ()

    # -- append notifications ---------------------------------------------

    def subscribe(self, fn) -> None:
        """Register ``fn(partition, ready_at)`` to fire after every append.
        This is what makes event-driven consumers possible: instead of
        polling on a sleep cadence, a parked consumer is woken exactly when
        a message lands (or becomes WAN-visible). Callbacks run on the
        producing thread/event and must not block.  Subscribing the same
        fn twice is a no-op (it fires once per append, not twice)."""
        with self._subs_lock:
            if fn not in self._subs:
                self._subs[fn] = None
                self._subs_cache = tuple(self._subs)

    def unsubscribe(self, fn) -> None:
        """Remove ``fn``; unknown subscribers are tolerated."""
        with self._subs_lock:
            if fn in self._subs:
                del self._subs[fn]
                self._subs_cache = tuple(self._subs)

    def _honor_visibility(self) -> bool:
        """WAN-shaped visibility times are enforced when waiting for them
        is free: either the shaper really sleeps (live demo) or the clock
        is virtual (emulation, where time jumps to ``ready_at``).  With a
        real clock and ``sleep=False`` the latency is accounted in the
        metrics only — the seed's fast mode — so messages stay immediately
        visible."""
        return self.shaper is not None and (self.shaper.sleep
                                            or self._clock.virtual)

    @property
    def n_partitions(self) -> int:
        return len(self.partitions)

    # -- producer side ---------------------------------------------------

    def produce(self, payload: Any, *, key: Optional[str] = None,
                partition: Optional[int] = None,
                msg_id: Optional[str] = None) -> Message:
        raw = _serialize(payload)
        if msg_id is None:
            msg_id = f"{self.name}-{next(_msg_counter)}"
        if partition is None:
            if key is not None:
                partition = hash(key) % self.n_partitions
            else:
                partition = next(self._rr) % self.n_partitions
        msg = Message(msg_id=msg_id, key=key, raw=raw, partition=partition)
        now = self._clock.now()
        self.metrics.stamp(msg_id, "produced", bytes=msg.nbytes,
                           partition=partition)
        delay = 0.0
        if self.shaper is not None:
            delay = self.shaper.delay_for(msg.nbytes, now)
            if self.shaper.sleep and delay > 0:
                self._clock.sleep(delay)
                delay = 0.0
        part = self.partitions[partition]
        if self.single_owner:
            part.append_unlocked(msg, now + delay)
        else:
            part.append(msg, now + delay)
        self.metrics.stamp(msg_id, "broker_in", wan_delay_s=delay)
        self.metrics.incr(f"topic.{self.name}.bytes_in", msg.nbytes)
        self.metrics.incr(f"topic.{self.name}.msgs_in")
        if delay > 0.0:
            # produce-side observation of the shaped hop (queueing + tx +
            # one-way latency) — what the ReAdvisor watches for link drift.
            # Only shaped topics ever grow the counter, and every shaped
            # message carries rtt/2 > 0, so msgs_in deltas are the matching
            # denominator for a windowed mean.
            self.metrics.incr(f"topic.{self.name}.wan_delay_s", delay)
        for fn in self._subs_cache:     # immutable snapshot: no lock/copy
            fn(partition, now + delay)
        return msg

    def inject(self, raw: bytes, *, msg_id: str, partition: int,
               ready_at: float, key: Optional[str] = None,
               produced_t: Optional[float] = None) -> Message:
        """Boundary-queue delivery for sharded DES runs: append an
        already-serialized message with an explicit visibility time.

        Unlike :meth:`produce` this charges **no** shaper delay and does
        **not** count ``bytes_in``/``msgs_in``/``broker_in`` — the shard
        that originally produced the message owns those stamps and
        counters, so cross-shard traffic is never double-counted.  When
        ``produced_t`` is given the message's ``produced`` stamp is
        re-created in this shard's registry at its original time, so
        end-to-end latency percentiles computed here match an unsharded
        run."""
        msg = Message(msg_id=msg_id, key=key, raw=raw, partition=partition)
        if produced_t is not None:
            self.metrics.stamp(msg_id, "produced", t=produced_t,
                               bytes=msg.nbytes, partition=partition)
        part = self.partitions[partition]
        if self.single_owner:
            part.append_unlocked(msg, ready_at)
        else:
            part.append(msg, ready_at)
        for fn in self._subs_cache:
            fn(partition, ready_at)
        return msg

    # -- consumer side -----------------------------------------------------

    def poll(self, partition: int, offset: int,
             timeout_s: float = 1.0) -> Optional[Message]:
        """Blocking fetch of the message at ``offset`` in ``partition``.
        Honors WAN-shaped visibility times (a message 'in flight' across the
        WAN is not yet visible) whenever waiting for them is free — see
        :meth:`_honor_visibility`."""
        part = self.partitions[partition]
        honor = self._honor_visibility()
        deadline = self._clock.now() + timeout_s
        with part.cond:
            while True:
                now = self._clock.now()
                idx = offset - part.base
                if idx < 0:
                    raise KeyError(
                        f"offset {offset} below log start {part.base} of "
                        f"{self.name}[{partition}] (truncated)")
                if idx < len(part.log):
                    ready = part.ready_at[idx]
                    if honor and now < ready:
                        if now >= deadline:
                            return None
                        self._clock.wait(part.cond,
                                         min(ready - now, deadline - now))
                        continue
                    msg = part.log[idx]
                    self.metrics.stamp(
                        msg.msg_id, "broker_out",
                        visible_at=ready)
                    return msg
                remaining = deadline - now
                if remaining <= 0:
                    return None
                self._clock.wait(part.cond, remaining)

    def poll_nowait(self, partition: int, offset: int
                    ) -> Tuple[Optional[Message], Optional[float]]:
        """Non-blocking fetch for event-driven consumers.  Returns
        ``(message, None)`` when the message is visible now,
        ``(None, ready_at)`` when it exists but is still crossing the WAN
        (retry at ``ready_at``), and ``(None, None)`` when nothing has been
        produced at this offset yet."""
        part = self.partitions[partition]
        if self.truncate_batch is not None:
            if self.single_owner:
                # single-owner fast path: truncation can only run on this
                # same thread, so the base-aware read needs no lock — this
                # elides the locked poll_nowait variant on the DES path
                return self._poll_nowait_at(part, partition, offset)
            # truncation compacts log/ready_at in place under part.cond;
            # the lock-free index dance below would race with it
            with part.cond:
                return self._poll_nowait_at(part, partition, offset)
        # lock-free: append() publishes ready_at before log, list reads
        # are atomic under the GIL, and base is pinned at 0 when truncation
        # is off — the event-driven hot path pays no lock
        log = part.log
        if offset >= len(log):
            return None, None
        ready = part.ready_at[offset]
        if self._honor_visibility() and self._clock.now() < ready:
            return None, ready
        msg = log[offset]
        self.metrics.stamp(msg.msg_id, "broker_out", visible_at=ready)
        return msg, None

    def _poll_nowait_at(self, part: _Partition, partition: int, offset: int
                        ) -> Tuple[Optional[Message], Optional[float]]:
        """Base-aware fetch; caller holds ``part.cond``."""
        idx = offset - part.base
        if idx < 0:
            raise KeyError(
                f"offset {offset} below log start {part.base} of "
                f"{self.name}[{partition}] (truncated)")
        if idx >= len(part.log):
            return None, None
        ready = part.ready_at[idx]
        if self._honor_visibility() and self._clock.now() < ready:
            return None, ready
        msg = part.log[idx]
        self.metrics.stamp(msg.msg_id, "broker_out", visible_at=ready)
        return msg, None

    def end_offsets(self) -> List[int]:
        return [p.base + len(p.log) for p in self.partitions]

    def log_start_offsets(self) -> List[int]:
        """First retained absolute offset per partition (Kafka's
        ``logStartOffset``); 0 until truncation reclaims a prefix."""
        return [p.base for p in self.partitions]

    def log_sizes(self) -> List[int]:
        """Messages currently held in memory per partition."""
        return [len(p.log) for p in self.partitions]

    @property
    def truncated_msgs(self) -> int:
        """Total messages reclaimed from this topic's logs."""
        return sum(p.truncated for p in self.partitions)

    # -- log truncation ----------------------------------------------------

    def _register_group(self, group: "ConsumerGroup") -> None:
        with self._subs_lock:
            if group not in self._groups:
                self._groups[group] = None
                self._groups_cache = tuple(self._groups)

    def on_truncate(self, fn) -> None:
        """Register ``fn(partition, msg_ids)`` to fire after a prefix of a
        partition log is reclaimed, with the reclaimed message ids.  Lets
        downstream bookkeeping (e.g. dedup sets keyed by msg_id) drop
        entries for messages that can never be redelivered.  Callbacks run
        on the committing thread/event and must not block."""
        with self._subs_lock:
            if fn not in self._trunc_cbs:
                self._trunc_cbs[fn] = None
                self._trunc_cbs_cache = tuple(self._trunc_cbs)

    def maybe_truncate(self, partition: int) -> int:
        """Reclaim the partition-log prefix below the group-minimum
        committed offset, if it has reached ``truncate_batch`` messages.
        Returns the number of messages reclaimed (0 when truncation is
        disabled, the batch threshold is not met, or no group exists —
        with no groups nothing is safely consumable, so nothing is
        dropped).  Absolute offsets are preserved: ``log[0]`` simply moves
        to ``base``, and a read below ``base`` raises."""
        if self.truncate_batch is None:
            return 0
        groups = self._groups_cache
        if not groups:
            return 0
        # int list reads are GIL-atomic; a stale value only under-truncates
        safe = min(g.committed[partition] for g in groups)
        part = self.partitions[partition]
        if self.single_owner:
            reclaim = safe - part.base
            if reclaim < self.truncate_batch:
                return 0
            reclaimed_ids = [m.msg_id for m in part.log[:reclaim]]
            del part.log[:reclaim]
            del part.ready_at[:reclaim]
            part.base = safe
            part.truncated += reclaim
        else:
            with part.cond:
                reclaim = safe - part.base
                if reclaim < self.truncate_batch:
                    return 0
                reclaimed_ids = [m.msg_id for m in part.log[:reclaim]]
                del part.log[:reclaim]
                del part.ready_at[:reclaim]
                part.base = safe
                part.truncated += reclaim
        self.metrics.incr(f"topic.{self.name}.truncated_msgs", reclaim)
        for fn in self._trunc_cbs_cache:
            fn(partition, reclaimed_ids)
        return reclaim


class ConsumerGroup:
    """Kafka-like consumer group: partition assignment + committed offsets.

    ``assign(consumer_id)`` splits partitions round-robin across registered
    consumers; on consumer failure, ``rebalance`` re-assigns its partitions
    and surviving consumers resume from the committed offsets (at-least-once
    delivery, like Kafka).
    """

    def __init__(self, topic: Topic, group_id: str = "default"):
        self.topic = topic
        self.group_id = group_id
        self._clock = topic._clock
        self._lock = threading.Lock()
        # a new group starts at the log-start offsets: everything still
        # retained replays (Kafka auto.offset.reset=earliest), truncated
        # prefixes are gone by definition.  Registration makes this
        # group's committed offsets part of the truncation safety bound.
        self.committed = list(topic.log_start_offsets())
        topic._register_group(self)
        # dict-keyed membership: O(1) join/leave at 1000s of consumers
        # (insertion-ordered, so round-robin assignment is deterministic)
        self._members: Dict[str, None] = {}
        self.assignment: Dict[str, List[int]] = {}

    @property
    def members(self) -> List[str]:
        return list(self._members)

    def join(self, consumer_id: str) -> List[int]:
        with self._lock:
            self._members[consumer_id] = None
            self._rebalance_locked()
            return list(self.assignment.get(consumer_id, []))

    def leave(self, consumer_id: str) -> None:
        with self._lock:
            self._members.pop(consumer_id, None)
            self._rebalance_locked()

    def _rebalance_locked(self) -> None:
        # builds a *fresh* dict of fresh lists every time, so snapshots
        # handed out by partitions_for stay valid across rebalances
        members = list(self._members)
        self.assignment = {m: [] for m in members}
        if not members:
            return
        n = len(members)
        for p in range(self.topic.n_partitions):
            self.assignment[members[p % n]].append(p)

    _NO_PARTITIONS: List[int] = []

    def partitions_for(self, consumer_id: str) -> List[int]:
        """Current assignment snapshot. Treat as read-only: rebalances
        replace (never mutate) the lists, so no per-call lock or copy."""
        asg = self.assignment.get(consumer_id)
        return asg if asg is not None else ConsumerGroup._NO_PARTITIONS

    def poll(self, consumer_id: str,
             timeout_s: float = 1.0) -> Optional[Message]:
        """Fetch the next uncommitted message from any assigned partition."""
        parts = self.partitions_for(consumer_id)
        deadline = self._clock.now() + timeout_s
        while self._clock.now() < deadline or timeout_s == 0:
            for p in parts:
                with self._lock:
                    off = self.committed[p]
                end = self.topic.partitions[p]
                if off < end.base + len(end.log):
                    msg = self.topic.poll(p, off, timeout_s=0.01)
                    if msg is not None:
                        self.topic.metrics.stamp(msg.msg_id, "consumed",
                                                 consumer=consumer_id)
                        return msg
            if timeout_s == 0:
                return None
            self._clock.sleep(0.001)
        return None

    def poll_nowait(self, consumer_id: str
                    ) -> Tuple[Optional[Message], Optional[float]]:
        """Event-driven fetch: the next uncommitted *visible* message from
        any assigned partition, or ``(None, earliest_ready_at)`` when
        everything pending is still crossing the WAN (``(None, None)`` when
        nothing is pending at all)."""
        next_ready: Optional[float] = None
        for p in self.partitions_for(consumer_id):
            off = self.committed[p]     # int list read: GIL-atomic
            msg, ready = self.topic.poll_nowait(p, off)
            if msg is not None:
                self.topic.metrics.stamp(msg.msg_id, "consumed",
                                         consumer=consumer_id)
                return msg, None
            if ready is not None:
                next_ready = ready if next_ready is None \
                    else min(next_ready, ready)
        return None, next_ready

    def commit(self, msg: Message) -> None:
        if self.topic.single_owner:
            p = msg.partition
            if msg.offset + 1 > self.committed[p]:
                self.committed[p] = msg.offset + 1
        else:
            with self._lock:
                self.committed[msg.partition] = max(
                    self.committed[msg.partition], msg.offset + 1)
        # outside the group lock: truncation takes partition locks and may
        # fire on_truncate callbacks into downstream bookkeeping
        self.topic.maybe_truncate(msg.partition)

    def lag(self) -> int:
        ends = self.topic.end_offsets()
        with self._lock:
            return sum(e - c for e, c in zip(ends, self.committed))


class Broker:
    """Named-topic registry — one Broker per (pilot-managed) brokering
    service. Plugin point: the paper swaps Kafka↔MQTT here; we ship the
    in-memory implementation and keep the API surface minimal so an MQTT/
    Kafka binding is a drop-in."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 clock: Optional[Clock] = None):
        self._clock = as_clock(clock)
        self.metrics = metrics or MetricsRegistry(clock=self._clock)
        self._topics: Dict[str, Topic] = {}
        self._lock = threading.Lock()

    def create_topic(self, name: str, n_partitions: int = 1,
                     shaper: Optional[WanShaper] = None,
                     truncate_batch: Optional[int] = None) -> Topic:
        with self._lock:
            if name in self._topics:
                raise ValueError(f"topic {name!r} exists")
            t = Topic(name, n_partitions, self.metrics, shaper,
                      clock=self._clock, truncate_batch=truncate_batch)
            self._topics[name] = t
            return t

    def topic(self, name: str) -> Topic:
        return self._topics[name]

    def consumer_group(self, topic_name: str,
                       group_id: str = "default") -> ConsumerGroup:
        return ConsumerGroup(self.topic(topic_name), group_id)
