"""The sharded DES (``repro_torch.sim.shard``) against the reference
(``repro.sim.shard``) on the CPU.

The cases of tests/test_shard.py run through the port: the SplitMix64
seed pins, ``split_blocks``, the lookahead, boundary injection, the 1/2/4
shard and mp-vs-inline bit-identity on the 2,000-message cell, the
streaming merge and the tier cut's causality and reruns.  Every DES
column is virtual-time arithmetic, so each deterministic column of the
port's rows must also equal the reference's exactly.  The shard builders
run with no card: their pilot managers hold no devices."""
import math

import numpy as np
import pytest

import repro.sim.shard as jshard
import repro_torch.sim.shard as tshard
from repro_torch.core import ComputeResource, PilotManager
from repro_torch.core.broker import Broker
from repro_torch.core.faas import ContinuumPipeline, StageSpec
from repro_torch.core.monitoring import MetricsRegistry
from repro_torch.core.placement import PlacementEngine
from repro_torch.sim.clock import SimClock
from repro_torch.sim.shard import (ShardCoordinator, build_scale_shard,
                                   lookahead_s, merge_rows,
                                   run_scale_sharded, shard_seed,
                                   split_blocks, tier_cut_builders)

# tests/test_shard.py:165
_DET_KEYS = ("processed", "duplicates", "truncated_msgs", "makespan_s",
             "lat_p50_s", "lat_p95_s", "wan_bytes")


def test_shard_seed_pinned():
    assert shard_seed(0, 0) == 16294208416658607535
    assert shard_seed(0, 1) == 7960286522194355700
    assert shard_seed(0, 2) == 487617019471545679
    assert shard_seed(12345, 7) == 7959005890829367068


def test_shard_seed_streams_distinct_and_equal_to_reference():
    seen = set()
    for seed in range(8):
        for sid in range(64):
            z = shard_seed(seed, sid)
            assert z == jshard.shard_seed(seed, sid)
            assert 0 <= z < 2 ** 64
            seen.add(z)
    assert len(seen) == 8 * 64
    assert shard_seed(0, 1) != shard_seed(1, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_blocks_properties(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(0, 200))
        k = int(rng.integers(1, 17))
        blocks = split_blocks(n, k)
        assert blocks == jshard.split_blocks(n, k)
        assert len(blocks) == k
        flat = [i for lo, hi in blocks for i in range(lo, hi)]
        assert flat == list(range(n))
        sizes = [hi - lo for lo, hi in blocks]
        assert max(sizes) - min(sizes) <= 1


def test_split_blocks_monotone_in_n_and_rejects_bad_k():
    for k in (1, 2, 3, 5, 8):
        for devices in (3, 8, 17):
            for consumers in (devices, devices + 1, 4 * devices):
                dev = split_blocks(devices, k)
                con = split_blocks(consumers, k)
                for (dlo, dhi), (clo, chi) in zip(dev, con):
                    assert chi - clo >= dhi - dlo
    with pytest.raises(ValueError):
        split_blocks(10, 0)


def test_lookahead_from_cost_model():
    import repro.core.placement as jplacement
    cost = PlacementEngine().cost
    la = lookahead_s(cost, [("edge", "cloud")])
    assert la == cost.route("edge", "cloud").transfer_s(0.0)
    assert la > 0.0
    cuts = [("edge", "cloud"), ("device", "edge")]
    multi = lookahead_s(cost, cuts)
    assert multi == min(cost.route("edge", "cloud").transfer_s(0.0),
                        cost.route("device", "edge").transfer_s(0.0))
    assert multi == jshard.lookahead_s(jplacement.PlacementEngine().cost,
                                       cuts)
    assert lookahead_s(cost, []) == math.inf


def test_inject_skips_ingress_accounting():
    clock = SimClock()
    metrics = MetricsRegistry(clock=clock)
    broker = Broker(metrics=metrics, clock=clock)
    topic = broker.create_topic("boundary", n_partitions=2)
    msg = topic.inject(b"x" * 32, msg_id="m-1", partition=1, ready_at=4.0,
                       produced_t=2.5)
    assert metrics.counter("topic.boundary.bytes_in") == 0.0
    assert metrics.counter("topic.boundary.msgs_in") == 0.0
    part = topic.partitions[1]
    assert part.log[-1] is msg
    assert part.ready_at[-1] == 4.0
    assert metrics.trace("m-1").stamps["produced"] == 2.5


def test_scale_shard_refuses_partition_coupling():
    with pytest.raises(ValueError, match="too chatty"):
        run_scale_sharded(arrival="poisson", messages=10, devices=4,
                          consumers=2, rate_hz=100.0, payload_bytes=8,
                          service_s=0.0, seed=0, shards=2)
    with pytest.raises(ValueError, match="shards"):
        run_scale_sharded(arrival="poisson", messages=10, devices=4,
                          consumers=4, rate_hz=100.0, payload_bytes=8,
                          service_s=0.0, seed=0, shards=8)


def test_zero_task_stage_and_bad_partitions_raise():
    mgr = PilotManager(devices=())
    edge = mgr.submit_pilot(ComputeResource(tier="edge", n_workers=2))
    cloud = mgr.submit_pilot(ComputeResource(tier="cloud", n_workers=2))
    stages = [StageSpec("produce", lambda ctx: b"", pilot=edge, n_tasks=0),
              StageSpec("process", lambda ctx, data=None: None,
                        pilot=cloud, n_tasks=2)]
    with pytest.raises(ValueError):
        ContinuumPipeline(stages=stages, clock=SimClock())
    pipe = ContinuumPipeline(stages=stages, n_partitions=3,
                             clock=SimClock())
    assert pipe.n_partitions == 3
    assert pipe.stage_tasks(0) == 0
    mgr.release_all()


def _sharded_cell(mod, shards, mode="inline", **overrides):
    cfg = dict(arrival="poisson", messages=2000, devices=6, consumers=9,
               rate_hz=1000.0, payload_bytes=48, service_s=0.002, seed=11,
               shards=shards, mode=mode)
    cfg.update(overrides)
    return mod.run_scale_sharded(**cfg)


@pytest.fixture(scope="module")
def reference_cell():
    return _sharded_cell(jshard, 1)


def test_shard_counts_1_2_4_bit_identical_to_reference(reference_cell):
    rows = {k: _sharded_cell(tshard, k) for k in (1, 2, 4)}
    assert rows[1]["processed"] == 2000
    for k in (1, 2, 4):
        for key in _DET_KEYS:
            assert rows[k][key] == reference_cell[key], (
                f"{key} at {k} shards: {rows[k][key]!r} "
                f"!= reference {reference_cell[key]!r}")
    assert rows[4]["cpu_critical_s"] <= rows[4]["cpu_s_total"] + 1e-9
    assert rows[4]["windows"] == 1


def test_shard_mp_matches_inline_and_reference(reference_cell):
    a = _sharded_cell(tshard, 2, mode="inline")
    b = _sharded_cell(tshard, 2, mode="mp")
    for key in _DET_KEYS:
        assert a[key] == b[key] == reference_cell[key]


def test_shard_streaming_sketch_merge_identical():
    a = _sharded_cell(tshard, 1, streaming=True)
    b = _sharded_cell(tshard, 3, streaming=True)
    ref = _sharded_cell(jshard, 3, streaming=True)
    for key in _DET_KEYS:
        assert a[key] == b[key] == ref[key]


def test_merge_rows_exact_percentiles():
    rows = [
        {"processed": 2, "duplicates": 0, "events": 5, "truncated_msgs": 0,
         "wan_bytes": 10.0, "first_produced": 0.5, "last_processed": 3.0,
         "latencies": [0.3, 0.1]},
        {"processed": 3, "duplicates": 1, "events": 7, "truncated_msgs": 2,
         "wan_bytes": 20.0, "first_produced": 0.2, "last_processed": 4.0,
         "latencies": [0.2, 0.5, 0.4]},
    ]
    merged = merge_rows(rows, streaming=False)
    assert merged == jshard.merge_rows(rows, streaming=False)
    lat = sorted([0.3, 0.1, 0.2, 0.5, 0.4])
    assert merged["processed"] == 5
    assert merged["duplicates"] == 1
    assert merged["truncated_msgs"] == 2
    assert merged["wan_bytes"] == 30.0
    assert merged["makespan_s"] == pytest.approx(4.0 - 0.2)
    assert merged["lat_p50_s"] == lat[len(lat) // 2]
    assert merged["lat_p95_s"] == lat[min(len(lat) - 1,
                                          int(0.95 * len(lat)))]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_tier_cut_windows_never_violate_causality(seed):
    """With window <= lookahead no cross-shard message is visible or
    consumed before its ``ready_at``, every message arrives, and the
    merged row equals the reference's tier cut on the same draw."""
    rng = np.random.default_rng(seed)
    devices = int(rng.integers(2, 6))
    consumers = int(rng.integers(devices, 2 * devices + 1))
    messages = int(rng.integers(100, 400))
    rate_hz = float(rng.uniform(50.0, 400.0))
    payload = int(rng.integers(16, 256))
    rtt_s = float(rng.uniform(0.02, 0.2))
    lookahead = rtt_s / 2.0
    window = lookahead * float(rng.uniform(0.3, 1.0))
    cfg = dict(messages=messages, devices=devices, consumers=consumers,
               rate_hz=rate_hz, payload_bytes=payload, seed=seed,
               bandwidth_bps=80e6, rtt_s=rtt_s,
               timeout_s=messages / rate_hz + 60.0)
    coord = ShardCoordinator(tier_cut_builders(cfg), window_s=window,
                             mode="inline")
    rows = coord.run()
    edge, cloud = coord.runners
    assert coord.windows > 1
    assert len(cloud.injected) == messages
    assert rows[1]["processed"] == messages
    assert rows[0]["wan_bytes"] == float(messages * payload)
    assert rows[1]["wan_bytes"] == 0.0
    m = cloud.metrics
    for msg_id, (t_inject, ready_at) in cloud.injected.items():
        assert t_inject <= ready_at + 1e-12
        tr = m.trace(msg_id)
        assert tr is not None
        for event in ("broker_out", "consumed", "processed"):
            t = tr.stamps.get(event)
            if t is not None:
                assert t >= ready_at - 1e-12
    lat = m.latencies("produced", "processed")
    assert len(lat) == messages
    assert min(lat) >= lookahead - 1e-12
    ref = jshard.ShardCoordinator(jshard.tier_cut_builders(cfg),
                                  window_s=window, mode="inline")
    want = jshard.merge_rows(ref.run(), streaming=False)
    got = merge_rows(rows, streaming=False)
    assert coord.windows == ref.windows
    for key in _DET_KEYS:
        assert got[key] == want[key]


@pytest.mark.parametrize("seed", [0, 1])
def test_tier_cut_deterministic_across_reruns(seed):
    cfg = dict(messages=150, devices=3, consumers=4, rate_hz=150.0,
               payload_bytes=32, seed=seed, bandwidth_bps=50e6,
               rtt_s=0.08, timeout_s=60.0)

    def run_once(mod):
        coord = mod.ShardCoordinator(mod.tier_cut_builders(cfg),
                                     window_s=0.03, mode="inline")
        return mod.merge_rows(coord.run(), streaming=False)

    a, b, ref = run_once(tshard), run_once(tshard), run_once(jshard)
    for key in _DET_KEYS:
        assert a[key] == b[key] == ref[key]


def test_build_scale_shard_message_totals():
    cfg = dict(shards=3, arrival="poisson", messages=500, devices=4,
               consumers=4, rate_hz=500.0, payload_bytes=8, service_s=0.0,
               seed=7, streaming=False, truncate_logs=None, trace=None)
    totals = []
    for sid in range(3):
        runner = build_scale_shard(dict(cfg, shard_id=sid))
        totals.append(runner.handle.state.n_messages)
        runner.handle.finish()
    blocks = split_blocks(cfg["devices"], 3)
    expect = [sum(len(range(g, cfg["messages"], cfg["devices"]))
                  for g in range(lo, hi)) for lo, hi in blocks]
    assert totals == expect
    assert sum(totals) == cfg["messages"]


def test_shard_builders_need_no_card(monkeypatch):
    """The repair: the reference's builders call ``PilotManager()`` with
    no devices, which in the port inventories the CUDA cards.  The port's
    builders pass ``devices=()``, so they build where no card is visible
    (simulated here even on a host that has one)."""
    import torch

    import repro_torch.core.pilot as pilot
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pilot.PilotError, match="no CUDA device"):
        PilotManager()
    cfg = dict(shards=2, shard_id=0, arrival="poisson", messages=20,
               devices=2, consumers=2, rate_hz=100.0, payload_bytes=8,
               service_s=0.0, seed=0, streaming=False, truncate_logs=None,
               trace=None)
    runner = build_scale_shard(cfg)
    assert runner.mgr.pilots()
    runner.handle.finish()
    cut = dict(messages=10, devices=2, consumers=2, rate_hz=100.0,
               payload_bytes=8, seed=0, bandwidth_bps=50e6, rtt_s=0.08,
               timeout_s=30.0)
    for builder, c in tier_cut_builders(cut):
        builder(c).handle.finish()
