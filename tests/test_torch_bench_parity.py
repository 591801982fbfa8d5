"""The bench-parity gate: the default grids of ``benchmarks/bench_sim.py``,
``benchmarks/bench_placement.py`` and ``benchmarks/bench_drift.py`` run
through both packages' functions on the CPU, and every deterministic
column must be equal exactly.

Each grid is the benchmark's own default (its argparse defaults), split
by model so that each case stays a few seconds.  Every column compared
here is virtual-time arithmetic on the same calibration; wall-clock
columns are not in the rows.  The drift golden is further held against
the committed ``BENCH_drift.json``: 225.82687481079788 s static and
13.19789047038462 s re-advised ``lat_p95_s``, one cloud→fog swap, at one
shard and at two."""
import json
import os

import pytest

import repro.cost.advisor as jadv
import repro.cost.readvisor as jrv
import repro.sim.scenarios as jsc
import repro.sim.shard as jshard
import repro_torch.cost.advisor as tadv
import repro_torch.cost.readvisor as trv
import repro_torch.sim.scenarios as tsc
import repro_torch.sim.shard as tshard

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKGS = {"ref": (jsc, jrv, jadv, jshard), "port": (tsc, trv, tadv, tshard)}


def _sim_rows(pkg, model, with_failures):
    """bench_sim.py's default sweep (64 messages, 4 devices, 2,500
    points, every placement, the 10/50/100 mbit bands, sigma 0, no
    speculation; ``--with-failures`` adds bench_sim.py:65-67's crash)."""
    sc = PKGS[pkg][0]
    failures = ((sc.FailureSpec(at_s=2.0, consumer_idx=0,
                                restart_after_s=1.0),)
                if with_failures else ())
    res = sc.sweep(models=[sc.MODELS[model]], placements=sc.PLACEMENTS,
                   bands=["10mbit", "50mbit", "100mbit"], n_messages=64,
                   n_devices=4, n_points=2_500, seed=0, failures=failures,
                   service_sigma=0.0, speculative_factor=0.0)
    return [r.row() for r in res]


@pytest.mark.parametrize("with_failures", [False, True],
                         ids=["plain", "with-failures"])
@pytest.mark.parametrize("model", sorted(jsc.MODELS))
def test_bench_sim_grid_bit_identical(model, with_failures):
    want = _sim_rows("ref", model, with_failures)
    got = _sim_rows("port", model, with_failures)
    assert len(got) == len(jsc.PLACEMENTS) * 3
    assert got == want


def _placement_rows(pkg, model):
    """bench_placement.py's default advisory (32 messages, 4 devices,
    2,500 points, calibrated sigma, every placement and band)."""
    sc, adv = PKGS[pkg][0], PKGS[pkg][2]
    advisor = adv.PlacementAdvisor(n_messages=32, n_devices=4,
                                   n_points=2_500, seed=0,
                                   service_sigma=None,
                                   speculative_factor=0.0)
    bands = sorted(sc.WAN_BANDS, key=lambda b: sc.WAN_BANDS[b][0])
    return advisor.advise(model, placements=list(sc.PLACEMENTS),
                          bands=bands, latency_budget=None,
                          wan_budget=None, hybrid_reduce=None,
                          metro_bands=None).rows()


@pytest.mark.parametrize("model", sorted(jsc.MODELS))
def test_bench_placement_advisory_bit_identical(model):
    want = _placement_rows("ref", model)
    got = _placement_rows("port", model)
    assert len(got) == len(jsc.PLACEMENTS) * len(jsc.WAN_BANDS)
    assert got == want


def _drift_golden(pkg):
    """bench_drift.py's ``golden`` at its defaults (60 messages, 25,000
    points, seed 3, 100→10 mbit at 8 s, speculation 2, re-advised every
    2 s with hysteresis 3)."""
    sc, rv = PKGS[pkg][0], PKGS[pkg][1]
    return sc.Scenario(
        placement="cloud", wan_band="100mbit", n_messages=60,
        n_points=25_000, gen_s_per_point=1.28e-4, seed=3,
        speculative_factor=2.0,
        drift=(sc.DriftSpec(at_s=8.0, kind="band", band="10mbit"),),
        readvise=rv.ReAdviseSpec(interval_s=2.0, min_samples=2,
                                 hysteresis=3.0))


@pytest.fixture(scope="module")
def bench_drift_json():
    with open(os.path.join(ROOT, "BENCH_drift.json")) as f:
        return json.load(f)


def _json_round(x):
    return json.loads(json.dumps(x, default=float))


@pytest.mark.parametrize("variant", ["static", "readvised"])
def test_bench_drift_rows_equal_committed_golden(variant, bench_drift_json):
    from dataclasses import replace
    rows = {}
    for pkg in PKGS:
        sc = _drift_golden(pkg)
        if variant == "static":
            sc = replace(sc, readvise=None)
        rows[pkg] = _json_round(PKGS[pkg][0].run_scenario(sc).row())
    assert rows["port"] == rows["ref"] == bench_drift_json[variant]
    p95 = {"static": 225.82687481079788, "readvised": 13.19789047038462}
    assert rows["port"]["lat_p95_s"] == p95[variant]


@pytest.mark.parametrize("shards,mode", [(1, "inline"), (2, "inline"),
                                         (2, "mp")])
def test_bench_drift_sharded_parity(shards, mode, bench_drift_json):
    got = tshard.run_drift_sharded(_drift_golden("port"), shards=shards,
                                   mode=mode)
    want = jshard.run_drift_sharded(_drift_golden("ref"), shards=shards,
                                    mode="inline")
    golden = bench_drift_json["parity"]["shards1"]
    assert got["lat_p95_s"] == 13.19789047038462
    for col in tshard.DRIFT_PARITY_COLS:
        assert _json_round(got[col]) == _json_round(want[col]) == golden[col]
    if shards == 2:
        assert got["windows"] == want["windows"] == \
            bench_drift_json["parity"]["shards2"]["windows"]
