"""The advisor stack (``cost.readvisor``, ``sim.scenarios``,
``cost.advisor`` and ``ContinuumPipeline.run(placement="advise")``)
through both packages on the CPU.

Every DES column is virtual-time arithmetic on the same calibration, so
the port's rows must be bit-identical to the reference's: the Fig-3
goldens (tests/test_sim.py, tests/test_cost.py), the band-drop drift
golden (tests/test_drift.py) and the advisor's ranked reports.  The one
column that is not DES arithmetic is ``agreement_vs_fp32`` of a
reduced-precision spec: each package runs its own k-means (jnp in the
reference, the port's plain torch path) on the same probe, and a point at
a near-tie of two centroids may take the other id, so that column is held
within 2e-3 (5 of the probe's 2,500 points)."""
from dataclasses import replace

import numpy as np
import pytest

import repro.core as jcore
import repro.cost.advisor as jadv
import repro.cost.readvisor as jrv
import repro.sim.scenarios as jsc
import repro_torch.core as tcore
import repro_torch.cost.advisor as tadv
import repro_torch.cost.readvisor as trv
import repro_torch.sim.scenarios as tsc

AGREEMENT_ATOL = 2e-3
PKGS = {"ref": (jcore, jsc, jrv, jadv), "port": (tcore, tsc, trv, tadv)}

# (model, placement, band, messages): tests/test_cost.py:184-204 and
# tests/test_sim.py:373-404 (Fig-3 left and right, both bands), plus the
# isolation forest (tests/test_cost.py:207-215) and the hybrid, fog and
# device placements
FIG3_CELLS = [
    ("kmeans", "cloud", "10mbit", 48), ("kmeans", "edge", "10mbit", 48),
    ("kmeans", "cloud", "100mbit", 48),
    ("autoencoder", "cloud", "10mbit", 32),
    ("autoencoder", "cloud", "100mbit", 32),
    ("autoencoder", "edge", "10mbit", 32),
    ("autoencoder", "edge", "100mbit", 32),
    ("isoforest", "edge", "10mbit", 32), ("isoforest", "cloud", "10mbit", 32),
    ("kmeans", "hybrid", "50mbit", 24), ("kmeans", "fog", "10mbit", 24),
    ("kmeans", "device", "10mbit", 24),
]
# tests/test_cost.py:191, :194
GOLDEN_MSGS_PER_S = {("kmeans", "cloud", "10mbit"): 1.9467832433,
                     ("autoencoder", "cloud", "10mbit"): 1.2298516731}


def _golden(sc, rv):
    """tests/test_drift.py:40's band-drop cell in one package."""
    return sc.Scenario(
        placement="cloud", wan_band="100mbit", n_messages=60,
        n_points=25_000, gen_s_per_point=1.28e-4, seed=3,
        speculative_factor=2.0,
        drift=(sc.DriftSpec(at_s=8.0, kind="band", band="10mbit"),),
        readvise=rv.ReAdviseSpec(interval_s=2.0, min_samples=2,
                                 hysteresis=3.0))


@pytest.mark.parametrize("model,placement,band,n", FIG3_CELLS)
def test_fig3_cells_bit_identical(model, placement, band, n):
    rows = {}
    for name, (_, sc, _, _) in PKGS.items():
        r = sc.run_scenario(sc.Scenario(model=sc.MODELS[model],
                                        placement=placement,
                                        wan_band=band, n_messages=n))
        rows[name] = r.row()
        rows[name + "_est"] = sc.placement_estimates(
            sc.Scenario(model=sc.MODELS[model], wan_band=band))
    assert rows["port"] == rows["ref"]
    assert rows["port_est"] == rows["ref_est"]
    golden = GOLDEN_MSGS_PER_S.get((model, placement, band))
    if golden is not None:
        assert rows["port"]["msgs_per_s"] == pytest.approx(golden, rel=1e-6)


@pytest.mark.parametrize("extra", ["failures", "autoscale", "noise"])
def test_dynamism_cells_bit_identical(extra):
    rows = {}
    for name, (core, sc, _, _) in PKGS.items():
        kw = {"failures": {"failures": (sc.FailureSpec(at_s=2.0),)},
              "autoscale": {"autoscale": core.ScalePolicy(
                  max_workers=8, lag_high=4, cooldown_s=0.5),
                  "n_consumers": 1},
              "noise": {"service_sigma": sc.KMEANS.sigma,
                        "speculative_factor": 1.5}}[extra]
        r = sc.run_scenario(sc.Scenario(placement="cloud",
                                        wan_band="50mbit", n_messages=40,
                                        **kw))
        rows[name] = (r.row(), r.autoscale_events)
    assert rows["port"] == rows["ref"]


@pytest.mark.parametrize("readvise", [True, False])
def test_band_drop_golden_bit_identical(readvise):
    rows = {}
    for name, (_, sc, rv, _) in PKGS.items():
        cell = _golden(sc, rv)
        res = sc.run_scenario(cell if readvise
                              else replace(cell, readvise=None))
        rows[name] = res.row()
    assert rows["port"] == rows["ref"]
    if readvise:      # tests/test_drift.py:56-66
        swap = rows["port"]["swaps"]
        assert len(swap) == 1 and (swap[0]["from"], swap[0]["to"]) == (
            "cloud", "fog")
        assert swap[0]["t_decided"] > 8.0
    else:
        assert rows["port"]["swaps"] == []


@pytest.mark.parametrize("model", ["kmeans", "autoencoder", "isoforest"])
def test_advisor_reports_bit_identical(model):
    reps = {name: adv.PlacementAdvisor(n_messages=32).advise(model)
            for name, (_, _, _, adv) in PKGS.items()}
    assert reps["port"].rows() == reps["ref"].rows()
    assert reps["port"].table() == reps["ref"].table()
    for band in ("10mbit", "50mbit", "100mbit"):
        assert reps["port"].best(band).row() == reps["ref"].best(band).row()


def test_advisor_budgets_and_sweeps_bit_identical():
    kw = dict(latency_budget=2.0, wan_budget=5.0, hybrid_reduce=(5, 20),
              metro_bands=None)
    reps = {name: adv.PlacementAdvisor(n_messages=16).advise("kmeans", **kw)
            for name, (_, _, _, adv) in PKGS.items()}
    assert reps["port"].rows() == reps["ref"].rows()
    assert any(not r["feasible"] for r in reps["port"].rows())


@pytest.mark.parametrize("spec", ["kmeans_bf16", "kmeans_int8"])
def test_advisor_precision_cells(spec):
    """tests/test_cost.py:692: every column bit-identical but the
    agreement, which is held within AGREEMENT_ATOL."""
    reps = {name: adv.PlacementAdvisor(n_messages=32).advise(
        spec, bands=("10mbit",), latency_budget=2.0)
        for name, (_, _, _, adv) in PKGS.items()}
    rows_t, rows_j = reps["port"].rows(), reps["ref"].rows()
    agree_t = {r.pop("agreement_vs_fp32") for r in rows_t}
    agree_j = {r.pop("agreement_vs_fp32") for r in rows_j}
    assert rows_t == rows_j
    assert len(agree_t) == len(agree_j) == 1
    (a_t,), (a_j,) = agree_t, agree_j
    assert a_t == pytest.approx(a_j, abs=AGREEMENT_ATOL)
    assert 0.99 <= a_t < 1.0 or spec == "kmeans_bf16"
    dev = next(c for c in reps["port"].cells if c.placement == "device")
    if spec == "kmeans_int8":
        assert dev.feasible and dev.latency_p95_s <= 2.0


def _advise_pipeline(core):
    mgr = core.PilotManager(devices=())
    edge = mgr.submit_pilot(core.ComputeResource(tier="edge", n_workers=4))
    cloud = mgr.submit_pilot(core.ComputeResource(tier="cloud",
                                                  n_workers=4))
    pipe = core.EdgeToCloudPipeline(
        pilot_cloud_processing=cloud, pilot_edge=edge,
        produce_function_handler=lambda ctx: None,
        process_cloud_function_handler=lambda ctx, data=None: None,
        function_context={"model": "kmeans", "n_points": 2_500})
    return mgr, edge, cloud, pipe


def test_pipeline_run_placement_advise_matches_reference():
    """tests/test_cost.py:266 through both packages."""
    reps = {}
    for name, (core, _, _, adv) in PKGS.items():
        mgr, edge, cloud, pipe = _advise_pipeline(core)
        reps[name] = pipe.run(n_messages=32, placement="advise",
                              latency_budget=3.0)
        assert isinstance(reps[name], adv.AdvisorReport)
        mgr.release_all()
    assert reps["port"].rows() == reps["ref"].rows()
    assert reps["port"].best("10mbit").placement in ("edge", "hybrid")
    assert [r["wan"] for r in reps["port"].rows()[::5]] == \
        ["10mbit", "50mbit", "100mbit"]


def test_pipeline_advise_argument_checks():
    mgr, edge, cloud, pipe = _advise_pipeline(tcore)
    with pytest.raises(ValueError, match="scheduler"):
        pipe.run(placement="advise", scheduler=object())
    with pytest.raises(ValueError):
        pipe.run(n_messages=4, placement="bogus")
    with pytest.raises(ValueError, match="advisory knobs"):
        pipe.run(n_messages=4, latency_budget=1.0)
    no_points = tcore.EdgeToCloudPipeline(
        pilot_cloud_processing=cloud, pilot_edge=edge,
        produce_function_handler=lambda ctx: None,
        process_cloud_function_handler=lambda ctx, data=None: None,
        function_context={"model": "kmeans"})
    with pytest.raises(ValueError, match="n_points"):
        no_points.run(placement="advise")
    mgr.release_all()


def test_readvisor_decisions_match_reference():
    """The ReAdvisor alone: the same observed counters through both
    packages' decision rule give the same decisions."""
    rows = {}
    for name, (_, sc, rv, _) in PKGS.items():
        res = sc.run_scenario(_golden(sc, rv))
        rows[name] = [(e["t"], e.get("stage"), e.get("to"))
                      for e in res.metrics.events("readvise_decision")]
    assert rows["port"] == rows["ref"] and rows["port"]


def test_lazy_exports():
    import repro_torch.cost as tcost
    import repro_torch.sim as tsim
    assert tcost.PlacementAdvisor is tadv.PlacementAdvisor
    assert tsim.run_scenario is tsc.run_scenario
    assert tsim.SimExecutor is tcore.SimExecutor
    with pytest.raises(AttributeError):
        tcost.NoSuchThing
