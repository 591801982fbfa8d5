"""The port's examples on the CPU.  The outlier scenario
(``repro_torch.examples.edge_to_cloud_outlier``) at a short length: the
advice is the reference's, every message is processed, the injected fault
is retried, the cloud function is swapped to the auto-encoder and both
models publish.  The quickstart processes what the reference script
processes, the geo example's placement rankings are the reference's, and
the LM example trains (the loss falls) and serves."""
import importlib
import os
import runpy

import pytest

import repro.core as jcore
import repro_torch.examples.edge_to_cloud_outlier as example
import repro_torch.examples.geo_distributed as geo
import repro_torch.examples.quickstart as quickstart
import repro_torch.examples.train_and_serve_lm as lm

N_POINTS, N_MESSAGES = 250, 24


def _reference_advice():
    mgr = jcore.PilotManager(devices=())
    edge = mgr.submit_pilot(jcore.ComputeResource(tier="edge", n_workers=4))
    cloud = mgr.submit_pilot(jcore.ComputeResource(tier="cloud",
                                                   n_workers=2))
    rep = jcore.EdgeToCloudPipeline(
        pilot_cloud_processing=cloud, pilot_edge=edge,
        produce_function_handler=lambda ctx: None,
        process_cloud_function_handler=lambda ctx, data=None: None,
        function_context={"model": "kmeans", "n_points": N_POINTS},
    ).run(placement="advise")
    mgr.release_all()
    return {band: rep.best(band).placement
            for band in ("10mbit", "50mbit", "100mbit")}


def test_outlier_example_runs_on_the_cpu(capsys):
    out = example.main(device="cpu", n_points=N_POINTS,
                       n_messages=N_MESSAGES)
    assert out["advice"] == _reference_advice()
    assert out["n_processed"] == N_MESSAGES
    assert out["fault_fired"]
    assert out["task_errors"] >= 1 and out["retries"] >= 1
    assert out["swaps"] == ["process_cloud"]
    assert out["kmeans_messages"] >= N_MESSAGES // 3
    versions = out["params_versions"]
    assert versions["kmeans"] == out["kmeans_messages"]
    # a rebalance on a resize may hand a message to a second consumer
    assert versions["kmeans"] + versions["autoencoder"] >= N_MESSAGES
    assert all(r["n_outliers"] >= 0 for r in out["results"])
    printed = capsys.readouterr().out
    assert "recommended" in printed and "hot-swapped" in printed


def test_outlier_example_needs_a_card_unless_given_the_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(n_points=N_POINTS, n_messages=N_MESSAGES)


def test_outlier_example_runs_nothing_at_import(capsys):
    importlib.reload(example)
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# the quickstart, geo and LM examples
# ---------------------------------------------------------------------------

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
PORT_EXAMPLES = [quickstart, geo, lm]


def test_quickstart_processes_what_the_reference_processes(capsys):
    """Listings 1 and 2 at the reference script's sizes (128 messages of
    2,500 × 32, k = 25, the same generator seed): every message produced
    is processed, in both packages."""
    runpy.run_path(os.path.join(EXAMPLES, "quickstart.py"))
    ref = capsys.readouterr().out
    out = quickstart.main(device="cpu")
    port = capsys.readouterr().out
    line = next(x for x in ref.splitlines() if x.startswith("processed"))
    assert line.split()[1] == f"{out['n_processed']}/{out['n_produced']}"
    assert out["n_processed"] == out["n_produced"] == 128
    assert len(out["results"]) == 128
    assert all(r["n_outliers"] >= 0 for r in out["results"])
    assert "per-hop latency" in port and "outliers flagged" in port


def _reference_rankings(n_points):
    """examples/geo_distributed.py's placement evaluation, through the
    reference's engine."""
    mgr = jcore.PilotManager(devices=())
    p_edge = mgr.submit_pilot(jcore.ComputeResource(tier="edge",
                                                    n_workers=1))
    p_cloud = mgr.submit_pilot(jcore.ComputeResource(tier="cloud",
                                                     n_workers=8))
    engine = jcore.PlacementEngine()
    from repro.ml import message_nbytes
    msg = message_nbytes(n_points)
    tasks = {"k-means": jcore.TaskProfile(flops=2 * n_points * 25 * 32,
                                          input_bytes=msg, input_tier="edge"),
             "auto-encoder": jcore.TaskProfile(
                 flops=6 * 11_552 * n_points * 50, input_bytes=msg,
                 input_tier="edge")}
    out = {}
    for name, task in tasks.items():
        choice = engine.place(task, [p_edge, p_cloud])
        out[name] = {"table": engine.compare_tiers(task, [p_edge, p_cloud]),
                     "choice": choice.pilot.tier,
                     "t_in": choice.breakdown["t_in"],
                     "t_compute": choice.breakdown["t_compute"]}
    mgr.release_all()
    return out


@pytest.mark.parametrize("n_points", [2_500, 250])
def test_geo_rankings_equal_the_reference(n_points):
    got = geo.rankings(n_points)
    assert got == _reference_rankings(n_points)
    if n_points == 2_500:    # the paper's Fig 3 finding
        assert got["k-means"]["choice"] == "edge"
        assert got["auto-encoder"]["choice"] == "cloud"


def test_geo_example_runs_on_the_cpu(capsys):
    out = geo.main(device="cpu", n_points=250, n_messages=8)
    assert out["local"]["n_processed"] == out["geo"]["n_processed"] == 8
    # the shaped hop carries at least the WAN's one-way latency
    assert out["geo"]["wan_hop_mean_s"] >= 0.075
    assert out["rankings"] == _reference_rankings(250)
    assert "XSEDE -> LRZ" in capsys.readouterr().out


def test_lm_sized_config_is_the_reference_one():
    ref = runpy.run_path(os.path.join(EXAMPLES, "train_and_serve_lm.py"),
                         run_name="reference_example")
    for target in (10, 100):
        want = ref["sized_config"](target)
        got = lm.sized_config(target)
        assert got.name == want.name
        assert got.param_count == want.param_count
        for field in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                      "d_head", "d_ff", "vocab_size", "remat"):
            assert getattr(got, field) == getattr(want, field)


def test_lm_example_trains_and_serves_on_the_cpu(capsys):
    out = lm.main(device="cpu", steps=20, batch=4, seq=64, requests=3,
                  new_tokens=5)
    assert out["config"] == "internlm2-mini"
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert out["version"] == 1
    assert out["served"] == 3 and out["tokens"] == 3 * 5
    assert all(len(t) == 5 for t in out["results"].values())
    assert "published weights v1" in capsys.readouterr().out


@pytest.mark.parametrize("module", PORT_EXAMPLES,
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_examples_need_a_card_unless_given_the_cpu(module, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main()


@pytest.mark.parametrize("module", PORT_EXAMPLES,
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_examples_run_nothing_at_import(module, capsys):
    importlib.reload(module)
    assert capsys.readouterr().out == ""
