"""The port's outlier scenario (``repro_torch.examples.edge_to_cloud_outlier``)
run on the CPU at a short length: the advice is the reference's, every
message is processed, the injected fault is retried, the cloud function
is swapped to the auto-encoder and both models publish."""
import importlib

import pytest

import repro.core as jcore
import repro_torch.examples.edge_to_cloud_outlier as example

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
