"""The slice as a whole: the paper's streaming k-means loop through the
reference (``repro``) and the port (``repro_torch``) on the same seeded
messages, on the CPU — the processor called in order, and the quickstart
pipeline under the virtual-time executor."""
import numpy as np
import pytest

import repro.core as jcore
import repro.ml as jml
import repro_torch.core as tcore
import repro_torch.ml as tml

N_MESSAGES = 8


def test_processor_matches_reference_message_by_message():
    """10,000 × 32 messages (the paper's largest) through both packages'
    ``make_processor(ParameterService(), "kmeans")`` in order."""
    gen = tml.MiniAppGenerator(n_points=10_000, seed=21)
    msgs = [gen.sample() for _ in range(N_MESSAGES)]
    ps_j, ps_t = jcore.ParameterService(), tcore.ParameterService()
    proc_j = jml.KMeans().make_processor(ps_j, "kmeans")
    proc_t = tml.KMeans(device="cpu").make_processor(ps_t, "kmeans")
    for msg in msgs:
        rj, rt = proc_j(None, data=msg), proc_t(None, data=msg)
        assert rt["n_outliers"] == rj["n_outliers"]
        assert rt["mean_score"] == pytest.approx(rj["mean_score"], rel=1e-5)
        assert ps_t.version("kmeans") == ps_j.version("kmeans")
    assert ps_t.version("kmeans") == N_MESSAGES
    _, tree_j = ps_j.fetch("kmeans")
    _, tree_t = ps_t.fetch("kmeans")
    np.testing.assert_array_equal(tree_t["counts"], tree_j["counts"])
    np.testing.assert_allclose(tree_t["centroids"], tree_j["centroids"],
                               rtol=1e-5, atol=1e-4)


def _quickstart_des(core, ml, **kmeans_kw):
    """The quickstart's pipeline (edge generator → WAN topic → cloud
    k-means processor) on a virtual clock, in package ``core``/``ml``."""
    clock = core.SimClock()
    metrics = core.MetricsRegistry(clock=clock)
    manager = core.PilotManager(devices=(), clock=clock)
    edge = manager.submit_pilot(core.ComputeResource(tier="edge",
                                                     n_workers=3))
    cloud = manager.submit_pilot(core.ComputeResource(tier="cloud",
                                                      n_workers=2))
    gen = ml.MiniAppGenerator(n_points=250, n_clusters=25, seed=7)
    params = core.ParameterService()

    def process_edge(context, data=None):
        return data[np.isfinite(data).all(axis=1)]

    pipe = core.EdgeToCloudPipeline(
        pilot_cloud_processing=cloud, pilot_edge=edge,
        produce_function_handler=gen.make_producer(),
        process_edge_function_handler=process_edge,
        process_cloud_function_handler=ml.KMeans(**kmeans_kw).make_processor(
            params, "kmeans"),
        function_context={"model": "kmeans", "n_clusters": 25},
        wan_shaper=core.WanShaper(bandwidth_bps=8e6, rtt_s=0.1, sleep=False),
        metrics=metrics, clock=clock, heartbeat_timeout_s=1e9)
    svc = lambda stage, ctx, data: 0.02 if stage == "produce" else 0.05
    res = pipe.run(n_messages=24, timeout_s=600.0,
                   scheduler=core.SimExecutor(clock=clock, service_model=svc))
    manager.release_all()
    return res, params


def _fingerprint(res):
    """tests/test_pipeline_des.py:39's fingerprint."""
    lat = res.metrics.latencies("produced", "processed")
    return (res.n_processed, res.n_produced, res.wall_s, tuple(sorted(lat)),
            tuple((e["kind"], e["t"]) for e in res.metrics.events()
                  if e["kind"].startswith(("consumer_", "autoscale"))))


def test_quickstart_pipeline_des_matches_reference():
    res_j, ps_j = _quickstart_des(jcore, jml)
    res_t, ps_t = _quickstart_des(tcore, tml, device="cpu")
    assert _fingerprint(res_t) == _fingerprint(res_j)
    assert res_t.n_processed == 24
    assert [r["n_outliers"] for r in res_t.results] == \
        [r["n_outliers"] for r in res_j.results]
    # the first message seeds the 25 centroids from its own 250 points, so
    # 25 distances sit at d ≈ 0, where the expansion's cancellation floor
    # is 0.05 a point (tests/test_ml.py:75-79): the mean may move by
    # 0.05 · 25 / 250
    np.testing.assert_allclose([r["mean_score"] for r in res_t.results],
                               [r["mean_score"] for r in res_j.results],
                               rtol=1e-5, atol=0.05 * 25 / 250)
    assert ps_t.version("kmeans") == ps_j.version("kmeans") == 24


def test_advise_placement_is_not_ported_yet():
    """The name predates the advisor's port: ``placement="advise"`` no
    longer raises and gives the reference's rows at a small message
    (tests/test_torch_advisor.py holds the advisor itself)."""
    reports = {}
    for name, core in (("ref", jcore), ("port", tcore)):
        manager = core.PilotManager(devices=())
        edge = manager.submit_pilot(core.ComputeResource(tier="edge"))
        cloud = manager.submit_pilot(core.ComputeResource(tier="cloud"))
        reports[name] = core.EdgeToCloudPipeline(
            pilot_cloud_processing=cloud, pilot_edge=edge,
            produce_function_handler=lambda ctx: np.zeros((4, 32)),
            process_cloud_function_handler=lambda ctx, data=None: None,
            function_context={"model": "kmeans", "n_points": 250},
        ).run(placement="advise", n_messages=16)
        manager.release_all()
    assert reports["port"].rows() == reports["ref"].rows()


def test_mesh_pilot_records_its_devices():
    """A cloud pilot over devices gets a mesh record: one SPMD slot, its
    devices on the named axis (placement reads only these two facts)."""
    manager = tcore.PilotManager(devices=("cuda:0", "cuda:1"))
    pilot = manager.submit_pilot(tcore.ComputeResource(
        tier="cloud", n_devices=2, mesh_axes=("data",)))
    assert pilot.mesh is not None and pilot.capacity == 1
    assert pilot.mesh.shape == {"data": 2} and pilot.mesh.size == 2
    assert len(pilot.devices) == 2 and manager.free_devices == 0
    manager.release(pilot)
    assert manager.free_devices == 2 and pilot.mesh is None
