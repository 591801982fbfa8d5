"""Full Pilot-Edge scenario on the port: outlier detectors, model hot-swap,
autoscaling and failure recovery — the paper's §II-D dynamism story, as
``examples/edge_to_cloud_outlier.py`` runs it on the reference package.

0. ask the DES-backed PlacementAdvisor where this workload should run
   (``pipeline.run(placement='advise')`` emulates the real pipeline
   across placements × WAN bands in virtual time),
1. stream k-means over the pipeline as a *paced* live demo:
   ``ThreadedExecutor(service_model=...)`` charges every stage its
   calibrated continuum service time (scaled by ``PACE``) on real threads,
   while the cloud stage runs the k-means kernel on ``device``,
2. hot-swap the cloud function to the auto-encoder once a third of the
   stream is processed — ``replace_function`` re-binds the payload without
   re-allocating pilots (the pacing follows: the calibrated AE is ~20,000×
   costlier per point),
3. watch the AutoScaler grow the cloud pilot when the heavier model falls
   behind (broker lag),
4. fail the first processing attempt once and observe retry-based
   recovery.

    PYTHONPATH=src python -m repro_torch.examples.edge_to_cloud_outlier \\
        [--device cpu]

The models compute on ``device``, which defaults to the CUDA card and
raises without one.  :func:`main` prints the reference script's report
and returns it as a dict.
"""
from __future__ import annotations

import argparse
import threading
import time

from repro_torch.core import (AutoScaler, ComputeResource,
                              EdgeToCloudPipeline, ParameterService,
                              PilotManager, ScalePolicy, ThreadedExecutor)
from repro_torch.cost import default_cost_model
from repro_torch.cost.calibrate import DEFAULT_GEN_S_PER_POINT
from repro_torch.ml import AutoEncoder, KMeans, MiniAppGenerator
from repro_torch.ml.kmeans import resolve_device

PACE = 0.02          # play the paper-testbed timeline 50x faster


def main(device=None, n_points: int = 1_000, n_messages: int = 96) -> dict:
    device = resolve_device(device)
    manager = PilotManager(devices=() if device.type == "cpu" else None)
    pilot_edge = manager.submit_pilot(ComputeResource(tier="edge",
                                                      n_workers=4))
    pilot_cloud = manager.submit_pilot(ComputeResource(tier="cloud",
                                                       n_workers=2))
    generator = MiniAppGenerator(n_points=n_points, n_clusters=25, seed=3)
    params_service = ParameterService()

    kmeans = KMeans(n_clusters=25, device=device)
    ae = AutoEncoder(device=device)
    km_processor = kmeans.make_processor(params_service, "kmeans")
    ae_processor = ae.make_processor(params_service, "autoencoder")
    current = {"model": "kmeans"}
    lock = threading.Lock()
    # one transient fault: the first processing attempt dies once
    state = {"armed": True, "kmeans_done": 0}
    swap_after = max(1, n_messages // 3)

    def flaky_process(context, data=None):
        with lock:
            if state["armed"] and context.attempt == 0:
                state["armed"] = False
                raise RuntimeError("injected consumer fault")
        out = km_processor(context, data=data)
        with lock:
            state["kmeans_done"] += 1
            swap = state["kmeans_done"] == swap_after
        if swap:
            current["model"] = "autoencoder"   # re-pace *before* the swap
            pipeline.replace_function("process_cloud", ae_processor)
            print(">> hot-swapped process_cloud: kmeans -> autoencoder "
                  "(no pilot re-allocation)")
        return out

    pipeline = EdgeToCloudPipeline(
        pilot_cloud_processing=pilot_cloud,
        pilot_edge=pilot_edge,
        produce_function_handler=generator.make_producer(),
        process_cloud_function_handler=flaky_process,
        parameter_service=params_service,
        function_context={"model": "kmeans", "n_points": n_points},
        max_retries=2,
    )

    # --- step 0: placement advisory (DES on the real pipeline) -----------
    t0 = time.perf_counter()
    report = pipeline.run(placement="advise")
    advise_wall_s = time.perf_counter() - t0
    print(report.table())
    best = report.best("10mbit")
    print(f">> advisor: run {report.model} on the *{best.placement}* tier "
          f"at 10 Mbit/s ({best.throughput_msgs_s:.1f} msg/s predicted)\n")

    # --- paced live run: calibrated service times on real threads --------
    cost = default_cost_model()

    def paced_service(stage, ctx, payload):
        """Charge each stage its calibrated continuum cost × PACE (the
        same per-point generation cost the advisor's prediction is priced
        with)."""
        if stage == "produce":
            return PACE * DEFAULT_GEN_S_PER_POINT * n_points
        if stage == "process_cloud":
            return PACE * cost.model_compute_s(current["model"], n_points,
                                               "cloud")
        return 0.0

    # autoscaler: watch broker lag on the pipeline's topic
    scaler = AutoScaler(
        manager, pilot_cloud,
        lag_fn=lambda: (pipeline._topic.end_offsets()
                        and sum(pipeline._topic.end_offsets()) or 0)
        - int(pipeline.metrics.counter("runtime.completed")),
        policy=ScalePolicy(max_workers=8, lag_high=16, cooldown_s=0.2),
        metrics=pipeline.metrics,
    )
    scaler.start()
    try:
        result = pipeline.run(n_messages=n_messages, timeout_s=120,
                              scheduler=ThreadedExecutor(
                                  service_model=paced_service))
    finally:
        scaler.stop()

    msgs_per_s = result.throughput()["msgs_per_s"]
    errors = result.metrics.counter("runtime.task_errors")
    retries = result.metrics.counter("runtime.retries")
    print(f"\nprocessed {result.n_processed} messages in "
          f"{result.wall_s:.2f}s ({msgs_per_s:.0f} msg/s)")
    print(f"task errors: {errors:.0f}, retries: {retries:.0f} "
          f"(the injected fault was retried transparently)")
    autoscale = result.metrics.events("autoscale")
    for ev in autoscale:
        print(f"autoscale event: {ev['from_workers']} -> "
              f"{ev['to_workers']} workers at lag={ev['lag']}")
    replaced = result.metrics.events("function_replaced")
    for ev in replaced:
        print(f"function replaced: stage={ev['stage']} fn={ev['fn']}")
    versions = {n: params_service.version(n)
                for n in params_service.names()}
    print(f"parameter-service versions: {versions}")
    manager.release_all()
    return {"advice": {band: report.best(band).placement
                       for band in dict.fromkeys(c.wan_band
                                                 for c in report.cells)},
            "advise_wall_s": advise_wall_s,
            "n_messages": n_messages, "n_processed": result.n_processed,
            "wall_s": result.wall_s, "msgs_per_s": msgs_per_s,
            "task_errors": errors, "retries": retries,
            "fault_fired": not state["armed"],
            "kmeans_messages": state["kmeans_done"],
            "swaps": [ev["fn"] for ev in replaced],
            "autoscale": [(ev["from_workers"], ev["to_workers"])
                          for ev in autoscale],
            "params_versions": versions,
            "results": result.results}


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device for the models (default: the card)")
    main(device=ap.parse_args().device)


if __name__ == "__main__":
    _cli()
