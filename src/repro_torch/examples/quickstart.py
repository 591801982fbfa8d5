"""Quickstart — the paper's Listings 1 & 2 on the port, as
``examples/quickstart.py`` runs them on the reference package.

Acquire an edge pilot and a cloud pilot (step 1), define the three FaaS
functions, instantiate the EdgeToCloudPipeline (step 2), run 128 messages
of 2,500 × 32 points through k-means with k = 25, and read the linked
metrics (step 3).  The cloud function is ``KMeans.make_processor``: one
fused assign+update pass a message, through the k-means kernel on the
card.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The model computes on ``device``, which defaults to the CUDA card and
raises without one.  :func:`main` prints the reference script's report
and returns it as a dict.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import ComputeResource, EdgeToCloudPipeline, PilotManager
from repro_torch.ml import KMeans, MiniAppGenerator
from repro_torch.ml.kmeans import resolve_device


def main(device=None) -> dict:
    device = resolve_device(device)
    # --- step 1: acquire pilots (resource management, no workload code) ---
    manager = PilotManager(devices=() if device.type == "cpu" else None)
    pilot_edge = manager.submit_pilot(
        ComputeResource(tier="edge", n_workers=4, memory_gb=4))  # RasPi-class
    pilot_cloud = manager.submit_pilot(
        ComputeResource(tier="cloud", n_workers=4, memory_gb=44))  # LRZ VM

    # --- FaaS functions (Listing 1) ---------------------------------------
    generator = MiniAppGenerator(n_points=2_500, n_clusters=25, seed=7)
    produce_edge = generator.make_producer()     # sensing / data generation

    def process_edge(context, data=None):
        """Edge pre-processing: drop non-finite rows before the WAN hop."""
        return data[np.isfinite(data).all(axis=1)]

    kmeans = KMeans(n_clusters=25, n_features=32, device=device)
    process_cloud = kmeans.make_processor(train=True)  # score + update

    # --- step 2: instantiate + run (Listing 2) -----------------------------
    pipeline = EdgeToCloudPipeline(
        pilot_cloud_processing=pilot_cloud,
        pilot_edge=pilot_edge,
        produce_function_handler=produce_edge,
        process_edge_function_handler=process_edge,
        process_cloud_function_handler=process_cloud,
        function_context={"model": "kmeans", "n_clusters": 25},
    )
    n_messages = 128
    result = pipeline.run(n_messages=n_messages)

    # --- step 3: monitoring -------------------------------------------------
    print(f"processed {result.n_processed}/{result.n_produced} messages "
          f"in {result.wall_s:.2f}s")
    tp = result.throughput()
    print(f"throughput: {tp['msgs_per_s']:.0f} msg/s, "
          f"{tp['bytes_per_s']/1e6:.1f} MB/s")
    print(f"end-to-end latency: {result.latency()}")
    print("per-hop latency:")
    for hop, stats in result.per_hop().items():
        print(f"  {hop:25s} mean {stats['mean_s']*1e3:7.2f} ms")
    outliers = sum(r["n_outliers"] for r in result.results)
    print(f"outliers flagged across stream: {outliers}")
    manager.release_all()
    return {"n_messages": n_messages, "n_produced": result.n_produced,
            "n_processed": result.n_processed, "wall_s": result.wall_s,
            "msgs_per_s": tp["msgs_per_s"], "outliers": outliers,
            "results": result.results}


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device for the model (default: the card)")
    main(device=ap.parse_args().device)


if __name__ == "__main__":
    _cli()
