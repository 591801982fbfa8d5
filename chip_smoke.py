#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/kernels/``, holds each kernel against its plain PyTorch version on
the card, times both, runs the paper's quickstart loop (edge generator →
WAN topic → cloud k-means processor → parameter service) through
``repro_torch`` on the card, and checks the outputs against the plain path
on the same messages.  Each phase prints one JSON line; the card's
``nvidia-smi`` name and power limit, then a ``{"kernels": [...]}`` line,
then the ``{"ok": true, ...}`` line come last.  Any failure raises and
exits non-zero before the last line; so does a host without a CUDA card
or a directory without the package beside this script.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12,      # CUDA-core fp32: the kernel's FMAs
              "bf16": 989e12,     # bf16 products with fp32 sums (tensor cores)
              "int8": 67e12}      # per-feature scales: products run in fp32
ELEM_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}
PRECISIONS = ("fp32", "bf16", "int8")
# (n, f, k): the paper's largest message, the kernel's headline shape,
# a ragged tile with tiny widths, and the reference's widest test case
CHECK_SHAPES = [(10_000, 32, 25), (1_000_000, 32, 25), (257, 7, 3),
                (513, 128, 128)]
TIMED_SHAPES = [(10_000, 32, 25), (1_000_000, 32, 25)]
MAIN_SHAPE = (10_000, 32, 25)     # what one quickstart message gives
# near-tie and distance tolerance, per row: 1e-5 of the expansion's
# largest terms (‖x‖² + max‖c‖²), about 170 fp32 ulps of them
D2_RTOL = 1e-5
N_MESSAGES = 64
SEED = 0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def blobs(torch, n, f, k, device, seed):
    """Mini-App-like data made on the card: Gaussian clusters in a ±10 box,
    2% uniform outliers in a ±40 box; the centroids are k of the points,
    as ``KMeans.init(sample)`` seeds them, so k rows sit at d = 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    centers = (torch.rand((k, f), generator=g, device=device) * 2 - 1) * 10
    which = torch.randint(0, k, (n,), generator=g, device=device)
    x = centers[which] + torch.randn((n, f), generator=g, device=device)
    n_out = int(round(0.02 * n))
    if n_out:
        rows = torch.randperm(n, generator=g, device=device)[:n_out]
        x[rows] = (torch.rand((n_out, f), generator=g, device=device)
                   * 2 - 1) * 40
    pick = torch.randperm(n, generator=g, device=device)[:k]
    return x.contiguous(), x[pick].contiguous()


def bound_ms(n, f, k, precision, fused, point_bytes=None):
    """Least time for the function on this card: the larger of its bytes
    (each input read once, each output written once) over HBM bandwidth
    and its 2·N·K·F flops over the peak rate for its type."""
    pb = ELEM_BYTES[precision] if point_bytes is None else point_bytes
    nbytes = n * f * pb + (k * f + k) * 4 + n * 8
    if precision == "int8":
        nbytes += f * 4
    if fused:
        nbytes += (k * f + k) * 4
    flops = 2.0 * n * k * f
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[precision]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernel(torch, kk, n, f, k, precision, device):
    """Both kernels against the plain version at one shape; returns the
    worst dmin error of each form where the ids agree."""
    x, c = blobs(torch, n, f, k, device, SEED + n + f + k)
    prep = kk.prepare(x, c, precision)
    runs = [kk.launch(prep, fused=True) for _ in range(3)]
    ids, dmin, sums, counts = runs[0]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            if not torch.equal(a, b):
                raise AssertionError(f"fused outputs differ between launches "
                                     f"at {(n, f, k)} {precision}")
    a_ids, a_dmin = kk.launch(prep, fused=False)
    p_ids, p_dmin, p_sums, p_counts = kk.plain(prep, fused=True)
    torch.cuda.synchronize()
    if not (torch.equal(a_ids, ids) and torch.equal(a_dmin, dmin)):
        raise AssertionError(f"assign-only and fused kernels disagree at "
                             f"{(n, f, k)} {precision}")

    xv = kk.point_values(prep)
    cv = prep.centroids
    d2p = torch.clamp_min((xv * xv).sum(1, keepdim=True) - 2.0 * (xv @ cv.T)
                          + prep.c2[None, :], 0.0)
    tol = D2_RTOL * ((xv * xv).sum(1) + prep.c2.max())
    ids_l, p_ids_l = ids.long(), p_ids.long()
    gap = (d2p.gather(1, ids_l[:, None]) - d2p.gather(1, p_ids_l[:, None]))
    mism = ids_l != p_ids_l
    if bool((mism & (gap[:, 0].abs() > tol)).any()):
        raise AssertionError(f"ids differ beyond near-ties at {(n, f, k)} "
                             f"{precision}")
    # distances, compared as squared distances (the cancellation near d = 0
    # is absolute in d², not in d)
    if bool(((dmin.double() ** 2 - p_dmin.double() ** 2).abs()
             > tol.double()).any()):
        raise AssertionError(f"dmin out of tolerance at {(n, f, k)} "
                             f"{precision}")
    # counts exact against the kernel's own ids (and the plain counts
    # when no id moved); sums against a float64 sum over the kernel's
    # ids, within the fp32 bound of the kernel's order of addition:
    # (rows per block + blocks) · 2^-24 · Σ|x|
    want_counts = torch.bincount(ids_l, minlength=k).float()
    if not torch.equal(counts, want_counts):
        raise AssertionError(f"counts wrong at {(n, f, k)} {precision}")
    if not bool(mism.any()) and not torch.equal(counts, p_counts):
        raise AssertionError(f"counts differ from plain at {(n, f, k)}")
    x64 = xv.double()
    want = torch.zeros((k, f), dtype=torch.float64, device=device
                       ).index_add_(0, ids_l, x64)
    abs_sums = torch.zeros_like(want).index_add_(0, ids_l, x64.abs())
    nblocks = -(-n // 256)
    sum_tol = (256 + nblocks) * 2.0 ** -24 * abs_sums + 1e-6
    if bool(((sums.double() - want).abs() > sum_tol).any()):
        raise AssertionError(f"sums out of tolerance at {(n, f, k)} "
                             f"{precision}")
    agree = ~mism
    err = float((dmin - p_dmin)[agree].abs().max()) if bool(agree.any()) \
        else 0.0
    return {"shape": [n, f, k], "precision": precision,
            "id_mismatches_at_ties": int(mism.sum()),
            "dmin_max_abs_err": err,
            "sums_max_abs_err": float((sums.double() - want).abs().max())}


def time_ms(torch, fn, iters):
    """Median over 5 repeats of the mean time of ``iters`` calls, CUDA
    events around each repeat, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def time_kernels(torch, kk, ops, device):
    rows = []
    for n, f, k in TIMED_SHAPES:
        x, c = blobs(torch, n, f, k, device, SEED + 1)
        iters = 50 if n <= 100_000 else 10
        for precision in PRECISIONS:
            prep = kk.prepare(x, c, precision)
            for fused, name in ((True, "kmeans_assign_update"),
                                (False, "kmeans_assign")):
                entry = ops.kmeans_assign_update if fused else ops.kmeans_assign
                row = {
                    "kernel": name, "shape": [n, f, k],
                    "precision": precision,
                    "kernel_ms": time_ms(
                        torch, lambda: kk.launch(prep, fused), iters),
                    "wrapper_ms": time_ms(
                        torch, lambda: entry(x, c, precision=precision),
                        iters),
                    "plain_ms": time_ms(
                        torch, lambda: kk.plain(prep, fused), iters),
                    "library_ms": None,
                }
                row["bound_ms"], row["bound_by"] = bound_ms(
                    n, f, k, precision, fused)
                # the wrapper reads fp32 points and prepares them itself
                row["wrapper_bound_ms"], _ = bound_ms(
                    n, f, k, precision, fused, point_bytes=4)
                emit("timing", **row)
                rows.append(row)
    return rows


def run_pipeline(torch, core, ml, kk, device):
    """The quickstart's loop through the port on the card: the training
    processor on 64 messages of 10,000 points under the threaded
    executor, then an inference processor that fetches the published
    centroids.  Each is driven with the launch counts set to 0 just before
    it and read just after."""
    manager = core.PilotManager()
    edge = manager.submit_pilot(core.ComputeResource(
        tier="edge", n_workers=4, memory_gb=4))
    cloud = manager.submit_pilot(core.ComputeResource(
        tier="cloud", n_devices=1, n_workers=4, memory_gb=44))
    if cloud.devices[0] != device:
        raise AssertionError(f"cloud pilot got {cloud.devices}")
    kmeans = ml.KMeans(n_clusters=25, n_features=32,
                       device=cloud.devices[0])
    params = core.ParameterService()
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], n_clusters=25,
                              seed=7)

    def process_edge(context, data=None):
        return data[np.isfinite(data).all(axis=1)]

    def pipeline(handler, n_messages):
        return core.EdgeToCloudPipeline(
            pilot_cloud_processing=cloud, pilot_edge=edge,
            produce_function_handler=gen.make_producer(),
            process_edge_function_handler=process_edge,
            process_cloud_function_handler=handler,
            function_context={"model": "kmeans", "n_clusters": 25},
        ).run(n_messages=n_messages)

    for counter in kk.LAUNCHES.values():
        counter.reset()
    res = pipeline(kmeans.make_processor(params, "kmeans", train=True),
                   N_MESSAGES)
    torch.cuda.synchronize()
    train_launches = {name: c.count for name, c in kk.LAUNCHES.items()}
    if res.n_processed != N_MESSAGES:
        raise AssertionError(f"processed {res.n_processed}/{N_MESSAGES}")
    if train_launches["kmeans_assign_update"] < N_MESSAGES:
        raise AssertionError(f"fused kernel launched "
                             f"{train_launches['kmeans_assign_update']} "
                             f"times for {N_MESSAGES} messages")
    # the processor's state is shared by the cloud stage's worker threads
    # without a lock (as in the reference), so an update may be lost and
    # the counts only bound the points seen
    version, tree = params.fetch("kmeans")
    if version != N_MESSAGES or tree["centroids"].shape != (25, 32) \
            or not np.isfinite(tree["centroids"]).all() \
            or not 0 < tree["counts"].sum() <= N_MESSAGES * MAIN_SHAPE[0]:
        raise AssertionError("published k-means state is wrong")
    for r in res.results:
        if not (np.isfinite(r["mean_score"]) and r["n_outliers"] >= 0):
            raise AssertionError(f"bad result {r}")
    tp = res.throughput()
    emit("pipeline", n_processed=res.n_processed, n_produced=res.n_produced,
         wall_s=res.wall_s, msgs_per_s=tp["msgs_per_s"],
         bytes_per_s=tp["bytes_per_s"], params_version=version,
         launches=train_launches)

    for counter in kk.LAUNCHES.values():
        counter.reset()
    res_inf = pipeline(kmeans.make_processor(params, "kmeans", train=False),
                       8)
    torch.cuda.synchronize()
    infer_launches = {name: c.count for name, c in kk.LAUNCHES.items()}
    if res_inf.n_processed != 8 or infer_launches["kmeans_assign"] < 8:
        raise AssertionError(f"inference run: {res_inf.n_processed} "
                             f"processed, launches {infer_launches}")
    emit("pipeline_inference", n_processed=res_inf.n_processed,
         msgs_per_s=res_inf.throughput()["msgs_per_s"],
         launches=infer_launches)
    manager.release_all()
    return {"kmeans_assign_update": train_launches["kmeans_assign_update"],
            "kmeans_assign": infer_launches["kmeans_assign"]}


def check_against_plain_path(torch, core, ml, device):
    """The same seeded messages through the processor on the card (the
    kernel) and on the host (the plain version), in order: equal outlier
    counts and versions, scores and centroids within tolerance.  The
    first message seeds the 25 centroids from its own points, and those 25
    distances sit at d ≈ 0, where the expansion cancels to an absolute
    floor of 0.05 a point: the mean score may move by 0.05 · 25 / n."""
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], seed=21)
    msgs = [gen.sample() for _ in range(8)]
    ps_card, ps_host = core.ParameterService(), core.ParameterService()
    card = ml.KMeans(device=device).make_processor(ps_card, "kmeans")
    host = ml.KMeans(device="cpu").make_processor(ps_host, "kmeans")
    worst = 0.0
    for msg in msgs:
        a, b = card(None, data=msg), host(None, data=msg)
        if a["n_outliers"] != b["n_outliers"]:
            raise AssertionError(f"n_outliers {a} vs {b}")
        diff = abs(a["mean_score"] - b["mean_score"])
        worst = max(worst, diff)
        if diff > 1e-5 * abs(b["mean_score"]) + 0.05 * 25 / MAIN_SHAPE[0]:
            raise AssertionError(f"mean_score {a} vs {b}")
    _, ta = ps_card.fetch("kmeans")
    _, tb = ps_host.fetch("kmeans")
    if ps_card.version("kmeans") != ps_host.version("kmeans"):
        raise AssertionError("parameter versions differ")
    if not np.array_equal(ta["counts"], tb["counts"]):
        raise AssertionError("counts differ between card and host")
    np.testing.assert_allclose(ta["centroids"], tb["centroids"],
                               rtol=1e-5, atol=1e-4)
    emit("check_vs_host", messages=len(msgs), mean_score_max_abs=worst,
         centroid_max_abs=float(np.abs(ta["centroids"]
                                       - tb["centroids"]).max()))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.core as core
    import repro_torch.ml as ml
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import kmeans as kk

    # the plain version's fp32 matmul must not run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), capability=list(cap),
         count=torch.cuda.device_count(), nvidia_smi=smi)
    if cap != (9, 0):
        raise RuntimeError(f"needs an sm_90 card, got capability {cap}")

    t0 = time.perf_counter()
    seconds = build.build_all()
    ptxas = [line.strip() for log in build.build_logs.values()
             for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit("build", seconds=seconds, wall_s=time.perf_counter() - t0,
         build_dir=str(build.BUILD_DIR), ptxas=ptxas)

    worst = {"kmeans_assign_update": 0.0, "kmeans_assign": 0.0}
    for n, f, k in CHECK_SHAPES:
        for precision in PRECISIONS:
            row = check_kernel(torch, kk, n, f, k, precision, device)
            emit("check", **row)
            for name in worst:
                worst[name] = max(worst[name], row["dmin_max_abs_err"])

    timings = time_kernels(torch, kk, ops, device)
    launches = run_pipeline(torch, core, ml, kk, device)
    check_against_plain_path(torch, core, ml, device)

    kernels = []
    for name, replaces in (
            ("kmeans_assign_update", "src/repro/kernels/kmeans.py:196"),
            ("kmeans_assign", "src/repro/kernels/kmeans.py:196")):
        main_row = next(r for r in timings if r["kernel"] == name
                        and tuple(r["shape"]) == MAIN_SHAPE
                        and r["precision"] == "fp32")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/kmeans.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": main_row["kernel_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
