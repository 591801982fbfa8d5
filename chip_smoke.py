#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/kernels/``, holds each kernel against its plain PyTorch version on
the card, times both, and drives the port's two main paths on the card,
each with the launch counts set to 0 just before it and read just after:

* the paper's quickstart loop (edge generator → WAN topic → cloud k-means
  processor → parameter service), checked against the plain path on the
  same messages;
* serving hymba-1.5b at full width (random fp32 weights from a seed, bf16
  cache) through ``BatchServer``: two waves of 4 requests, 1,024- and
  4,096-token prompts, 32 new tokens each, through the flash-attention and
  SSD kernels; then the same waves through the same server with
  ``impl="dense"`` (no kernel), which must agree.

Then the paper's other two workloads and its full scenario, on the card:
``placement="advise"`` for k-means and the auto-encoder; the auto-encoder
and the isolation forest (100 trees, refit per message) in the quickstart's
closed loop, each held against the same processor on the host; and
``repro_torch.examples.edge_to_cloud_outlier`` (advise, paced k-means
through the kernel with an injected fault, hot-swap to the auto-encoder,
autoscaling).  These paths launch no kernel of their own beyond k-means.

Last, training: internlm2-1.8b at full width and depth (24 layers, 1.89 B
fp32 parameters, AdamW, remat, dense attention) for 8 steps of 4 × 1,024
tokens through ``launch.train.train_loop``, with its step time, data time,
peak memory, launches and device time a step against its fp32 bound; the
same step on the card and on the host (2 layers); a checkpointed resume of
mamba2-130m against a straight run; and the int8-compressed step on a
one-rank NCCL group.  Training launches no hand-written kernel: the
reference trains with ``impl="dense"`` and its Pallas kernels have no
gradient.

Each phase prints one JSON line; the card's ``nvidia-smi`` name and power
limit, then a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
line come last.  Any failure raises and
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
# the quickstart's, geo example's and calibrator's message, a ragged tile
# with tiny widths, the reference's widest test case, F and K across the
# kernel's 32-padding, and a million rows of 7 features (no row on a
# 16-byte boundary but every eighth)
CHECK_SHAPES = [(10_000, 32, 25), (1_000_000, 32, 25), (2_500, 32, 25),
                (257, 7, 3), (513, 128, 128), (10_000, 33, 33),
                (1_000_000, 7, 3)]
# and x[1:] of these: a start address off the 16-byte grid
CHECK_MISALIGNED = [(1_001, 7, 3)]
TIMED_SHAPES = [(10_000, 32, 25), (1_000_000, 32, 25)]
MAIN_SHAPE = (10_000, 32, 25)     # what one quickstart message gives
# near-tie and distance tolerance, per row: 1e-5 of the expansion's
# largest terms (‖x‖² + max‖c‖²), about 170 fp32 ulps of them
D2_RTOL = 1e-5
N_MESSAGES = 64
SEED = 0
# the auto-encoder's and the isolation forest's closed loops
AE_MESSAGES = 64
IFOREST_MESSAGES = 16
LOOP_TIMEOUT_S = 120.0    # a cloud loop that fails its tasks ends here

# flash attention: (b, sq, sk, h, hkv, d, causal, window).  The reference's
# cases (tests/test_kernels.py:25-34), hymba-1.5b's two prefill waves,
# internlm2-1.8b's heads at 4,096 tokens, a head_dim of 192, the LM
# example's prefill (internlm2-100m: 12 heads on 4 KV heads, 32 tokens,
# batch 4); then the edges
# of the two designs' tiles: Sq != Sk without the causal mask (k padding),
# fully masked rows (window 1, Sq 8 > Sk 4: rows 4 and up give 0), a
# sequence that no tile size divides, and a head_dim of 256.
FLASH_CASES = [
    (1, 100, 300, 2, 1, 64, False, None),
    (2, 300, 77, 4, 2, 128, False, None),
    (1, 8, 4, 2, 2, 16, False, 1),
    (1, 333, 333, 4, 2, 64, True, None),
    (1, 256, 256, 2, 1, 256, True, None),
    (1, 128, 128, 2, 2, 64, True, None),
    (2, 256, 256, 4, 2, 64, True, None),
    (1, 384, 384, 8, 1, 32, True, None),
    (1, 128, 128, 4, 4, 128, False, None),
    (2, 200, 200, 2, 2, 64, True, 64),
    (1, 512, 512, 2, 1, 64, True, 128),
    (1, 96, 96, 2, 2, 16, True, None),
    (4, 1024, 1024, 25, 5, 64, True, 2048),
    (4, 4096, 4096, 25, 5, 64, True, 2048),
    (1, 4096, 4096, 16, 8, 128, True, None),
    (1, 1024, 1024, 16, 2, 192, True, None),
    (4, 32, 32, 12, 4, 64, True, None),
]
FLASH_MAIN = [(4, 1024, 1024, 25, 5, 64, True, 2048),
              (4, 4096, 4096, 25, 5, 64, True, 2048)]
# SSD: (b, s, nh, hd, g, ds, chunk).  The reference's cases
# (tests/test_kernels.py:99-106), hymba-1.5b's widest wave, mamba2-130m's
# widths, and a ragged chunk of 200; then the edges of the kernel's tiles:
# ds 4 and 256, hd 30 (rows staged element by element) and 256, 4 B/C
# groups of 8 heads, and hymba's widths at 1,024 tokens.
SSD_CASES = [
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 32, 1, 16, 32),
    (1, 256, 8, 64, 2, 32, 64),
    (1, 256, 24, 64, 1, 128, 64),
    (2, 128, 4, 32, 4, 16, 128),
    (4, 4096, 50, 64, 1, 16, 256),
    (2, 4096, 24, 64, 1, 128, 256),
    (2, 400, 4, 64, 1, 16, 200),
    (1, 256, 4, 32, 1, 4, 128),
    (1, 512, 2, 64, 1, 256, 256),
    (1, 256, 2, 256, 1, 256, 256),
    (1, 400, 4, 30, 2, 4, 200),
    (1, 256, 8, 32, 4, 16, 64),
    (2, 1024, 50, 64, 1, 16, 256),
]
SSD_MAIN = [(4, 1024, 50, 64, 1, 16, 256), (4, 4096, 50, 64, 1, 16, 256)]
# tests/test_kernels.py:16-18 (fp32, bf16) and :123 (the SSD scan)
TOL = {"fp32": 2e-5, "bf16": 5e-2}
SSD_TOL = 1e-3
# the kernel's exp is ex2.approx: its fp32 y against plain is reported as
# max |got - want| / (1 + |want|) beside this figure
SSD_EXP_TOL = 2e-5
# serving: hymba-1.5b, 4 slots, two waves of 4 requests
SERVE_ARCH = "hymba-1.5b"
SERVE_WAVES = (1024, 4096)
SERVE_SLOTS = 4
SERVE_NEW_TOKENS = 32
SERVE_MAX_LEN = 4128
# model level: tests/test_serve.py's 2e-3; greedy tokens may differ only at
# a near-tie of the plain run's top two logits
MODEL_TOL = 2e-3
NEAR_TIE = 1e-4
# training: internlm2-1.8b at full width and depth, fp32, 8 steps
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_BATCH = 4
TRAIN_SEQ = 1024
TRAIN_STEPS = 8
# the sharded DES: BENCH_des_scale.json's diurnal row
DES_CELL = dict(arrival="diurnal", messages=100_000, devices=100,
                consumers=1_000, rate_hz=20_000.0, payload_bytes=64,
                service_s=0.001, seed=0)
DES_DET_COLS = ("processed", "duplicates", "truncated_msgs", "makespan_s",
                "lat_p50_s", "lat_p95_s", "wan_bytes")
# the quickstart's messages held card against host
QUICKSTART_CHECKED = 8
# the LM example: --params 100 (12 layers × 768), the reference's 60 steps
LM_STEPS = 60


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


def check_kernel(torch, kk, n, f, k, precision, device, offset=0,
                 block_n=128):
    """Both kernels, with ``block_n``-row tiles, against the plain version at
    one shape (on ``x[offset:]`` of the points); returns the worst dmin
    error of each form where the ids agree."""
    x, c = blobs(torch, n, f, k, device, SEED + n + f + k)
    x = x[offset:]
    n = x.shape[0]
    prep = kk.prepare(x, c, precision)
    runs = [kk.launch(prep, True, block_n) for _ in range(3)]
    ids, dmin, sums, counts = runs[0]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            if not torch.equal(a, b):
                raise AssertionError(f"fused outputs differ between launches "
                                     f"at {(n, f, k)} {precision}")
    a_ids, a_dmin = kk.launch(prep, False, block_n)
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
    # ids, within the fp32 bound of the kernel's longest chain of
    # additions: chain · 2^-24 · Σ|x|, where a block's accumulator takes at
    # most ceil(tiles / grid) tiles of `rows` rows, then the block adds its
    # warps' copies and the second launch the grid's partials
    want_counts = torch.bincount(ids_l, minlength=k).float()
    if not torch.equal(counts, want_counts):
        raise AssertionError(f"counts wrong at {(n, f, k)} {precision}")
    if not bool(mism.any()) and not torch.equal(counts, p_counts):
        raise AssertionError(f"counts differ from plain at {(n, f, k)}")
    x64 = xv.double()
    want = torch.zeros((k, f), dtype=torch.float64, device=device
                       ).index_add_(0, ids_l, x64)
    abs_sums = torch.zeros_like(want).index_add_(0, ids_l, x64.abs())
    grid, rows, warps = kk.geometry(prep, True, block_n)
    chain = -(-n // (rows * grid)) * rows + warps + grid
    sum_tol = chain * 2.0 ** -24 * abs_sums + 1e-6
    if bool(((sums.double() - want).abs() > sum_tol).any()):
        raise AssertionError(f"sums out of tolerance at {(n, f, k)} "
                             f"{precision}")
    agree = ~mism
    err = float((dmin - p_dmin)[agree].abs().max()) if bool(agree.any()) \
        else 0.0
    return {"shape": [n, f, k], "offset": offset, "precision": precision,
            "block_n": block_n, "grid": grid, "sum_chain": chain,
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


def device_ms(torch, fn, iters, names):
    """The kernels' own device time per call: the CUDA kernel durations that
    ``torch.profiler`` records over ``iters`` calls, for the kernels whose
    names hold one of ``names``; None where the profiler records none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.device_time_total for ev in prof.key_averages()
                   if any(name in ev.key for name in names))
    return total_us / iters / 1e3 if total_us else None


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
                    "device_ms": device_ms(
                        torch, lambda: kk.launch(prep, fused), iters,
                        ("assign_kernel", "reduce_partials")),
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


def _tdtype(torch, name):
    return {"fp32": torch.float32, "bf16": torch.bfloat16}[name]


def flash_inputs(torch, case, dtype, device, seed):
    b, sq, sk, h, hkv, d = case[:6]
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=device  # noqa
                                    ).to(_tdtype(torch, dtype))
    return mk(b, sq, h, d), mk(b, sk, hkv, d), mk(b, sk, hkv, d)


def flash_tol(want, dtype):
    """Kernel against plain: both compute in fp32 from the same inputs and
    round once to the output type.  fp32 takes the reference's 2e-5; bf16
    one rounding, 2^-7 of the value, plus 1e-3 of the largest value for
    the fp32 sums' order near a rounding boundary."""
    w = want.float().abs()
    if dtype == "fp32":
        return TOL["fp32"] * (1 + w)
    return 2.0 ** -7 * w + 1e-3 * w.max()


def check_flash(torch, fa, tref, device):
    """The flash kernel against its plain version on every case in fp32 and
    bf16 (:func:`flash_tol`), and against the O(S²) oracle where it fits,
    at the reference's tolerance; raises on a miss.  Returns the largest
    fp32 error."""
    worst = 0.0
    for case in FLASH_CASES:
        causal, window = case[6], case[7]
        for dtype in ("fp32", "bf16"):
            q, k, v = flash_inputs(torch, case, dtype, device, sum(case[:6]))
            out = fa.launch(q, k, v, causal=causal, window=window)
            want = fa.plain(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            tol = flash_tol(want, dtype)
            if out.shape != q.shape or out.dtype != q.dtype or bool(
                    ((out.float() - want.float()).abs() > tol).any()):
                raise AssertionError(f"flash kernel vs plain at {case} "
                                     f"{dtype}: max error {err}")
            row = {"case": list(case), "dtype": dtype, "max_abs_err": err}
            if case[1] <= 512:
                oracle = tref.flash_attention_ref(q, k, v, causal=causal,
                                                  window=window)
                row["oracle_max_abs_err"] = float(
                    (out.float() - oracle.float()).abs().max())
                if bool(((out.float() - oracle.float()).abs()
                         > TOL[dtype] * (1 + oracle.float().abs())).any()):
                    raise AssertionError(f"flash kernel vs oracle at {case} "
                                         f"{dtype}")
            if dtype == "fp32":
                worst = max(worst, err)
            emit("check_flash", **row)
    return worst


def ssd_inputs(torch, case, dtype, device, seed):
    b, s, nh, hd, gr, ds, _ = case
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=device)  # noqa
    td = _tdtype(torch, dtype)
    return (mk(b, s, nh, hd).to(td),
            torch.rand((b, s, nh), generator=g, device=device) * 0.099 + 1e-3,
            -(torch.rand((nh,), generator=g, device=device) * 1.5 + 0.5),
            mk(b, s, gr, ds).to(td), mk(b, s, gr, ds).to(td), mk(nh))


def check_ssd(torch, ssd, tref, device):
    """The SSD chunk kernel (and the full scan through it) against the
    plain version on every case in fp32 (within 1e-3) and bf16 (within
    5e-2), and against the exact sequential oracle at the small fp32 cases.
    Each fp32 row also reports y's error relative to 1 + |y| beside
    ``SSD_EXP_TOL``.  Returns the largest fp32 error."""
    worst = 0.0
    runs = [(case, dtype) for dtype in ("fp32", "bf16") for case in SSD_CASES]
    for case, dtype in runs:
        chunk = case[-1]
        args = ssd_inputs(torch, case, dtype, device, sum(case))
        parts = ssd.chunk_launch(*args, chunk)
        y, fin = ssd.inter_chunk(*parts, args[4], chunk)
        want_parts = ssd.chunk_plain(*args, chunk)
        want_y, want_fin = ssd.inter_chunk(*want_parts, args[4], chunk)
        torch.cuda.synchronize()
        tol = SSD_TOL if dtype == "fp32" else TOL["bf16"]
        errs = {}
        for name, got, want in (("y_intra", parts[0], want_parts[0]),
                                ("st", parts[1], want_parts[1]),
                                ("cum", parts[2], want_parts[2]),
                                ("y", y, want_y), ("final", fin, want_fin)):
            diff = (got.float() - want.float()).abs()
            errs[name] = float(diff.max())
            if bool((diff > tol * (1 + want.float().abs())).any()):
                raise AssertionError(f"SSD kernel vs plain at {case} "
                                     f"{dtype}: {name} error {errs[name]}")
        row = {"case": list(case), "dtype": dtype, "max_abs_err": errs}
        if dtype == "fp32":
            want = want_parts[0]
            row["y_intra_rel_err"] = float(
                ((parts[0] - want).abs() / (1 + want.abs())).max())
            row["y_intra_rel_tol"] = SSD_EXP_TOL
        if case[1] <= 512 and dtype == "fp32":
            y_o, fin_o = tref.ssd_ref(*args)
            row["oracle_max_abs_err"] = [
                float((y - y_o).abs().max()), float((fin - fin_o).abs().max())]
            if bool(((y - y_o).abs() > SSD_TOL * (1 + y_o.abs())).any()) or \
                    bool(((fin - fin_o).abs()
                          > SSD_TOL * (1 + fin_o.abs())).any()):
                raise AssertionError(f"SSD scan vs oracle at {case}")
        if dtype == "fp32":
            worst = max(worst, max(errs.values()))
        emit("check_ssd", **row)
        del args, parts, want_parts, y, fin, want_y, want_fin
    return worst


def flash_bound_ms(case, dtype):
    """Bytes: q, k, v read once and o written once.  Operations: 4·D flops
    (q·k and p·v) for each (query, key) pair the masks leave open."""
    b, sq, sk, h, hkv, d, causal, window = case
    e = ELEM_BYTES[dtype]
    nbytes = e * d * (2 * b * sq * h + 2 * b * sk * hkv)
    qpos = np.arange(sq)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, int)
    pairs = int(np.maximum(hi - lo, 0).sum())
    flops = 4.0 * b * h * d * pairs
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def ssd_bound_ms(case, dtype, gram_per_head=False):
    """Operations, over the q(q+1)/2 causal (i, j) pairs of each chunk (as
    ``flash_bound_ms`` counts only unmasked pairs): 2·ds flops a pair for
    C·Bᵀ, once for each (batch, B/C group, chunk), since the group's heads
    share it; 2·hd a pair for its product with x and 2q·ds·hd for the
    chunk state, for each (batch, head, chunk).  ``gram_per_head`` counts
    C·Bᵀ once a head, the figure of earlier runs.  Bytes: x, dt, B and C
    read once; y, the chunk states and cum written once."""
    b, s, nh, hd, g, ds, q = case
    nc = s // q
    e = ELEM_BYTES[dtype]
    nbytes = (e * (2 * b * s * nh * hd + 2 * b * s * g * ds) + 4 * b * s * nh
              + 4 * b * nh * nc * (ds * hd + q) + 8 * nh)
    pairs = q * (q + 1) / 2
    gram = b * (nh if gram_per_head else g) * nc * 2.0 * ds * pairs
    flops = gram + b * nh * nc * (2.0 * hd * pairs + 2.0 * q * ds * hd)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def sdpa_forms(torch, q, k, v, causal, window):
    """The library yardstick (the port never calls it): each
    ``scaled_dot_product_attention`` form that computes the same function,
    inputs laid out for it outside the call.  The window as a boolean mask
    always; where the window covers every prompt position (or there is
    none), also the mask-free ``is_causal=True`` form, which the flash
    backend takes."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        keep = keep & (kpos <= qpos)
    if window is not None:
        keep = keep & (kpos > qpos - window)
    forms = {"mask": lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep, enable_gqa=True)}
    if causal and sq == sk and (window is None or window >= sq):
        forms["is_causal"] = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    return forms


def time_library(torch, q, k, v, causal, window, iters):
    """Every (backend, form) of the library call that accepts the inputs,
    timed as :func:`time_ms` times the kernel, with the backend chosen
    outside the timed loop.  Returns the fastest as (ms, "BACKEND:form",
    its output in the reference's layout) and every time by name."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    times, best = {}, None
    for form, fn in sdpa_forms(torch, q, k, v, causal, window).items():
        for backend in (SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            name = backend.name
            with sdpa_kernel(backend):
                try:
                    out = fn()
                    torch.cuda.synchronize()
                except RuntimeError:        # the backend refuses the inputs
                    continue
                ms = time_ms(torch, fn, iters)
            times[f"{name}:{form}"] = ms
            if best is None or ms < best[0]:
                best = (ms, f"{name}:{form}", out.transpose(1, 2))
            del out
    if best is None:
        raise AssertionError("no SDPA backend accepted the inputs")
    return best, times


def time_attention_ssd(torch, fa, ssd, device):
    """Kernel, plain and library times at the serving path's shapes, fp32
    and bf16: CUDA events, median of 5 repeats."""
    rows = []
    for case in FLASH_MAIN:
        causal, window = case[6], case[7]
        for dtype in ("fp32", "bf16"):
            q, k, v = flash_inputs(torch, case, dtype, device, 11)
            ker_out = fa.launch(q, k, v, causal=causal, window=window)
            (lib_ms, lib_name, lib_out), lib_times = time_library(
                torch, q, k, v, causal, window, 5)
            row = {"kernel": "flash_attention", "case": list(case),
                   "dtype": dtype,
                   "kernel_ms": time_ms(torch, lambda: fa.launch(
                       q, k, v, causal=causal, window=window), 5),
                   "plain_ms": time_ms(torch, lambda: fa.plain(
                       q, k, v, causal=causal, window=window), 1),
                   "library_ms": lib_ms, "library_backend": lib_name,
                   "library_ms_by_backend": lib_times,
                   "library_max_abs_diff": float(
                       (lib_out.float() - ker_out.float()).abs().max())}
            row["bound_ms"], row["bound_by"] = flash_bound_ms(case, dtype)
            emit("timing", **row)
            rows.append(row)
            del q, k, v, lib_out, ker_out
    for case in SSD_MAIN:
        chunk = case[-1]
        for dtype in ("fp32", "bf16"):
            args = ssd_inputs(torch, case, dtype, device, 13)
            row = {"kernel": "ssd_chunk_scan", "case": list(case),
                   "dtype": dtype,
                   "kernel_ms": time_ms(torch, lambda: ssd.chunk_launch(
                       *args, chunk), 5),
                   "plain_ms": time_ms(torch, lambda: ssd.chunk_plain(
                       *args, chunk), 1),
                   "scan_ms": time_ms(torch, lambda: ssd.ssd_chunk_scan(
                       *args, chunk=chunk), 5),
                   "library_ms": None}
            row["bound_ms"], row["bound_by"] = ssd_bound_ms(case, dtype)
            row["bound_ms_gram_per_head"], _ = ssd_bound_ms(
                case, dtype, gram_per_head=True)
            emit("timing", **row)
            rows.append(row)
    return rows


def _top2_gap(torch, logits, vocab):
    top = torch.topk(logits[..., :vocab].float(), 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu()


def run_server(torch, serve, params, cfg, device, impl, prompts):
    """Both waves through a fresh ``BatchServer``, capturing each wave's
    last-position prefill logits, its prefill cache and the top-two logit
    gap of every greedy token."""
    server = serve.BatchServer(params, cfg, n_slots=SERVE_SLOTS,
                               max_len=SERVE_MAX_LEN, impl=impl,
                               device=device)
    captured = []
    prefill, decode = server._prefill1, server._decode

    def capture_prefill(p, inputs):
        logits, cache = prefill(p, inputs)
        captured.append({"logits": logits[:, -1].float().clone(),
                         "cache": {k: v.clone() for k, v in cache.items()},
                         "gaps": [_top2_gap(torch, logits[:, -1],
                                            cfg.vocab_size)]})
        return logits, cache

    def capture_decode(p, cache, inputs):
        logits, cache = decode(p, cache, inputs)
        captured[-1]["gaps"].append(_top2_gap(torch, logits[:, 0],
                                              cfg.vocab_size))
        return logits, cache

    server._prefill1, server._decode = capture_prefill, capture_decode
    for i, pr in enumerate(prompts):
        server.submit(serve.Request(request_id=f"req-{i}", prompt=pr,
                                    max_new_tokens=SERVE_NEW_TOKENS))
    t0 = time.monotonic()
    done = server.run(max_requests=len(prompts), idle_timeout_s=1.0)
    torch.cuda.synchronize()
    return server, done, captured, time.monotonic() - t0


def serve_hymba(torch, serve, T, fa, ssd, device):
    """hymba-1.5b at full width through ``BatchServer`` on the card, with
    the kernel launch counts set to 0 just before and read just after."""
    from repro_torch.configs import get_arch
    cfg = get_arch(SERVE_ARCH)
    t0 = time.monotonic()
    params = T.init_params(cfg, device=device, dtype=torch.float32,
                           seed=SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = T.param_count(params)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in SERVE_WAVES for _ in range(SERVE_SLOTS)]
    # warm the libraries (cuBLAS handles, allocator) on a short wave
    run_server(torch, serve, params, cfg, device, "kernel",
               [prompts[0][:64]])
    counters = [fa.LAUNCHES["flash_attention"], ssd.LAUNCHES["ssd_chunk_scan"]]
    torch.cuda.reset_peak_memory_stats(device)
    for c in counters:
        c.reset()
    server, done, captured, wall = run_server(torch, serve, params, cfg,
                                              device, "kernel", prompts)
    launches = {"flash_attention": counters[0].count,
                "ssd_chunk_scan": counters[1].count}
    want = len(SERVE_WAVES) * cfg.n_layers
    if launches != {"flash_attention": want, "ssd_chunk_scan": want}:
        raise AssertionError(f"serve launches {launches}, expected {want} "
                             f"of each (waves x layers)")
    n_tok = sum(len(r.result_tokens) for r in done)
    if len(done) != len(prompts) or n_tok != len(prompts) * SERVE_NEW_TOKENS:
        raise AssertionError(f"served {len(done)} requests, {n_tok} tokens")
    for r in done:
        if not all(0 <= t < cfg.vocab_size for t in r.result_tokens):
            raise AssertionError(f"token out of the vocabulary in {r}")
    for w in captured:
        if not bool(torch.isfinite(w["logits"]).all()) or not all(
                bool(torch.isfinite(v.float()).all())
                for v in w["cache"].values()):
            raise AssertionError("non-finite prefill logits or cache")
    first = np.array([r.t_first_token - r.t_submit for r in done])
    emit("serve", arch=SERVE_ARCH, params=n_params, init_s=init_s,
         requests=len(done), tokens=n_tok, wall_s=wall,
         tokens_per_s=n_tok / wall,
         first_token_ms_mean=float(first.mean() * 1e3),
         first_token_ms_p95=float(np.percentile(first, 95) * 1e3),
         prefill_ms=[w["prefill_s"] * 1e3 for w in server.waves],
         decode_ms_per_step=[float(np.mean(w["decode_s"]) * 1e3)
                             for w in server.waves],
         waves=[[w["batch"], w["prompt_len"]] for w in server.waves],
         max_memory_allocated_gb=torch.cuda.max_memory_allocated(device)
         / 1e9, launches=launches)
    return params, cfg, prompts, done, captured, launches


def serve_vs_plain(torch, serve, fa, ssd, params, cfg, prompts, done,
                   captured, device):
    """The same waves through the same server with ``impl="dense"`` (no
    kernel): prefill logits and captured caches within 2e-3 (a bf16 k/v
    entry also within one bf16 rounding, 2^-7 of its size, since the fp32
    values it rounds differ slightly); greedy tokens equal up to the first
    place where the plain run's top two logits lie within 1e-4."""
    f0 = fa.LAUNCHES["flash_attention"].count
    s0 = ssd.LAUNCHES["ssd_chunk_scan"].count
    _, done_p, captured_p, wall = run_server(torch, serve, params, cfg,
                                             device, "dense", prompts)
    if (fa.LAUNCHES["flash_attention"].count != f0
            or ssd.LAUNCHES["ssd_chunk_scan"].count != s0):
        raise AssertionError("the dense path launched a kernel")
    errs = {}
    for w, (a, b) in enumerate(zip(captured, captured_p)):
        diff = (a["logits"] - b["logits"]).abs()
        errs[f"wave{w}_logits"] = float(diff.max())
        if bool((diff > MODEL_TOL * (1 + b["logits"].abs())).any()):
            raise AssertionError(f"wave {w}: prefill logits differ by "
                                 f"{float(diff.max())}")
        for name, ca in a["cache"].items():
            cb = b["cache"][name].float()
            diff = (ca.float() - cb).abs()
            slack = 2.0 ** -7 if ca.dtype == torch.bfloat16 else 0.0
            errs[f"wave{w}_{name}"] = float(diff.max())
            if bool((diff > MODEL_TOL + (MODEL_TOL + slack) * cb.abs()).any()):
                raise AssertionError(f"wave {w}: cache {name} differs by "
                                     f"{float(diff.max())}")
    near_ties, compared = 0, 0
    wave_of = [i // SERVE_SLOTS for i in range(len(prompts))]
    for i, (a, b) in enumerate(zip(done, done_p)):
        gaps = captured_p[wave_of[i]]["gaps"]
        for t, (ta, tb) in enumerate(zip(a.result_tokens, b.result_tokens)):
            compared += 1
            if ta != tb:
                gap = float(gaps[t][i % SERVE_SLOTS])
                if gap >= NEAR_TIE:
                    raise AssertionError(f"{a.request_id} token {t}: "
                                         f"{ta} vs {tb}, gap {gap}")
                near_ties += 1
                break           # later tokens follow different histories
    emit("serve_vs_plain", wall_s=wall, max_abs_err=errs,
         tokens_compared=compared, near_ties=near_ties,
         tokens_equal=sum(a.result_tokens == b.result_tokens
                          for a, b in zip(done, done_p)))


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


def profile_messages(torch, fn, msgs):
    """The CUDA work of ``fn(msg)`` per message, from ``torch.profiler``
    over one call per message after a warm-up call: ``(device_ms,
    launches)``, the kernels' device time and the number of kernels (copies
    and fills not counted).  Raises where the profiler records no device
    kernel: the work did not run on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(msgs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for msg in msgs:
            fn(msg)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if getattr(ev, "device_type", None) == DeviceType.CUDA
               and not ev.key.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise AssertionError("the profiler recorded no CUDA kernel")
    total_us = sum(ev.device_time_total for ev in kernels)
    return (total_us / len(msgs) / 1e3,
            sum(ev.count for ev in kernels) / len(msgs))


def on_card(torch, tree, what):
    """``tree`` after checking that it holds tensors and that every array
    in it is a tensor on the card (plain numbers are let through)."""
    from torch.utils import _pytree as pytree
    arrays = [x for x in pytree.tree_leaves(tree)
              if isinstance(x, (torch.Tensor, np.ndarray))]
    if not arrays or not all(isinstance(x, torch.Tensor)
                             and x.device.type == "cuda" for x in arrays):
        raise AssertionError(f"{what} is not on the card")
    return tree


def check_on_card(torch, obj, method, what):
    """Wrap ``obj.method`` so that every result it returns is checked
    with ``on_card``."""
    inner = getattr(obj, method)

    def checked(*args, **kwargs):
        return on_card(torch, inner(*args, **kwargs), what)

    setattr(obj, method, checked)


def cloud_loop(core, ml, handler, n_messages, model, seed):
    """``run_pipeline``'s closed loop for another cloud processor: 4 edge
    producers of 10,000 × 32 messages, 4 cloud workers on one card."""
    manager = core.PilotManager()
    edge = manager.submit_pilot(core.ComputeResource(
        tier="edge", n_workers=4, memory_gb=4))
    cloud = manager.submit_pilot(core.ComputeResource(
        tier="cloud", n_devices=1, n_workers=4, memory_gb=44))
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], n_clusters=25,
                              seed=seed)

    def process_edge(context, data=None):
        return data[np.isfinite(data).all(axis=1)]

    res = core.EdgeToCloudPipeline(
        pilot_cloud_processing=cloud, pilot_edge=edge,
        produce_function_handler=gen.make_producer(),
        process_edge_function_handler=process_edge,
        process_cloud_function_handler=handler,
        function_context={"model": model},
    ).run(n_messages=n_messages, timeout_s=LOOP_TIMEOUT_S)
    manager.release_all()
    if res.n_processed != n_messages:
        raise AssertionError(f"{model}: processed {res.n_processed}/"
                             f"{n_messages}")
    for r in res.results:
        if not (np.isfinite(r["mean_score"]) and r["n_outliers"] >= 0):
            raise AssertionError(f"{model}: bad result {r}")
    return res


def advise(core, cost):
    """``placement="advise"`` for k-means and the auto-encoder on a port
    pipeline at the paper's largest message: the best placement per band
    and the wall time of each advisory grid.  Checks 5 finite rows a band
    for both, and tests/test_cost.py's Fig-3 pin for k-means: it goes to
    the edge (or hybrid) at 10 Mbit/s."""
    manager = core.PilotManager(devices=())
    edge = manager.submit_pilot(core.ComputeResource(tier="edge",
                                                     n_workers=4))
    cloud = manager.submit_pilot(core.ComputeResource(tier="cloud",
                                                      n_workers=4))
    out = {}
    for model in ("kmeans", "autoencoder"):
        pipe = core.EdgeToCloudPipeline(
            pilot_cloud_processing=cloud, pilot_edge=edge,
            produce_function_handler=lambda ctx: None,
            process_cloud_function_handler=lambda ctx, data=None: None,
            function_context={"model": model, "n_points": MAIN_SHAPE[0]})
        t0 = time.perf_counter()
        rep = pipe.run(placement="advise")
        wall = time.perf_counter() - t0
        if not isinstance(rep, cost.AdvisorReport) or rep.model != model:
            raise AssertionError(f"advise({model}) returned {rep!r}")
        bands = list(dict.fromkeys(c.wan_band for c in rep.cells))
        if len(rep.rows()) != 5 * len(bands) or not all(
                np.isfinite(r["msgs_per_s"]) for r in rep.rows()):
            raise AssertionError(f"advise({model}): bad rows")
        out[model] = {"best": {b: rep.best(b).placement for b in bands},
                      "wall_s": wall}
    manager.release_all()
    if out["kmeans"]["best"]["10mbit"] not in ("edge", "hybrid"):
        raise AssertionError(f"k-means at 10 Mbit/s: {out['kmeans']}")
    emit("advise", models=out)
    return out


def ae_bound(n, sizes):
    """Least time for one AE processor message of n points on this card:
    the larger of its bytes (points read once, scores written once, the
    params and both Adam moments read and written once) over HBM bandwidth
    and its fp32 flops over the fp32 peak.  Flops: a scoring forward, the
    training forward, a backward of twice the forward and the post-step
    loss's forward, 2·din·dout a point and layer each.  Also returns the
    flops and the activations one forward writes (MB), for the record."""
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    n_params = macs + sum(sizes[1:])
    flops = 5 * 2.0 * n * macs
    nbytes = n * sizes[0] * 4 + n * 4 + 2 * 3 * n_params * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["fp32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops,
            n * sum(sizes[1:]) * 4 / 1e6)


def iforest_bound(n, f, n_trees, n_nodes, depth):
    """Least time for one isolation-forest message (refit, then score):
    the points read once, the forest (int32 feature, fp32 threshold and
    size, bool leaf flag a node) and the scores written once, over HBM
    bandwidth; against a compare and a select a point, tree and level
    over the fp32 peak."""
    nbytes = n * f * 4 + n_trees * n_nodes * 13 + n * 4
    ops = 2.0 * n * n_trees * depth
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["fp32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def run_ae_pipeline(torch, core, ml, device):
    """The auto-encoder processor in ``run_pipeline``'s closed loop on the
    card: 64 training messages, then 8 inference messages from the
    published state; its device time and kernel launches per message from
    the profiler.  The 4 cloud workers share the processor's state without
    a lock, as in the reference, so concurrent updates are lost: in lock
    step one update in 4 is kept (tests/test_torch_autoencoder.py,
    ``test_concurrent_workers_lose_updates_as_the_reference``), and the
    published step must reach that floor."""
    params = core.ParameterService()
    ae = ml.AutoEncoder(device=device)
    check_on_card(torch, ae, "update", "the AE's trained state")
    check_on_card(torch, ae, "outlier_scores", "the AE's scores")
    res = cloud_loop(core, ml, ae.make_processor(params, "autoencoder"),
                     AE_MESSAGES, "autoencoder", seed=7)
    torch.cuda.synchronize()
    version, tree = params.fetch("autoencoder")
    floor = AE_MESSAGES // 4
    if version != AE_MESSAGES or int(tree["step"]) < floor or not all(
            np.isfinite(p[k]).all() for p in tree["params"]
            for k in ("w", "b")):
        raise AssertionError(f"published AE state is wrong (version "
                             f"{version}, step {int(tree['step'])})")
    res_inf = cloud_loop(core, ml,
                         ae.make_processor(params, "autoencoder",
                                           train=False),
                         8, "autoencoder", seed=8)
    if params.version("autoencoder") != AE_MESSAGES:
        raise AssertionError("inference published a version")
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], seed=9)
    msgs = [gen.sample() for _ in range(8)]
    ae_prof = ml.AutoEncoder(device=device)
    check_on_card(torch, ae_prof, "update", "the AE's trained state")
    proc = ae_prof.make_processor(core.ParameterService(), "autoencoder")
    dev_ms, launches = profile_messages(torch, lambda m: proc(None, data=m),
                                        msgs)
    sizes = [tree["params"][0]["w"].shape[0]] + [
        p["w"].shape[1] for p in tree["params"]]
    bound, bound_by, flops, act_mb = ae_bound(MAIN_SHAPE[0], sizes)
    emit("ae_pipeline", n_processed=res.n_processed, wall_s=res.wall_s,
         msgs_per_s=res.throughput()["msgs_per_s"],
         inference_msgs_per_s=res_inf.throughput()["msgs_per_s"],
         n_inference=res_inf.n_processed, params_version=version,
         step=int(tree["step"]), step_floor=floor, device_ms_per_msg=dev_ms,
         launches_per_msg=launches, bound_ms=bound, bound_by=bound_by,
         gflop_per_msg=flops / 1e9, activation_mb_per_forward=act_mb)


def ae_vs_host(torch, core, ml, device):
    """The same 8 seeded messages through the AE processor on the card and
    on the host from one initial state: equal outlier counts and versions;
    mean scores and losses within 1e-5 relative and the final params within
    5e-5 (tests/test_torch_autoencoder.py's tolerances against the
    reference: Adam scales each element's step to about lr, so a gradient
    that differs by a rounding moves a param where |g| ~ sqrt(nu))."""
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], seed=21)
    msgs = [gen.sample() for _ in range(8)]
    init = ml.AutoEncoder(device="cpu").init()
    losses = {}
    results = {}
    trees = {}
    for name, dev in (("card", device), ("host", "cpu")):
        ps = core.ParameterService()
        ps.publish("ae", init)
        ae = ml.AutoEncoder(device=dev)
        seen = losses.setdefault(name, [])
        update = ae.update

        def recording(state, points, update=update, seen=seen, name=name):
            new, loss = update(state, points)
            if name == "card":
                on_card(torch, new, "the card processor's state")
            seen.append(loss)
            return new, loss

        ae.update = recording
        proc = ae.make_processor(ps, "ae")
        results[name] = [proc(None, data=m) for m in msgs]
        trees[name] = ps.fetch("ae")
    worst_score = worst_loss = 0.0
    for a, b in zip(results["card"], results["host"]):
        if a["n_outliers"] != b["n_outliers"]:
            raise AssertionError(f"n_outliers {a} vs {b}")
        err = abs(a["mean_score"] - b["mean_score"]) / abs(b["mean_score"])
        worst_score = max(worst_score, err)
    for a, b in zip(losses["card"], losses["host"]):
        worst_loss = max(worst_loss, abs(a - b) / abs(b))
    (va, ta), (vb, tb) = trees["card"], trees["host"]
    param_err = max(float(np.abs(pa[k] - pb[k]).max())
                    for pa, pb in zip(ta["params"], tb["params"])
                    for k in ("w", "b"))
    if va != vb or not int(ta["step"]) == int(tb["step"]) == len(msgs):
        raise AssertionError(f"versions {va}/{vb}, steps {ta['step']}/"
                             f"{tb['step']}")
    if worst_score > 1e-5 or worst_loss > 1e-5 or param_err > 5e-5:
        raise AssertionError(f"AE card vs host: mean_score {worst_score}, "
                             f"loss {worst_loss}, params {param_err}")
    emit("ae_vs_host", messages=len(msgs), mean_score_max_rel=worst_score,
         loss_max_rel=worst_loss, param_max_abs=param_err,
         n_outliers=[r["n_outliers"] for r in results["card"]])


def run_iforest_pipeline(torch, core, ml, device):
    """The isolation-forest processor (100 trees, refit per message) in
    the same closed loop on the card for 16 messages; device time and
    kernel launches per message from the profiler."""
    params = core.ParameterService()
    forest = ml.IsolationForest(device=device)
    check_on_card(torch, forest, "fit", "the fitted forest")
    check_on_card(torch, forest, "outlier_scores", "the forest's scores")
    res = cloud_loop(core, ml, forest.make_processor(params, "iforest"),
                     IFOREST_MESSAGES, "isoforest", seed=7)
    version, tree = params.fetch("iforest")
    if version != IFOREST_MESSAGES or tree["forest"]["size"].shape != (
            100, 511):
        raise AssertionError(f"published forest is wrong ({version})")
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], seed=9)
    msgs = [gen.sample() for _ in range(4)]
    forest_prof = ml.IsolationForest(device=device)
    check_on_card(torch, forest_prof, "fit", "the fitted forest")
    proc = forest_prof.make_processor()
    dev_ms, launches = profile_messages(torch, lambda m: proc(None, data=m),
                                        msgs)
    n_trees, n_nodes = tree["forest"]["size"].shape
    bound, bound_by = iforest_bound(MAIN_SHAPE[0], MAIN_SHAPE[1], n_trees,
                                    n_nodes, forest.max_depth)
    emit("iforest_pipeline", n_processed=res.n_processed, wall_s=res.wall_s,
         msgs_per_s=res.throughput()["msgs_per_s"], params_version=version,
         device_ms_per_msg=dev_ms, launches_per_msg=launches,
         bound_ms=bound, bound_by=bound_by)


def _auc(s, is_out):
    order = np.argsort(s)
    ranks = np.empty_like(order, float)
    ranks[order] = np.arange(len(s))
    return float((ranks[is_out].mean() - ranks.mean()) / len(s) + 0.5)


def iforest_vs_host(torch, ml, device):
    """One forest built on the host and moved to the card scores the same
    10,000 points on both: equal leaves and depths in every tree, scores
    within 1e-6.  Then the card's own fit passes tests/test_ml.py:83-96's
    band: outlier mean above inlier mean + 0.05, AUC > 0.85."""
    from repro_torch.ml import isoforest as tif
    pts, _ = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], outlier_frac=0.02,
                                 seed=5).sample_with_labels()
    host = ml.IsolationForest(device="cpu")
    card = ml.IsolationForest(device=device)
    st = host.fit(pts)
    st_card = {"forest": {k: v.to(device) for k, v in st["forest"].items()},
               "psi": st["psi"].to(device)}
    x = torch.as_tensor(pts, dtype=torch.float32)
    node_h, depth_h = tif._walk(st["forest"], x, host.max_depth)
    node_c, depth_c = tif._walk(st_card["forest"], x.to(device),
                                host.max_depth)
    if not (torch.equal(node_c.cpu(), node_h)
            and torch.equal(depth_c.cpu(), depth_h)):
        raise AssertionError("leaves or depths differ between card and host")
    on_card(torch, st_card, "the moved forest")
    s_card = on_card(torch, card.outlier_scores(st_card, pts),
                     "the card's scores").cpu().numpy()
    s_host = host.outlier_scores(st, pts).numpy()
    err = float(np.abs(s_card - s_host).max())
    if err > 1e-6:
        raise AssertionError(f"iforest scores differ by {err}")
    band_pts, is_out = ml.MiniAppGenerator(
        n_points=1_500, outlier_frac=0.03, seed=4).sample_with_labels()
    own = ml.IsolationForest(n_trees=50, device=device)
    own_state = on_card(torch, own.fit(band_pts), "the card's own fit")
    s = own.outlier_scores(own_state, band_pts).cpu().numpy()
    gap = float(s[is_out].mean() - s[~is_out].mean())
    auc = _auc(s, is_out)
    if gap <= 0.05 or auc <= 0.85:
        raise AssertionError(f"card fit: gap {gap}, AUC {auc}")
    emit("iforest_vs_host", points=len(pts), score_max_abs_err=err,
         leaves_equal=True, depths_equal=True, own_fit_gap=gap,
         own_fit_auc=auc)


def outlier_example(torch, kk, device):
    """``repro_torch.examples.edge_to_cloud_outlier.main`` on the card,
    with the k-means launch counts set to 0 just before and read just
    after: every message processed, the fault retried, the swap to the
    auto-encoder recorded, the k-means kernel launched."""
    from repro_torch.examples import edge_to_cloud_outlier as example
    for counter in kk.LAUNCHES.values():
        counter.reset()
    t0 = time.perf_counter()
    out = example.main(device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.count for name, c in kk.LAUNCHES.items()}
    if out["n_processed"] != out["n_messages"]:
        raise AssertionError(f"example processed {out['n_processed']}/"
                             f"{out['n_messages']}")
    if not out["fault_fired"] or out["retries"] < 1:
        raise AssertionError("the injected fault was not retried")
    if out["swaps"] != ["process_cloud"]:
        raise AssertionError(f"swaps {out['swaps']}")
    if launches["kmeans_assign_update"] < 1:
        raise AssertionError("the example launched no k-means kernel")
    emit("outlier_example", n_messages=out["n_messages"],
         n_processed=out["n_processed"], wall_s=wall,
         run_wall_s=out["wall_s"], msgs_per_s=out["msgs_per_s"],
         advise_wall_s=out["advise_wall_s"], advice=out["advice"],
         retries=out["retries"], swaps=out["swaps"],
         autoscale=out["autoscale"], kmeans_messages=out["kmeans_messages"],
         params_versions=out["params_versions"], launches=launches)


# --- training (internlm2-1.8b at full width; mamba2-130m for resume) ------


def train_flops(cfg, batch, seq, remat=True):
    """fp32 matmul operations of one dense train step, from the shapes:
    the projections, the FFN and the dense attention's two products (all
    S² pairs: the dense path masks after the product) in every layer and
    the head; backward twice the forward, and with remat the layers'
    forward once more."""
    d, h, kv, hd, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.n_layers)
    tok = batch * seq
    n_ffn = 3 if cfg.ffn_kind == "swiglu" else 2
    layer = (2 * tok * (d * h * hd + 2 * d * kv * hd + h * hd * d
                        + n_ffn * d * cfg.d_ff)
             + 4 * batch * h * seq * seq * hd)
    fwd = L * layer + 2 * tok * d * cfg.padded_vocab_size
    return 3 * fwd + (L * layer if remat else 0)


def profile_step(torch, fn):
    """``(device_ms, launches)`` of one call of ``fn`` from
    ``torch.profiler``: the CUDA kernels' time and count, copies and
    fills not counted.  Raises where no CUDA kernel was recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if getattr(ev, "device_type", None) == DeviceType.CUDA
               and not ev.key.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise AssertionError("the profiler recorded no CUDA kernel")
    return (sum(ev.device_time_total for ev in kernels) / 1e3,
            sum(ev.count for ev in kernels), out)


def _max_abs(torch, a, b):
    from torch.utils import _pytree as pytree
    return max(float((x.float().cpu() - y.float().cpu()).abs().max())
               for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


def timed_steps(torch, TS):
    """Wrap ``TS.make_train_step`` so that every step it makes records a
    CUDA event as its work is queued.  Returns (events, restore): the
    events of consecutive steps bound each step on the device's timeline,
    idle time waiting for the host included, without a host sync."""
    make = TS.make_train_step
    events = []

    def timed_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(*a, **kw):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            return step(*a, **kw)
        return timed

    def restore():
        TS.make_train_step = make

    TS.make_train_step = timed_make
    return events, restore


def train_full(torch, TL, TS, T, device):
    """internlm2-1.8b at full width and depth through ``train_loop``:
    fp32 params and AdamW moments, remat on, dense attention, 4 × 1,024
    tokens a step from ``make_batch_iterator(seed=0)``, 8 steps, the loss
    read back at the first and last step only (so the host draws the next
    batch while the card runs the step, as with the default log_every);
    then one more step under the profiler."""
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_arch
    from repro_torch.data import make_batch_iterator
    cfg = get_arch(TRAIN_ARCH)
    tc = TS.TrainConfig(lr=3e-4, warmup=10, total_steps=TRAIN_STEPS)
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    compute_grads = TS.compute_grads
    check_on_card(torch, TS, "compute_grads", "the gradients")
    events, restore = timed_steps(torch, TS)
    try:
        t0 = time.perf_counter()
        params, state, hist = TL.train_loop(
            cfg, tc, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            seed=0, log_every=TRAIN_STEPS, device=device,
            log=lambda _: stamps.append(time.perf_counter()))
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
    finally:
        TS.compute_grads = compute_grads
        restore()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    on_card(torch, params, "the trained params")
    on_card(torch, state, "the train state")
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    if len(hist) != 2 or not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"non-finite loss or grad norm: {hist}")
    if int(state["step"]) != TRAIN_STEPS:
        raise AssertionError(f"step {int(state['step'])}")
    events.append(end)
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    median_ms = statistics.median(step_ms[2:])          # steps 3-8
    p0 = T.init_params(cfg, device=device, seed=0)     # train_loop's init
    still = sum(torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(params), pytree.tree_leaves(p0)))
    del p0
    if still:
        raise AssertionError(f"{still} parameter leaves did not move")

    it = make_batch_iterator(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                             device="cpu")
    t = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        next(it)
    data_ms = 1e3 * (time.perf_counter() - t) / TRAIN_STEPS
    batch = {k: v.to(device) for k, v in next(it).items()}
    step = TS.make_train_step(cfg, tc)
    dev_ms, launches, out = profile_step(
        torch, lambda: step(params, state, batch))
    del out
    # the host's time to queue one step, and of it the forward and
    # backward's (compute_grads); the card runs the step meanwhile, so
    # where the launch queue fills this includes waiting for the card
    grads_ms = []

    def timed_grads(*a, **kw):
        t = time.perf_counter()
        out = compute_grads(*a, **kw)
        grads_ms.append(1e3 * (time.perf_counter() - t))
        return out

    TS.compute_grads = timed_grads
    try:
        t = time.perf_counter()
        out = step(params, state, batch)
        enqueue_ms = 1e3 * (time.perf_counter() - t)
    finally:
        TS.compute_grads = compute_grads
    torch.cuda.synchronize()
    del out
    n_params = T.param_count(params)
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit("train", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         steps=TRAIN_STEPS, dtype="fp32", remat=True, impl="dense",
         wall_s=wall, step_ms_each=step_ms, step_ms=median_ms,
         tokens_per_s=tokens / median_ms * 1e3,
         tokens_per_s_wall_steps_2_8=(TRAIN_STEPS - 1) * tokens
         / (stamps[-1] - stamps[0]), data_ms=data_ms,
         peak_gb=peak_gb, state_gb_16B_per_param=16 * n_params / 1e9,
         loss_first=losses[0], loss_last=losses[-1], grad_norm=gnorms,
         device_ms_per_step=dev_ms, launches_per_step=launches,
         host_enqueue_ms=enqueue_ms, host_enqueue_grads_ms=grads_ms[0],
         device_idle_share=1 - dev_ms / median_ms,
         tflop_per_step=flops / 1e12,
         bound_ms=flops / PEAK_FLOPS["fp32"] * 1e3, bound_by="operations")
    del params, state
    torch.cuda.empty_cache()


def train_vs_host(torch, TS, T, device):
    """internlm2-1.8b at full width with its depth cut to 2 layers, 2 × 128
    tokens: the same weights (made on the host from a seed, copied to the
    card) and the same batches through three steps of ``make_train_step``
    on the card and on the host."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_arch
    from repro_torch.data import make_batch_iterator
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=2)
    tc = TS.TrainConfig(lr=3e-4, warmup=10, total_steps=TRAIN_STEPS)
    host = torch.device("cpu")
    params_h, state_h = TS.init_train_state(cfg, tc, seed=1, device=host)
    params_c = pytree.tree_map(lambda t: t.to(device), params_h)
    state_c = pytree.tree_map(lambda t: t.to(device), state_h)
    it = make_batch_iterator(cfg, 2, 128, seed=0, device=host)
    step = TS.make_train_step(cfg, tc)
    rows = []
    for i in range(3):
        batch = next(it)
        params_c, state_c, mc = step(params_c, state_c,
                                     {k: v.to(device)
                                      for k, v in batch.items()})
        params_h, state_h, mh = step(params_h, state_h, batch)
        row = {k: abs(float(mc[k]) - float(mh[k])) / abs(float(mh[k]))
               for k in ("loss", "grad_norm")}
        rows.append(row)
        if max(row.values()) > 1e-4:
            raise AssertionError(f"step {i + 1}: card and host differ {row}")
    on_card(torch, (params_c, state_c), "the card's train state")
    worst = _max_abs(torch, params_c, params_h)
    if worst > 5e-5:
        raise AssertionError(f"params differ by {worst} after 3 steps")
    emit("train_vs_host", arch=cfg.name, reduced="n_layers 24 -> 2",
         d_model=cfg.d_model, batch=2, seq=128, steps=3,
         rel_diff_per_step=rows, params_max_abs=worst, tol_rel=1e-4,
         tol_params=5e-5)


def train_resume(torch, TL, TS, device):
    """mamba2-130m at full width (d_model 768) with 2 layers, 2 × 256
    tokens, lr 1e-3: 4 steps with a checkpoint, resumed to 8, against a
    straight run to 8 (the reference test's 1e-6).  The SSD path's
    backward runs on the card."""
    import dataclasses
    import shutil
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("mamba2-130m"), n_layers=2)
    tc = TS.TrainConfig(lr=1e-3, warmup=2, total_steps=8)
    ckpt = Path(__file__).resolve().parent / "build" / "train_resume"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(batch=2, seq_len=256, device=device, log=lambda _: None)
    TL.train_loop(cfg, tc, steps=4, ckpt_dir=str(ckpt), ckpt_every=4, **kw)
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*")
                     if f.is_file())
    logs = []
    p_res, _, _ = TL.train_loop(cfg, tc, steps=8, ckpt_dir=str(ckpt),
                                ckpt_every=4, **{**kw, "log": logs.append})
    if "resumed from step 4" not in logs:
        raise AssertionError(f"did not resume: {logs}")
    p_str, _, _ = TL.train_loop(cfg, tc, steps=8, **kw)
    on_card(torch, p_res, "the resumed params")
    worst = 0.0
    from torch.utils import _pytree as pytree
    for a, b in zip(pytree.tree_leaves(p_res), pytree.tree_leaves(p_str)):
        if not bool(torch.isfinite(b).all()):
            raise AssertionError("the straight run's params are not finite")
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
        worst = max(worst, float((a - b).abs().max()))
    shutil.rmtree(ckpt, ignore_errors=True)
    emit("train_resume", arch=cfg.name, reduced="n_layers 24 -> 2",
         d_model=cfg.d_model, batch=2, seq=256, steps="4 + 4 vs 8",
         params_max_abs=worst, tol=1e-6, checkpoint_bytes=ckpt_bytes)


def int8_pod(torch, TS, device):
    """``make_compressed_train_step`` on a one-rank NCCL group, 2 steps of
    reduced internlm2-1.8b: the error buffers stay bf16, finite and on the
    card, and step 1's compressed gradient is within scale/2 of the plain
    one (the residual bound of int8 rounding)."""
    import socket
    import torch.distributed as dist
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_arch
    from repro_torch.data import make_batch_iterator
    from repro_torch.models import convert
    from repro_torch.optim import tree_compressed_psum
    cfg = get_arch(TRAIN_ARCH).reduced()
    tc = TS.TrainConfig(lr=1e-3, warmup=2, total_steps=8,
                        grad_compression="int8_pod")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        params, state = TS.init_train_state(cfg, tc, seed=0, device=device)
        it = make_batch_iterator(cfg, 4, 64, seed=0, device=device)
        batches = [next(it), next(it)]
        plain, _ = TS.compute_grads(cfg, tc, params, batches[0])
        stacked = convert.stack_blocks(plain)
        deq, _ = tree_compressed_psum(stacked, group)
        worst = 0.0
        for g, q in zip(pytree.tree_leaves(stacked), pytree.tree_leaves(deq)):
            half = float(g.abs().max()) / 127 / 2
            err = float((g - q).abs().max())
            if err > half + 1e-6:           # tests/test_train_integration.py
                raise AssertionError(f"compressed gradient off by {err} "
                                     f"> scale/2 = {half}")
            worst = max(worst, err / max(half, 1e-30))
        step = TS.make_compressed_train_step(cfg, tc, group)
        metrics = []
        for b in batches:
            params, state, m = step(params, state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        ef = pytree.tree_leaves(state["ef"])
        on_card(torch, state["ef"], "the error buffers")
        if not all(t.dtype == torch.bfloat16 and bool(torch.isfinite(t).all())
                   for t in ef):
            raise AssertionError("error buffers are not finite bf16")
        if int(state["step"]) != 2:
            raise AssertionError("steps were not counted")
    finally:
        dist.destroy_process_group()
    emit("int8_pod", arch=cfg.name, backend="nccl", world_size=1, steps=2,
         metrics=metrics, worst_err_over_half_scale=worst,
         ef_max_abs=max(float(t.float().abs().max()) for t in ef))


# --- the rest of the paper's framework: sharded DES, examples, B5, A6 -----


def des_sharded():
    """The sharded DES on the committed ``BENCH_des_scale.json`` diurnal row
    (100,000 messages, 100 devices, 1,000 consumers, 20,000 Hz, 64 B,
    service 1 ms, seed 0), single-process inline and at 4 shards ``mp``:
    both must reproduce the row's deterministic columns bit for bit.  It
    runs before anything touches CUDA, because ``mp`` forks."""
    import os

    from repro_torch.sim import shard
    bench = json.loads((Path(__file__).resolve().parent
                        / "BENCH_des_scale.json").read_text())
    golden = next(r for r in bench["rows"] if r["arrival"] == "diurnal")
    for key in ("messages", "devices", "consumers", "payload_bytes",
                "seed"):
        if golden[key] != DES_CELL[key]:
            raise AssertionError(f"BENCH_des_scale.json diurnal row has "
                                 f"{key}={golden[key]}")
    runs = []
    for shards, mode in ((1, "inline"), (4, "mp")):
        row = shard.run_scale_sharded(**DES_CELL, shards=shards, mode=mode)
        bad = {col: (row[col], golden[col]) for col in DES_DET_COLS
               if row[col] != golden[col]}
        if bad:
            raise AssertionError(f"{shards} shards {mode}: {bad}")
        runs.append({key: row[key] for key in (
            "shards", "mode", "windows", "events", "wall_s",
            "events_per_s", "cpu_s_total", "cpu_critical_s",
            "agg_events_per_s")})
    emit("des_sharded", cell=DES_CELL, cpu_count=os.cpu_count(),
         golden={col: golden[col] for col in DES_DET_COLS},
         golden_wall_s=golden["wall_s"], runs=runs)


def quickstart_example(torch, core, ml, kk, device):
    """``repro_torch.examples.quickstart.main`` at its full size (128
    messages of 2,500 × 32, k = 25) on the card, with the k-means launch
    counts set to 0 just before and read just after; then the quickstart's
    first messages through the processor on the card and on the host, in
    order, as ``check_against_plain_path`` holds them."""
    from repro_torch.examples import quickstart
    for counter in kk.LAUNCHES.values():
        counter.reset()
    out = quickstart.main(device=device)
    torch.cuda.synchronize()
    launches = {name: c.count for name, c in kk.LAUNCHES.items()}
    if out["n_processed"] != out["n_messages"]:
        raise AssertionError(f"quickstart processed {out['n_processed']}/"
                             f"{out['n_messages']}")
    if launches["kmeans_assign_update"] < out["n_messages"]:
        raise AssertionError(f"quickstart launched B1 "
                             f"{launches['kmeans_assign_update']} times")
    gen = ml.MiniAppGenerator(n_points=2_500, n_clusters=25, seed=7)
    msgs = [gen.sample() for _ in range(QUICKSTART_CHECKED)]
    card = ml.KMeans(device=device).make_processor()
    host = ml.KMeans(device="cpu").make_processor()
    worst = 0.0
    for msg in msgs:
        a, b = card(None, data=msg), host(None, data=msg)
        diff = abs(a["mean_score"] - b["mean_score"])
        worst = max(worst, diff)
        if a["n_outliers"] != b["n_outliers"] or \
                diff > 1e-5 * abs(b["mean_score"]) + 0.05 * 25 / 2_500:
            raise AssertionError(f"quickstart message: {a} vs {b}")
    emit("quickstart_example", n_messages=out["n_messages"],
         n_processed=out["n_processed"], wall_s=out["wall_s"],
         msgs_per_s=out["msgs_per_s"], outliers=out["outliers"],
         launches=launches, checked_vs_host=len(msgs),
         mean_score_max_abs=worst)


def geo_example(torch, kk, device):
    """``repro_torch.examples.geo_distributed.main`` on the card: 64
    messages of 2,500 points local, then across a ``WanShaper(80e6, rtt
    0.150, sleep=True)``, then the PlacementEngine's ranking (k-means to
    the edge, the auto-encoder to the cloud: the paper's Fig 3)."""
    from repro_torch.examples import geo_distributed as geo
    for counter in kk.LAUNCHES.values():
        counter.reset()
    out = geo.main(device=device)
    torch.cuda.synchronize()
    launches = {name: c.count for name, c in kk.LAUNCHES.items()}
    n = out["n_messages"]
    if out["local"]["n_processed"] != n or out["geo"]["n_processed"] != n:
        raise AssertionError(f"geo example processed {out['local']} / "
                             f"{out['geo']}")
    if launches["kmeans_assign_update"] < 2 * n:
        raise AssertionError(f"geo example launched B1 {launches}")
    choices = {name: r["choice"] for name, r in out["rankings"].items()}
    if choices != {"k-means": "edge", "auto-encoder": "cloud"}:
        raise AssertionError(f"placement ranking {choices}")
    emit("geo_example", n_messages=n, local=out["local"], geo=out["geo"],
         rankings=out["rankings"], launches=launches)


def autotune(torch, kk, device):
    """B5 at the timed shapes and every precision: each tile instance held
    against the plain version (``check_kernel``), its ids and dmin the same
    bits as every other tile's, timed with CUDA events; then
    ``autotune_block_n`` at the full shape and at its default 4,096-row
    probe, from an empty cache."""
    for n, f, k in TIMED_SHAPES:
        x, c = blobs(torch, n, f, k, device, SEED + 1)
        iters = 50 if n <= 100_000 else 10
        for precision in PRECISIONS:
            prep = kk.prepare(x, c, precision)
            first, cands = None, {}
            for tile in kk.TILES:
                row = check_kernel(torch, kk, n, f, k, precision, device,
                                   block_n=tile)
                ids, dmin, _, _ = kk.launch(prep, True, tile)
                a_ids, a_dmin = kk.launch(prep, False, tile)
                torch.cuda.synchronize()
                first = first or (ids, dmin)
                if not all(torch.equal(a, b) for a, b in (
                        (a_ids, ids), (a_dmin, dmin), (ids, first[0]),
                        (dmin, first[1]))):
                    raise AssertionError(f"ids/dmin of the {tile}-row tile "
                                         f"differ at {(n, f, k)} "
                                         f"{precision}")
                cands[tile] = {
                    "ms": time_ms(torch, lambda: kk.launch(prep, True, tile),
                                  iters),
                    "assign_ms": time_ms(
                        torch, lambda: kk.launch(prep, False, tile), iters),
                    "grid": row["grid"], "sum_chain": row["sum_chain"],
                    "sums_max_abs_err": row["sums_max_abs_err"],
                    "id_mismatches_at_ties": row["id_mismatches_at_ties"]}
            kk._autotune_cache.clear()
            t0 = time.perf_counter()
            winner = kk.autotune_block_n(n, f, k, precision=precision,
                                         probe_n=n, device=device)
            sweep_s = time.perf_counter() - t0
            winner_probe = kk.autotune_block_n(n, f, k, precision=precision,
                                               device=device)
            emit("autotune", shape=[n, f, k], precision=precision,
                 candidates=cands, winner=winner, sweep_s=sweep_s,
                 winner_at_4096_probe=winner_probe,
                 fastest_timed=min(cands, key=lambda t: cands[t]["ms"]),
                 default=kk.DEFAULT_BLOCK_N)


def calibrate(torch, kk, device):
    """``Calibrator(...).calibrate(measure_service=True)`` at 2,500 × 32,
    every processor on the card: the fitted efficiency and sigma of the
    five models beside the committed paper-testbed fit, and the torch
    flop count beside the committed HLO figure."""
    from repro_torch.cost import calibrate as cal
    for counter in kk.LAUNCHES.values():
        counter.reset()
    t0 = time.perf_counter()
    costs = cal.Calibrator(n_points=2_500, n_features=32,
                           device=device).calibrate(measure_service=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.count for name, c in kk.LAUNCHES.items()}
    committed = cal.load_calibration()
    models = {}
    for name, mc in sorted(costs.items()):
        ref = committed[name]
        if not (0.0 < mc.efficiency <= 1.0 and np.isfinite(mc.sigma)
                and mc.sigma >= 0.0 and mc.source == "measured"):
            raise AssertionError(f"calibrate {name}: {mc}")
        models[name] = {
            "efficiency": mc.efficiency, "sigma": mc.sigma,
            "paper_efficiency": ref.efficiency, "paper_sigma": ref.sigma,
            "torch_flops_per_point": mc.kernel_flops_per_point,
            "hlo_flops_per_point": ref.kernel_flops_per_point,
            "flops_ratio": mc.kernel_flops_per_point
            / ref.kernel_flops_per_point,
            "torch_bytes_per_point": mc.kernel_bytes_per_point,
            "hlo_bytes_per_point": ref.kernel_bytes_per_point}
    if not 0.75 <= models["kmeans"]["flops_ratio"] <= 1.33:
        raise AssertionError(f"k-means count {models['kmeans']}")
    # three k-means processors, a warm-up and 5 samples each
    if launches["kmeans_assign_update"] < 3 * 6:
        raise AssertionError(f"calibration launched B1 {launches}")
    emit("calibrate", wall_s=wall, models=models, launches=launches)


def lm_example(torch, fa, device):
    """``repro_torch.examples.train_and_serve_lm.main --params 100`` (12
    layers × 768) on the card: a short training run whose loss must fall,
    checkpoints, publish and fetch through the parameter service, then 8
    requests served through ``BatchServer``, whose GQA prefill goes
    through the flash-attention kernel (its launch count set to 0 just
    before and read just after).  Every launch's inputs and output are
    kept, and each output is held against the plain version on the same
    inputs at the flash checks' fp32 tolerance (:func:`flash_tol`)."""
    from repro_torch.examples import train_and_serve_lm as lm
    launch, seen = fa.launch, []

    def kept_launch(q, k, v, *, causal=True, window=None):
        out = launch(q, k, v, causal=causal, window=window)
        seen.append((q.clone(), k.clone(), v.clone(), causal, window,
                     out.clone()))
        return out

    for counter in fa.LAUNCHES.values():
        counter.reset()
    fa.launch = kept_launch
    try:
        t0 = time.perf_counter()
        out = lm.main(device=device, params_m=100, steps=LM_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        fa.launch = launch
    launches = {name: c.count for name, c in fa.LAUNCHES.items()}
    worst, shapes = 0.0, set()
    for q, k, v, causal, window, got in seen:
        want = fa.plain(q, k, v, causal=causal, window=window)
        diff = (got.float() - want.float()).abs()
        worst = max(worst, float(diff.max()))
        shapes.add((*q.shape, k.shape[2], str(q.dtype), causal, window))
        if got.dtype != torch.float32 or bool(
                (diff > flash_tol(want, "fp32")).any()):
            raise AssertionError(f"LM example flash launch at "
                                 f"{tuple(q.shape)}/{tuple(k.shape)}: "
                                 f"max error {float(diff.max())}")
    if len(seen) != launches["flash_attention"]:
        raise AssertionError(f"kept {len(seen)} of {launches} launches")
    del seen
    cfg = lm.sized_config(100)
    waves = len(out["waves"])
    if launches["flash_attention"] != cfg.n_layers * waves:
        raise AssertionError(f"flash launched {launches} for "
                             f"{cfg.n_layers} layers × {waves} waves")
    if out["served"] != 8 or out["tokens"] != 8 * 16:
        raise AssertionError(f"served {out['served']}, {out['tokens']} "
                             f"tokens")
    hist = out["history"]
    emit("lm_example", config=out["config"],
         param_count=out["param_count"], steps=LM_STEPS,
         loss_first=hist[0]["loss"], loss_last=hist[-1]["loss"],
         tok_per_s=hist[-1]["tok_per_s"], version=out["version"],
         served=out["served"], tokens=out["tokens"], waves=waves,
         prefill_ms=[w["prefill_s"] * 1e3 for w in out["waves"]],
         decode_ms_mean=[1e3 * statistics.mean(w["decode_s"])
                         for w in out["waves"]],
         wall_s=wall, launches=launches,
         flash_checked_vs_plain=launches["flash_attention"],
         flash_max_abs_err=worst,
         flash_shapes=sorted(map(list, shapes), key=str))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    # first, before anything touches CUDA: the sharded DES forks
    des_sharded()
    import repro_torch.core as core
    import repro_torch.cost as cost
    import repro_torch.ml as ml
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kmeans as kk
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels import ssd
    from repro_torch.launch import train as TL
    from repro_torch.models import transformer as T
    import repro_torch.serve as serve
    from repro_torch.train import step as TS

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
    checks = [(shape, 0) for shape in CHECK_SHAPES] + [
        (shape, 1) for shape in CHECK_MISALIGNED]
    for (n, f, k), offset in checks:
        for precision in PRECISIONS:
            row = check_kernel(torch, kk, n, f, k, precision, device, offset)
            emit("check", **row)
            for name in worst:
                worst[name] = max(worst[name], row["dmin_max_abs_err"])

    timings = time_kernels(torch, kk, ops, device)
    launches = run_pipeline(torch, core, ml, kk, device)
    check_against_plain_path(torch, core, ml, device)
    quickstart_example(torch, core, ml, kk, device)
    geo_example(torch, kk, device)
    autotune(torch, kk, device)

    worst["flash_attention"] = check_flash(torch, fa, tref, device)
    worst["ssd_chunk_scan"] = check_ssd(torch, ssd, tref, device)
    timings += time_attention_ssd(torch, fa, ssd, device)
    params, cfg, prompts, done, captured, serve_launches = serve_hymba(
        torch, serve, T, fa, ssd, device)
    launches.update(serve_launches)
    serve_vs_plain(torch, serve, fa, ssd, params, cfg, prompts, done,
                   captured, device)
    del params, captured

    # the paper's other two workloads, the advisor and its full scenario
    advise(core, cost)
    run_ae_pipeline(torch, core, ml, device)
    ae_vs_host(torch, core, ml, device)
    run_iforest_pipeline(torch, core, ml, device)
    iforest_vs_host(torch, ml, device)
    outlier_example(torch, kk, device)
    calibrate(torch, kk, device)
    lm_example(torch, fa, device)

    # training: internlm2-1.8b at full width, card against host, resume,
    # int8 compression on an NCCL group (no hand-written kernel: the
    # reference trains with impl="dense", and its Pallas kernels have no
    # gradient)
    train_full(torch, TL, TS, T, device)
    train_vs_host(torch, TS, T, device)
    train_resume(torch, TL, TS, device)
    int8_pod(torch, TS, device)

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
            "bound_by": main_row["bound_by"], "library_ms": None,
            "block_n": kk.DEFAULT_BLOCK_N})
    for name, source, replaces, main in (
            ("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:120", FLASH_MAIN[-1]),
            ("ssd_chunk_scan", "src/repro_torch/kernels/csrc/ssd.cu",
             "src/repro/kernels/ssd.py:92", SSD_MAIN[-1])):
        main_row = next(r for r in timings if r["kernel"] == name
                        and tuple(r["case"]) == main
                        and r["dtype"] == "fp32")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": main_row["kernel_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "library_backend": main_row.get("library_backend")})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
