"""The program's own spans over runs of a cell, one process a call:

    python3 portbench/spans.py --workload <cell> --seeds 1,2 \
        --seconds 30 --spans 1 --trace 1 [--out FILE]

For each seed, one run of the cell as ``run.py`` makes it, with the
program's spans (``repro_torch.spans.REGISTRY``) on from before
set-up where ``--spans 1``.  The registry's snapshots are taken where the
run's set-up starts, where its window opens, and where its traced span
begins (or, untraced, where the window closes): the first two bound the
set-up's spans, the last two the window's (``spans_between``), over the
same part of the run as the cell's other per-layer metrics; a traced
run's spans from its traced span's start to the window's close are kept
apart, since the profiler slows what they time.  From them,
three readings: ``decode.host_ms`` (a decode step's ``serve.decode``
less its ``serve.decode.tokens``, the host's work that the card waits
for), ``train.call_ms`` (``train.step``, a step) and ``setup.graphs_s``
(``graphs.warm``, ``graphs.capture`` and ``graphs.nodes`` in set-up, less
the ``kernels.library`` loads inside them).

With ``--trace 1`` the traced span is reduced once more with the program's
``record_function`` ranges beside the benchmark's: the device events of
both prefixes are left out of the busy time (kineto also emits each range
as a device-side annotation), and every idle gap is labelled by the
innermost range of either that holds its midpoint; the idle seconds are
summed by label.  ``tracing.TraceSummary``'s busy time over the same
events is printed beside it.  Each run also prints what one span costs
the host, off and on.  With ``--events 1`` every CUDA graph replay is
timed on the device with CUDA events (``graph_ms``: from the replay's
call to the end of its last node), over the window before the traced
span.

One JSON line a run, on standard output and appended to ``--out``.  It is
not part of a benchmark run.

It reaches into the harness's private parts, and a change there breaks it
without a test failing: it swaps ``harness.Run.open_window``,
``harness.Run.close_window`` and ``tracing.Tracer.tick`` for versions
that take the snapshots, and reads ``tracing._events``, ``tracing.PREFIX``
and ``tracing.TRACED``.  It stands in until the benchmark reads the
spans itself: then :func:`readings` becomes the three metric readers,
:func:`traced`'s prefix filter and labels go into
``tracing.TraceSummary``, and this file and its test go.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the graph layer's spans that set-up runs, outermost first
SETUP_SPANS = ("graphs.warm", "graphs.capture", "graphs.nodes")


@contextlib.contextmanager
def marked(marks: dict, registry, replays=None):
    """Takes ``registry``'s snapshot under ``marks["open"]`` as a run's
    window opens, ``marks["cut"]`` where its traced span begins, or as
    the window closes where nothing was traced, and ``marks["end"]`` as
    it closes; with ``replays`` (a list), the number of graph replays
    :func:`timed_replays` has appended to it at each mark."""
    from portbench import harness, tracing
    open_window, close_window = harness.Run.open_window, \
        harness.Run.close_window
    tick = tracing.Tracer.tick

    def mark(name):
        marks[name] = registry.snapshot()
        if replays is not None:
            marks[name + "_replays"] = len(replays)

    def opened(run):
        t = open_window(run)
        mark("open")
        return t

    def ticked(tracer):
        tick(tracer)
        if tracer.synced is not None and "cut" not in marks:
            mark("cut")

    def closed(run):
        if "cut" not in marks:
            mark("cut")
        mark("end")
        close_window(run)

    harness.Run.open_window, harness.Run.close_window = opened, closed
    tracing.Tracer.tick = ticked
    try:
        yield
    finally:
        harness.Run.open_window, harness.Run.close_window = (open_window,
                                                             close_window)
        tracing.Tracer.tick = tick


@contextlib.contextmanager
def timed_replays(replays: list):
    """Every ``torch.cuda.CUDAGraph.replay`` bracketed by two CUDA events
    on the current stream, the pair appended to ``replays``."""
    import torch
    replay = torch.cuda.CUDAGraph.replay

    def timed(graph):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        replay(graph)
        b.record()
        replays.append((a, b))

    torch.cuda.CUDAGraph.replay = timed
    try:
        yield
    finally:
        torch.cuda.CUDAGraph.replay = replay


def readings(setup: dict, window: dict) -> dict:
    """The three span readings, each None where its spans are missing."""
    out = {"decode.host_ms": None, "train.call_ms": None,
           "setup.graphs_s": None}
    step = window.get("serve.decode")
    if step:
        tokens = window.get("serve.decode.tokens", {"total_s": 0.0})
        out["decode.host_ms"] = 1e3 * (step["total_s"] - tokens[
            "total_s"]) / step["count"]
    if window.get("train.step"):
        s = window["train.step"]
        out["train.call_ms"] = 1e3 * s["total_s"] / s["count"]
    graphs = [setup[n]["total_s"] for n in SETUP_SPANS if n in setup]
    if graphs:
        lib = setup.get("kernels.library")
        inside = lib is not None and all(
            p in SETUP_SPANS for p in lib["parents"])
        out["setup.graphs_s"] = sum(graphs) - (lib["total_s"] if inside
                                               else 0.0)
    return out


def traced(prof) -> dict:
    """The traced span reduced with the program's ranges (module
    docstring)."""
    from portbench import tracing
    from portbench import yardstick as Y
    from repro_torch.core.monitoring import RANGE_PREFIX
    prefixes = (tracing.PREFIX, RANGE_PREFIX)
    events = tracing._events(prof)
    host = [(n, a, b) for n, dev, a, b in events
            if not dev and n.startswith(prefixes)]
    lo, hi = next((a, b) for n, a, b in host if n == tracing.TRACED)
    device = [(a, b) for n, dev, a, b in events
              if dev and not n.startswith(prefixes)]
    busy, gaps = Y.union_busy(device, lo, hi)
    without = [e for e in events if not e[0].startswith(RANGE_PREFIX)]
    ranges = [(n, a, b) for n, a, b in host if n != tracing.TRACED]

    def label(a, b, pick):
        mid = 0.5 * (a + b)
        inside = [(rb - ra, n) for n, ra, rb in ranges
                  if ra <= mid < rb and n.startswith(pick)]
        return min(inside)[1] if inside else "outside the ranges"

    idle: dict = {}
    for a, b in gaps:
        name = label(a, b, prefixes)
        idle[name] = idle.get(name, 0.0) + (b - a)
    return {"window_s": hi - lo, "busy_s": busy,
            "device_idle": 100.0 * (1.0 - busy / (hi - lo)),
            "busy_s_program_ranges_taken_out": Y.union_busy(
                [(a, b) for n, dev, a, b in without
                 if dev and not n.startswith(tracing.PREFIX)], lo, hi)[0],
            "busy_s_trace_summary": tracing.TraceSummary(prof).busy_s,
            "idle_gaps": [[label(a, b, prefixes),
                           label(a, b, tracing.PREFIX), b - a]
                          for a, b in gaps[:10]],
            "idle_s_by_label": dict(sorted(idle.items(),
                                           key=lambda kv: -kv[1])),
            "gaps": len(gaps)}


def span_cost_ns(n: int = 200_000) -> dict:
    """The host's nanoseconds a ``with registry.span(...)`` block costs,
    spans off and on (a private registry, no profiler running)."""
    from repro_torch.core.monitoring import MetricsRegistry
    out = {}
    for on in (False, True):
        reg = MetricsRegistry()
        reg.spans_on = on
        t = time.perf_counter()
        for _ in range(n):
            with reg.span("cost"):
                pass
        out["on" if on else "off"] = (time.perf_counter() - t) / n * 1e9
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--events", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    import torch
    from portbench import harness
    from repro_torch.core import monitoring
    from repro_torch.core.monitoring import spans_between
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    registry = monitoring.REGISTRY
    registry.spans_on = bool(args.spans)
    cell = harness.load_cell(args.workload)
    t_start = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        marks, replays = {"start": registry.snapshot()}, []
        timing = timed_replays(replays) if args.events else \
            contextlib.nullcontext()
        with marked(marks, registry, replays), timing:
            run = harness.run_cell(cell, seed, args.seconds,
                                   bool(args.trace), torch.device("cuda:0"),
                                   t_start=t_start)
        t_start = None
        setup = spans_between(marks["start"], marks["open"])
        window = spans_between(marks["open"], marks["cut"])
        layer = {m["name"]: harness.load_metric(m["name"]).read(
            run.record, None) for m in cell.per_layer}
        line = {"cell": cell.name, "seed": seed, "spans": args.spans,
                "trace": args.trace, "correct": run.correct,
                "e2e": dict(run.e2e, setup_s=run.setup_s),
                "per_layer": {k: v for k, v in layer.items()
                              if v is not None},
                "readings": readings(setup, window),
                "setup_spans": _brief(setup), "window_spans": _brief(window),
                "traced_spans": _brief(spans_between(marks["cut"],
                                                     marks["end"])),
                "span_cost_ns": span_cost_ns(),
                "device": torch.cuda.get_device_name(0)}
        if args.trace and run.tracer.prof is not None:
            line["traced"] = traced(run.tracer.prof)
        if args.events:
            torch.cuda.synchronize()
            ms = sorted(a.elapsed_time(b) for a, b in replays[
                marks["open_replays"]:marks["cut_replays"]])
            line["graph_ms"] = {"count": len(ms),
                                "mean": sum(ms) / len(ms) if ms else None,
                                "p50": ms[len(ms) // 2] if ms else None,
                                "p95": ms[int(0.95 * len(ms))] if ms
                                else None}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del run
    return 0


def _brief(spans: dict) -> dict:
    """Each span's count, total and self seconds, mean, p50 and p95 ms."""
    return {n: {"count": s["count"], "total_s": s["total_s"],
                "self_s": s["self_s"], "mean_ms": 1e3 * s["mean_s"],
                "p50_ms": 1e3 * s["p50_s"], "p95_ms": 1e3 * s["p95_s"],
                "parents": {str(p): c for p, c in s["parents"].items()}}
            for n, s in sorted(spans.items())}


if __name__ == "__main__":
    sys.exit(main())
