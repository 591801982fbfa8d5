"""Finds a cell's files by name, runs it once, and assembles its result.

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric is a file of its own under ``portbench/``:

* ``configs/<config>.json`` — the configuration as it is run;
* ``reference/<module>.py`` — its plain reference, named by the
  configuration's ``reference`` key (the contract of such a module is in
  ``reference/__init__.py``);
* ``traffic/<traffic>.json`` — the traffic mix: its ``kind`` and the
  parameters that kind's generator reads;
* ``kinds/<kind>.py`` — a generator, and the loop that feeds the
  program, shared by every mix of that kind (``backlog``,
  ``train_steps``);
* ``workloads/<cell>.json`` — the cell: its configuration, its traffic,
  and what decides ``correct`` (the sample and each number's limit);
* ``metrics/<metric>.py`` — one per-layer metric's reader.

``BENCHMARK.json`` at the root of the checkout says which end-to-end and
per-layer metrics each cell reports.  A configuration, a cell, a mix or a
metric is added by adding files and entries; no file here names one.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path
    reference: Any


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_dir: Path = BENCH,
              spec: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``spec`` (``BENCHMARK.json`` by default) with
    its files under ``bench_dir``."""
    if spec is None:
        spec = load_json(bench_dir.parent / "BENCHMARK.json")
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    cell = load_json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{cell[key]!r}, BENCHMARK.json {entry[key]!r}")
    config = load_json(bench_dir / "configs" / f"{entry['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    return Cell(name=name, chips=entry["chips"], config=config,
                traffic=traffic, check=cell["check"],
                end_to_end=[m for m in spec["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
                bench_dir=bench_dir,
                reference=load_reference(config["reference"], bench_dir))


def load_reference(name: str, bench_dir: Path = BENCH):
    """The plain reference module ``reference/<name>.py``, as
    ``portbench.reference.<name>``.  The package's own file is imported
    as usual, so every importer shares that one module; a file of another
    directory (a copy of the benchmark) is loaded from its path."""
    path = bench_dir / "reference" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"the configuration's reference {name!r} "
                                f"has no file {path}")
    mod_name = f"portbench.reference.{name}"
    if path.resolve() == (BENCH / "reference" / f"{name}.py").resolve():
        return importlib.import_module(mod_name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, bench_dir: Path = BENCH):
    """The reader module ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(kind: str):
    return importlib.import_module(f"portbench.kinds.{kind}")


def _plain(value):
    """``value`` as a configuration file states it: a dataclass as a
    dict, a tuple as a list."""
    if dataclasses.is_dataclass(value):
        value = dataclasses.asdict(value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return [_plain(v) for v in value]
    return value


def port_arch(config: dict):
    """The port's configuration that ``config`` runs, checked against the
    file: a size that differs raises.  Besides the fixed list below, every
    field of the port's ``ArchConfig`` that the file gives under the
    field's own name is compared (nested dataclasses as dicts, tuples as
    lists), and a port configuration with ``moe`` or ``mla`` needs the
    file to state it.  The file's ``name`` is the benchmark's and is not
    compared: ``port_arch`` names the port's."""
    from repro_torch.configs import get_arch
    arch = get_arch(config["port_arch"])
    want = {"n_layers": arch.n_layers, "d_model": arch.d_model,
            "n_heads": arch.n_heads, "n_kv_heads": arch.n_kv_heads,
            "d_head": arch.head_dim, "d_ff": arch.d_ff,
            "ffn_kind": arch.ffn_kind, "vocab_size": arch.vocab_size,
            "padded_vocab_size": arch.padded_vocab_size,
            "block": arch.attn_kind, "rope_theta": arch.rope_theta,
            "norm_eps": arch.norm_eps,
            "sliding_window": arch.sliding_window,
            "tie_embeddings": arch.tie_embeddings}
    if arch.ssm is not None:
        want["ssm"] = dataclasses.asdict(arch.ssm)
    for field in dataclasses.fields(arch):
        key, value = field.name, getattr(arch, field.name)
        stated = key in config or (key in ("moe", "mla") and value is not None)
        if stated and key not in want and key != "name":
            want[key] = _plain(value)
    for key, value in want.items():
        if config.get(key) != value:
            raise ValueError(f"{config['name']}: {key} is {config.get(key)!r} "
                             f"in the file, {value!r} in the port")
    return arch


class Run:
    """One run of a cell: what the kind measured, for the result line.

    A kind calls :meth:`open_window` when set-up ends and the measured
    window starts, and :meth:`close_window` when the window has closed,
    before it frees the program's state and runs the reference."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float, arch=None, control: bool = False):
        from portbench.tracing import Tracer
        self.cell = cell
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.arch = arch if arch is not None else port_arch(cell.config)
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = t_start
        self.control = control
        self.tracer = Tracer(trace, cell.traffic.get("trace_s", 2.0),
                             sync=self.sync)
        self.setup_s: Optional[float] = None
        self.memory_peak = 0
        self.e2e: Dict[str, float] = {}
        self.record: Dict[str, Any] = {}
        self.attempted = 0
        self.failed = 0
        self.checks: Dict[str, Dict[str, float]] = {}
        self.readings: Dict[str, float] = {}

    def rng(self, stream: str):
        """A ``numpy`` generator drawn from the run's seed and the name of
        a stream, so that each stream repeats for a seed."""
        import numpy as np
        return np.random.default_rng([self.seed, *stream.encode()])

    def log(self, msg: str) -> None:
        print(f"[{self.cell.name}] {msg}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open_window(self) -> float:
        import torch
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        now = time.monotonic()
        self.setup_s = now - self.t_start
        self.tracer.arm(now + max(self.seconds - self.tracer.length, 0.0))
        self.log(f"setup_s {self.setup_s!r}")
        return now

    def close_window(self) -> None:
        import torch
        self.tracer.stop()
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_reserved(self.device)

    def compare(self, name: str, value: float) -> None:
        """A number that decides ``correct``, held to its limit in the
        cell's file (``check.limits``)."""
        self.checks[name] = {"value": value,
                             "limit": self.cell.check["limits"][name]}

    def free(self) -> None:
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] <= c["limit"] for c in self.checks.values())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None, arch=None,
             control: bool = False) -> Run:
    """Sets up, measures and checks ``cell`` once on ``device``."""
    import torch
    from repro_torch.models import transformer as T
    from portbench import weights
    precision = cell.config.get("precision", {})
    torch.backends.cuda.matmul.allow_tf32 = precision.get("tf32", False)
    torch.backends.cudnn.allow_tf32 = precision.get("tf32", False)
    run = Run(cell, seed, seconds, trace, device,
              time.monotonic() if t_start is None else t_start, arch=arch,
              control=control)
    layout = T.param_shapes(run.arch, dtype=torch.float32)

    def make_params():
        return weights.make(run.cfg, layout, seed, device)

    load_kind(cell.traffic["kind"]).run(run, make_params)
    run.free()
    return run


def metrics_of(run: Run) -> Dict[str, Dict[str, Any]]:
    """The result's metrics: the cell's end-to-end metrics, or with
    ``--trace 1`` its per-layer metrics, each read by its own reader; a
    reader that finds nothing to read leaves its metric out."""
    out = {}
    if not run.trace:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in run.cell.end_to_end:
            if m["name"] in values:
                out[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        return out
    summary = run.tracer.summary()
    for m in run.cell.per_layer:
        value = load_metric(m["name"], run.cell.bench_dir).read(
            run.record, summary)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that a run must not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def result_of(run: Run, torch) -> dict:
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(
        run.device), "count": 1, "memory_peak_bytes": int(run.memory_peak)}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics_of(run),
           "device": device}
    summary = run.tracer.summary() if run.trace else None
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown
    out["checks"] = run.checks
    return out
