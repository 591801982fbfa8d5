"""The port's spans (``repro_torch.spans``, re-exported by
``core.monitoring``): count, total, self time and parent by name, a
thread-local nesting, nothing recorded while they are off,
``record_function`` ranges only while the torch profiler runs, a leaf
that loads neither torch nor ``repro_torch.core``; and the spans and
counters the LM stack records into the process-wide table on the host
(the server's waves and decode steps, the train step, a kernel library's
first load, the graph caches' evictions).  Imports torch only.

    PYTHONPATH=src python -m pytest -q tests/test_torch_spans.py
"""
import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import monitoring
from repro_torch.core.monitoring import (RANGE_PREFIX, REGISTRY,
                                         LatencySketch, MetricsRegistry,
                                         spans_between)
from repro_torch.graphs import GraphFn
from repro_torch.models import transformer as TT
from repro_torch.serve import BatchServer, Request
from repro_torch.serve.engine import make_decode_fn, make_prefill_fn


class Ticks:
    """A clock read by hand: ``now()`` returns ``t``."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _on(clock=None) -> MetricsRegistry:
    reg = MetricsRegistry(clock=clock)
    reg.spans_on = True
    return reg


@pytest.fixture
def spans_on(monkeypatch):
    """The process-wide table, its spans on for the test."""
    monkeypatch.setattr(REGISTRY, "spans_on", True)
    return REGISTRY


def test_spans_count_total_self_time_and_parent():
    """outer [0, 10] holds inner [2, 5] and inner [6, 7]: outer's self
    time is 10 less the 4 s its children cover; each inner has outer for
    parent, and outer none."""
    tick = Ticks()
    reg = _on(tick)
    with reg.span("outer"):
        for start, end in ((2.0, 5.0), (6.0, 7.0)):
            tick.t = start
            with reg.span("inner"):
                tick.t = end
        tick.t = 10.0
    snap = reg.snapshot()
    assert snap["outer"]["count"] == 1
    assert snap["outer"]["total_s"] == 10.0
    assert snap["outer"]["self_s"] == 6.0
    assert snap["outer"]["parents"] == {None: 1}
    assert snap["inner"]["count"] == 2
    assert snap["inner"]["total_s"] == snap["inner"]["self_s"] == 4.0
    assert snap["inner"]["parents"] == {"outer": 2}
    sk = LatencySketch.from_state(snap["inner"]["sketch"])
    assert (sk.count, sk.min, sk.max) == (2, 1.0, 3.0)


def test_spans_nest_per_thread():
    """Two threads hold their spans open at once: each span's parent is
    the span open around it on its own thread, never the other
    thread's."""
    reg = _on()
    together = threading.Barrier(2, timeout=10)

    def worker(name):
        with reg.span(name):
            together.wait()
            with reg.span(name + ".child"):
                together.wait()

    threads = [threading.Thread(target=worker, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
        assert not t.is_alive()
    snap = reg.snapshot()
    assert {n: s["parents"] for n, s in snap.items()} == {
        "a": {None: 1}, "b": {None: 1}, "a.child": {"a": 1},
        "b.child": {"b": 1}}


class _Refuse:
    """A lock or clock that fails the test if it is used."""

    def __enter__(self):
        raise AssertionError("the registry locked for a span")

    def __exit__(self, *exc):
        return False

    def __call__(self):
        raise AssertionError("the registry read its clock for a span")


def test_spans_off_record_nothing():
    """Off (the default, the process-wide registry included), a span is
    one shared no-op: no clock read, no lock, nothing kept."""
    reg = MetricsRegistry(clock=_Refuse())
    reg._lock = _Refuse()
    assert not reg.spans_on and not monitoring.REGISTRY.spans_on
    assert reg.span("a") is reg.span("b")
    with reg.span("a"):
        with reg.span("b"):
            pass
    reg._lock = threading.Lock()
    assert reg.snapshot() == {}


def test_spans_open_ranges_only_while_the_profiler_runs(monkeypatch):
    """With spans on, each span is a ``record_function`` range under the
    program's prefix in a CPU profiler trace; outside the profiler no
    range is opened at all."""
    opened = []
    record_function = torch.autograd.profiler.record_function

    def counted(name):
        opened.append(name)
        return record_function(name)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    reg = _on()
    with reg.span("before"):
        pass
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with reg.span("outer"):
            with reg.span("inner"):
                torch.ones(4).sum()
    with reg.span("after"):
        pass
    assert opened == [RANGE_PREFIX + "outer", RANGE_PREFIX + "inner"]
    names = {e.name for e in prof.events()}
    assert {RANGE_PREFIX + "outer", RANGE_PREFIX + "inner"} <= names
    assert not {RANGE_PREFIX + "before", RANGE_PREFIX + "after"} & names
    assert reg.snapshot()["after"]["count"] == 1


def test_spans_module_is_a_leaf():
    """The spans' module loads neither torch nor anything of the package,
    and the kernel loader and the graph functions record into its table
    without loading ``repro_torch.core``; ``core.monitoring`` re-exports
    the one table."""
    code = ("import sys; import repro_torch.spans; "
            "print(sorted(m for m in sys.modules if m == 'torch' or "
            "m.startswith('repro_torch'))); "
            "import repro_torch.graphs, repro_torch.kernels.build; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.core')))")
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=src)).stdout
    assert out.split("\n")[:2] == ["['repro_torch', 'repro_torch.spans']",
                                   "[]"]
    assert monitoring.REGISTRY is sys.modules["repro_torch.spans"].REGISTRY


def test_spans_between_two_snapshots_is_the_work_between():
    """The difference of two snapshots counts only the spans that ended
    between them, with their self time and their distribution's
    buckets."""
    tick = Ticks()
    reg = _on(tick)

    def step(seconds, inner):
        t0 = tick.t
        with reg.span("step"):
            tick.t = t0 + inner
            with reg.span("step.inner"):
                tick.t = t0 + 2 * inner
            tick.t = t0 + seconds

    for _ in range(3):
        step(1.0, 0.25)
    before = reg.snapshot()
    for _ in range(2):
        step(0.01, 0.002)
    got = spans_between(before, reg.snapshot())
    assert got["step"]["count"] == 2
    assert got["step"]["total_s"] == pytest.approx(0.02)
    assert got["step"]["self_s"] == pytest.approx(0.016)
    assert got["step"]["mean_s"] == pytest.approx(0.01)
    assert got["step"]["p95_s"] == pytest.approx(0.01, rel=0.04)
    assert got["step"]["max_s"] == pytest.approx(0.01, rel=0.04)
    assert got["step.inner"]["parents"] == {"step": 2}
    assert spans_between(reg.snapshot(), reg.snapshot()) == {}


@pytest.fixture(scope="module")
def tiny_lm():
    cfg = get_arch("internlm2-1.8b").reduced()
    return cfg, TT.init_params(cfg, device="cpu", seed=4)


def test_batch_server_records_a_decode_span_a_step(tiny_lm, spans_on):
    """A host server's waves: one ``serve.wave`` each, one
    ``serve.decode`` a decode step inside it holding one of each of its
    four children, and each wave's ``serve.decode`` spans cover at least
    its ``decode_s``; the wave records its start, which stamps its
    requests between their submission and their first token."""
    cfg, params = tiny_lm
    reg = spans_on
    server = BatchServer(params, cfg, n_slots=2, max_len=24, device="cpu")
    per_wave, serve_wave = [], server._serve_wave

    def wave_hook(wave):
        before = reg.snapshot()
        serve_wave(wave)
        per_wave.append(spans_between(before, reg.snapshot()))

    server._serve_wave = wave_hook
    rng = np.random.default_rng(2)
    reqs = [server.submit(Request(
        request_id=f"r{i}", prompt=rng.integers(
            1, cfg.vocab_size, n).astype(np.int32), max_new_tokens=5))
        for i, n in enumerate((6, 6, 9))]
    server.run(max_requests=3, idle_timeout_s=0.5)
    assert len(per_wave) == len(server.waves) == 2
    children = ("serve.decode.inputs", "serve.decode.call",
                "serve.decode.tokens", "serve.decode.deliver")
    for spans, stats in zip(per_wave, server.waves):
        steps = len(stats["decode_s"])
        assert steps == 4
        assert spans["serve.wave"]["parents"] == {None: 1}
        assert spans["serve.decode"]["parents"] == {"serve.wave": steps}
        for name in children:
            assert spans[name]["parents"] == {"serve.decode": steps}, name
        assert spans["serve.decode"]["total_s"] >= sum(stats["decode_s"])
        assert spans["serve.decode"]["self_s"] >= 0.0
        assert not [n for n in spans if n.startswith("graphs.")]
    for r in reqs:
        stats = server.waves[0 if r.request_id != "r2" else 1]
        assert r.t_submit <= r.t_wave == stats["start"]
        assert r.t_wave <= r.t_first_token <= r.t_done


def test_train_fn_call_is_a_train_step_span(tiny_lm, spans_on):
    """A train step's call is one ``train.step`` span; on the host it is
    the eager step, so nothing of the graph's runs inside it."""
    from repro_torch.train import step as TS
    cfg, _ = tiny_lm
    tc = TS.TrainConfig()
    params = TT.init_params(cfg, device="cpu", seed=5)
    state = TS.init_state(cfg, tc, params)
    fn = TS.make_train_fn(cfg, tc)
    ids = torch.randint(0, cfg.vocab_size, (1, 9))
    before = spans_on.snapshot()
    fn(params, state, {"tokens": ids[:, :-1], "labels": ids[:, 1:]})
    got = spans_between(before, spans_on.snapshot())
    assert set(got) == {"train.step"}
    assert got["train.step"]["count"] == 1


def test_kernel_library_first_load_is_a_span(monkeypatch, tmp_path,
                                             spans_on):
    """A library's first load (its build, where there is none) is the
    span ``kernels.library`` of the process-wide table; a loaded library
    is returned without one."""
    from repro_torch.kernels import build
    lib = tmp_path / "libfake.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(build, "_target", lambda src: lib)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: SimpleNamespace(
        path=path))
    monkeypatch.setattr(build, "_libs", {})
    before = spans_on.snapshot()
    first = build.library("fake")
    assert build.library("fake") is first
    got = spans_between(before, spans_on.snapshot())
    assert got["kernels.library"]["count"] == 1


def _stub(fn, key, params=None):
    fn.graphs[key] = SimpleNamespace(params=params)


@pytest.mark.parametrize("make", ["graph_fn", "prefill", "decode"])
def test_graph_caches_count_their_evictions(make, tiny_lm):
    """``_make_room`` counts each graph it drops for room, with stand-ins
    for the graphs; a graph dropped with its params tree is no
    eviction."""
    cfg, _ = tiny_lm
    fn = {"graph_fn": lambda: GraphFn(lambda x: x, limit=3),
          "prefill": lambda: make_prefill_fn(cfg, 16, impl="kernel"),
          "decode": lambda: make_decode_fn(cfg)}[make]()
    tree = {"w": torch.zeros(1)}
    for key in range(fn.limit):
        fn._make_room()
        _stub(fn, key, tree)
    assert fn.evictions == 0
    fn._make_room()
    _stub(fn, "new", tree)
    fn._make_room()
    assert fn.evictions == 2 and len(fn.graphs) == fn.limit - 1
    if make != "graph_fn":
        fn._keep_params({"w": torch.ones(1)})
        assert fn.graphs == {} and fn.evictions == 2
