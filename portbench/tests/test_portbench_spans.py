"""``spans.py``, the program's spans over a cell's runs: the snapshots it
takes at a tiny run's set-up, window and close on the CPU, the readings
it makes of them, and its reduction of a trace with the program's ranges
beside the benchmark's, on a made-up event list."""
import pytest
import torch

from portbench import harness, spans, tracing
from portbench.tests import tiny

SEED = 2 ** 31 + 7
P, B = "repro_torch.", tracing.PREFIX


@pytest.fixture
def registry(monkeypatch):
    from repro_torch.core import monitoring
    monkeypatch.setattr(monitoring.REGISTRY, "spans_on", True)
    return monitoring.REGISTRY


@pytest.mark.parametrize("name,reading", [
    ("hymba-1.5b.decode_heavy", "decode.host_ms"),
    ("internlm2-1.8b.train_4x1k", "train.call_ms")])
def test_a_run_with_spans_on_gives_its_reading(name, reading, registry):
    """A tiny untraced run on the CPU with the program's spans on: the
    window's spans are those of its steps, and the cell's reading comes
    out positive (the host runs no graph, so ``setup.graphs_s`` has
    nothing to read)."""
    from repro_torch.core.monitoring import spans_between
    cell, arch = tiny.cell(name)
    marks = {"start": registry.snapshot()}
    with spans.marked(marks, registry):
        harness.run_cell(cell, SEED, 1.0, False, torch.device("cpu"),
                         arch=arch)
    window = spans_between(marks["open"], marks["cut"])
    got = spans.readings(spans_between(marks["start"], marks["open"]),
                         window)
    assert got[reading] > 0
    assert got["setup.graphs_s"] is None
    assert not [n for n in window if n.startswith("graphs.")]
    assert harness.Run.open_window.__name__ == "open_window"
    assert tracing.Tracer.tick.__name__ == "tick"


def test_readings_of_set_up_leave_out_the_library_builds():
    s = {"count": 1, "parents": {None: 1}}
    setup = {"graphs.warm": dict(s, total_s=40.0),
             "graphs.capture": dict(s, total_s=1.5),
             "graphs.nodes": dict(s, total_s=0.5),
             "kernels.library": {"count": 2, "total_s": 35.0,
                                 "parents": {"graphs.warm": 2}}}
    window = {"serve.decode": {"count": 4, "total_s": 0.08},
              "serve.decode.tokens": {"count": 4, "total_s": 0.05}}
    got = spans.readings(setup, window)
    assert got["setup.graphs_s"] == pytest.approx(7.0)
    assert got["decode.host_ms"] == pytest.approx(7.5)
    assert got["train.call_ms"] is None


def test_the_trace_with_program_ranges(monkeypatch):
    """Device work at [0, 2] and [6, 8] ms in a traced span [0, 10]:
    the gaps [2, 6] and [8, 10] lie inside the program's innermost ranges
    (a replay inside the benchmark's decode range, the tokens' wait), and
    the device-side annotations of both prefixes are no device work; the
    benchmark's own reduction counts the program's annotation as busy."""
    ms = 1e-3
    events = [
        (B + "traced", False, 0.0, 10 * ms),
        (B + "server.decode", False, 0.0, 7 * ms),
        (P + "graphs.replay", False, 1 * ms, 7 * ms),
        (P + "serve.decode.tokens", False, 7 * ms, 10 * ms),
        ("gemv", True, 0.0, 2 * ms),
        ("gemv", True, 6 * ms, 8 * ms),
        (B + "server.decode", True, 0.0, 8 * ms),
        (P + "graphs.replay", True, 1 * ms, 9 * ms)]
    monkeypatch.setattr(tracing, "_events", lambda prof: events)
    got = spans.traced(object())
    assert got["busy_s"] == pytest.approx(4 * ms)
    assert got["busy_s_program_ranges_taken_out"] == got["busy_s"]
    assert got["busy_s_trace_summary"] == pytest.approx(9 * ms)
    assert got["idle_gaps"] == [
        [P + "graphs.replay", B + "server.decode", pytest.approx(4 * ms)],
        [P + "serve.decode.tokens", "outside the ranges",
         pytest.approx(2 * ms)]]
    assert got["idle_s_by_label"] == {
        P + "graphs.replay": pytest.approx(4 * ms),
        P + "serve.decode.tokens": pytest.approx(2 * ms)}


def test_span_cost_is_measured_off_and_on():
    got = spans.span_cost_ns(1000)
    assert set(got) == {"off", "on"} and got["on"] > got["off"] > 0
