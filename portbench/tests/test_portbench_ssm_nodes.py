"""The reader of ``decode.ssm_nodes``: the decode graph's kernel nodes
inside the ``mixer.ssm`` regions, taken from the last wave that recorded
any; nothing from a program whose graph has no such region, and nothing
from a record without waves.  Its module agrees with its entry in
``BENCHMARK.json``."""
import json

import pytest

from portbench import harness

NAME = "decode.ssm_nodes"
SPANS = {"moe.route": 100, "moe.experts": 50, "moe.shared": 7,
         "mixer.ssm": 900}


def read(rec):
    return harness.load_metric(NAME).read(rec, None)


@pytest.mark.parametrize("rec, want", [
    ({"waves": [{"graph_span_nodes": SPANS}]}, 900),
    # the last wave with a graph counts; a wave without one is passed over
    ({"waves": [{"graph_span_nodes": dict(SPANS, **{"mixer.ssm": 1188})},
                {"graph_span_nodes": SPANS}, {"batch": 4}]}, 900),
    # a graph without the region, as a program whose SSM step has none
    ({"waves": [{"graph_span_nodes": {"mixer.attn": 9}}]}, None),
    ({"waves": [{"graph_span_nodes": {}}]}, None),
    ({"waves": []}, None),
    ({}, None),
], ids=["one-wave", "last-graph", "no-region", "empty-graph", "no-waves",
        "empty-record"])
def test_the_reader_counts_the_ssm_regions_nodes(rec, want):
    assert read(rec) == want


def test_the_reader_agrees_with_its_entry():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry, = [m for m in bench["per_layer"] if m["name"] == NAME]
    mod = harness.load_metric(NAME)
    assert (entry["unit"], entry["layer"], entry["moves"], entry["source"]) \
        == (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE)
    assert entry["workloads"] == mod.WORKLOADS
    cells = {w["name"] for w in bench["workloads"]}
    assert set(mod.WORKLOADS) <= cells
