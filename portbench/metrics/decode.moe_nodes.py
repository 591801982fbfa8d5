"""The decode graph's kernel nodes inside the expert layer: those the
capture gained inside the program's ``moe.route``, ``moe.experts`` and
``moe.shared`` regions, over all layers (``BatchServer.waves``'
``graph_span_nodes``, read from the capturing graph)."""
UNIT = "count"
LAYER = "expert layer"
MOVES = "gen_tokens_per_s"
SOURCE = "program_counter"
WORKLOADS = ["granite-4.0-h-small.batch_decode"]


def read(rec, trace):
    spans = [w["graph_span_nodes"] for w in rec.get("waves", ())
             if w.get("graph_span_nodes")]
    if not spans:
        return None
    return sum(n for name, n in spans[-1].items() if name.startswith("moe."))
