"""The decode graph's kernel nodes inside the Mamba2 recurrence: those the
capture gained inside the program's ``mixer.ssm`` regions, over all layers
(``BatchServer.waves``' ``graph_span_nodes``, read from the capturing
graph).  A program without such regions reports nothing."""
UNIT = "count"
LAYER = "decode graph"
MOVES = "gen_tokens_per_s"
SOURCE = "program_counter"
WORKLOADS = ["granite-4.0-h-small.batch_decode", "hymba-1.5b.decode_heavy"]


def read(rec, trace):
    spans = [w["graph_span_nodes"] for w in rec.get("waves", ())
             if w.get("graph_span_nodes")]
    if not spans:
        return None
    return spans[-1].get("mixer.ssm")
