"""Time a decode step: the waves' ``decode_s`` (the step's call to its
tokens on the host) over their steps, over the window."""
UNIT = "ms"
LAYER = "decode graph"
MOVES = "gen_tokens_per_s"
SOURCE = "program_span"
WORKLOADS = ["hymba-1.5b.decode_heavy"]


def read(rec, trace):
    steps = [s for w in rec.get("waves", ()) for s in w["decode_s"]]
    if not steps:
        return None
    return sum(steps) / len(steps) * 1e3
