"""The decode step's share of the card's memory bandwidth: the bytes the
window's steps must read (``yardstick.decode_bytes``: the weights once,
the cache as filled) over their ``decode_s`` times 3.35 TB/s, in
percent."""
from portbench import yardstick as Y

UNIT = "%"
LAYER = "model step"
MOVES = "gen_tokens_per_s"
SOURCE = "program_span"
WORKLOADS = ["hymba-1.5b.decode_heavy"]


def read(rec, trace):
    waves = rec.get("waves", ())
    nbytes = sum(Y.decode_bytes(rec["cfg"], w["batch"], w["prompt_len"] + k)
                 for w in waves for k in range(len(w["decode_s"])))
    seconds = sum(s for w in waves for s in w["decode_s"])
    if not seconds:
        return None
    return 100.0 * nbytes / (seconds * Y.HBM_BYTES_PER_S)
