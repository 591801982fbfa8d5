"""How full the expert layer's rows are in decode: the (token, held
expert) pairs the router sent to the experts this card holds, over the
expert rows the layer computed, summed over the decode steps of each wave
that ran to its end, in percent.  The pairs are the program's counter
(``BatchServer.waves``' ``moe_routed``, counted on the device); the rows
are counted from the configuration file: every layer's held experts ×
its capacity, which under dropless routing is the step's tokens (the
wave's ``batch``).  A configuration that drops tokens reads nothing."""
UNIT = "%"
LAYER = "expert layer"
MOVES = "gen_tokens_per_s"
SOURCE = "program_counter"
WORKLOADS = ["granite-4.0-h-small.batch_decode"]


def read(rec, trace):
    m = rec.get("cfg", {}).get("moe")
    if not m or not m.get("dropless"):
        return None
    held = m.get("experts_held") or m["n_experts"]
    waves = [w for w in rec.get("waves", ()) if "moe_routed" in w]
    rows = sum(len(w["decode_s"]) * rec["cfg"]["n_layers"] * held
               * w["batch"] for w in waves)
    if not rows:
        return None
    return 100.0 * sum(w["moe_routed"] for w in waves) / rows
