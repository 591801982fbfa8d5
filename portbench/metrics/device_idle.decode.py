"""The device's idle share over the traced span at the end of the
window (decode steps; most of it the gaps between the decode graph's
kernels and the host's work between steps): one less the union of the
device's spans over the span's length, in percent."""
UNIT = "%"
LAYER = "device"
MOVES = "gen_tokens_per_s"
SOURCE = "device_trace"
WORKLOADS = ["hymba-1.5b.decode_heavy"]


def read(rec, trace):
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
