"""The device's idle share over the traced span at the end of the
window (train steps): one less the union of the device's spans over the
span's length, in percent."""
UNIT = "%"
LAYER = "device"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"
WORKLOADS = ["internlm2-1.8b.train_4x1k"]


def read(rec, trace):
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
