"""The host's time inside the train step's call, a step: the
benchmark's own span around ``step_fn`` (a graph replay's launch), the
mean over the window's steps."""
UNIT = "ms"
LAYER = "train step"
MOVES = "train_tokens_per_s"
SOURCE = "host_clock"
WORKLOADS = ["internlm2-1.8b.train_4x1k"]


def read(rec, trace):
    host = rec.get("host_s")
    if not host:
        return None
    return sum(host) / len(host) * 1e3
