"""The train step's share of the card's float32 peak: the model's work a
step (``yardstick.train_flops``) times the window's steps, over the
window's seconds times 67 TFLOP/s, in percent."""
from portbench import yardstick as Y

UNIT = "%"
LAYER = "model step"
MOVES = "train_tokens_per_s"
SOURCE = "host_clock"
WORKLOADS = ["internlm2-1.8b.train_4x1k"]


def read(rec, trace):
    if not rec.get("steps"):
        return None
    work = Y.train_flops(rec["cfg"], rec["batch"], rec["seq"]) * rec["steps"]
    return 100.0 * work / (rec["window_s"] * Y.PEAK_FLOPS["fp32"])
