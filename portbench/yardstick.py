"""The benchmark's yardstick: the card's peaks, the work a kernel or a model
step must do, counted from the shapes, and the reduction of a profiler
trace to busy time.  Nothing here reads the program's own counters, so a
change to the program cannot move the yardstick.

The flash and SSD bounds are frozen copies of ``chip_smoke.py``'s
``flash_bound_ms`` and ``ssd_bound_ms``, kept with the model's prefill
work for a cell that runs the prefill kernels (none does yet: see
``PERF.md``); the model counts follow the
configuration file (``portbench/configs/<name>.json``), never the port's
code.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12,      # CUDA cores (a float32 matmul, TF32 off)
              "tf32": 495e12,
              "bf16": 989e12}
ELEM_BYTES = {"fp32": 4, "bf16": 2}


def flash_bound_ms(case, dtype: str) -> Tuple[float, str]:
    """Bytes: q, k, v read once and o written once.  Operations: 4·D flops
    (q·k and p·v) for each (query, key) pair the masks leave open.
    ``case`` is (batch, q length, k length, heads, kv heads, head dim,
    causal, window or None)."""
    b, sq, sk, h, hkv, d, causal, window = case
    e = ELEM_BYTES[dtype]
    nbytes = e * d * (2 * b * sq * h + 2 * b * sk * hkv)
    qpos = np.arange(sq)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, int)
    pairs = int(np.maximum(hi - lo, 0).sum())
    flops = 4.0 * b * h * d * pairs
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def ssd_bound_ms(case, dtype: str) -> Tuple[float, str]:
    """Operations, over the q(q+1)/2 causal (i, j) pairs of each chunk:
    2·ds flops a pair for C·Bᵀ, once for each (batch, B/C group, chunk);
    2·hd a pair for its product with x and 2q·ds·hd for the chunk state,
    for each (batch, head, chunk).  Bytes: x, dt, B and C read once; y,
    the chunk states and cum written once.  ``case`` is (batch, length,
    heads, head dim, groups, d_state, chunk)."""
    b, s, nh, hd, g, ds, q = case
    nc = s // q
    e = ELEM_BYTES[dtype]
    nbytes = (e * (2 * b * s * nh * hd + 2 * b * s * g * ds) + 4 * b * s * nh
              + 4 * b * nh * nc * (ds * hd + q) + 8 * nh)
    pairs = q * (q + 1) / 2
    gram = b * g * nc * 2.0 * ds * pairs
    flops = gram + b * nh * nc * (2.0 * hd * pairs + 2.0 * q * ds * hd)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


# --- the model's work, from the configuration file -------------------------

BLOCKS = ("gqa", "hybrid")


def _hybrid(cfg) -> bool:
    """Whether the block has SSM heads beside its attention; a block the
    counts below do not know raises, so that it is never counted as
    another."""
    if cfg["block"] not in BLOCKS:
        raise ValueError(f"the yardstick counts no block {cfg['block']!r}; "
                         f"known: {BLOCKS}")
    return cfg["block"] == "hybrid"


def ssm_dims(cfg) -> Tuple[int, int, int]:
    """(inner width, SSM heads, conv channels) of a configuration."""
    s = cfg["ssm"]
    d_in = s["expand"] * cfg["d_model"]
    return d_in, d_in // s["head_dim"], d_in + 2 * s["n_groups"] * s["d_state"]


def layer_matmul_params(cfg) -> int:
    """Weights of one block that multiply every token: the projections of
    attention and of the SSM, and the FFN (norms, biases and the SSM's
    per-head scalars are not matmuls)."""
    d, h, kv, hd = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                    cfg["d_head"])
    n = d * h * hd + 2 * d * kv * hd + h * hd * d
    if _hybrid(cfg):
        s = cfg["ssm"]
        d_in, nh, _ = ssm_dims(cfg)
        n += d * (2 * d_in + 2 * s["n_groups"] * s["d_state"] + nh)
        n += d_in * d
    mult = {"swiglu": 3, "gelu": 2, "relu2": 2}[cfg["ffn_kind"]]
    return n + mult * d * cfg["d_ff"]


def head_params(cfg) -> int:
    """The output head over the real vocabulary (the pad columns are
    zeros that no token needs)."""
    return cfg["d_model"] * cfg["vocab_size"]


def attention_pairs(s: int, window: Optional[int]) -> int:
    """(query, key) pairs a causal sequence of ``s`` leaves open."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def ssd_flops(cfg, b: int, s: int) -> float:
    """The SSD scan of one layer as its chunk formula counts it: the
    chunks' own part (``ssd_bound_ms``'s operations) and the inter-chunk
    product C·state, 2·ds·hd a position and head."""
    sc = cfg["ssm"]
    _, nh, _ = ssm_dims(cfg)
    q = min(sc["chunk"], s)
    nc = s // q
    pairs = q * (q + 1) / 2
    intra = b * nc * (sc["n_groups"] * 2.0 * sc["d_state"] * pairs
                      + nh * (2.0 * sc["head_dim"] * pairs
                              + 2.0 * q * sc["d_state"] * sc["head_dim"]))
    inter = 2.0 * b * s * nh * sc["head_dim"] * sc["d_state"]
    return intra + inter


def prefill_flops(cfg, b: int, s: int) -> float:
    """The model's work to prefill ``b`` prompts of ``s`` tokens and give
    the last position's logits: 2 flops a matmul weight a token, the head
    once a prompt, attention's open pairs (4·hd a pair a head), and the
    SSD by its chunk formula."""
    layers = cfg["n_layers"]
    per_layer = 2.0 * layer_matmul_params(cfg) * b * s
    per_layer += 4.0 * cfg["d_head"] * cfg["n_heads"] * b * attention_pairs(
        s, cfg.get("sliding_window"))
    if _hybrid(cfg):
        per_layer += ssd_flops(cfg, b, s)
    return layers * per_layer + 2.0 * head_params(cfg) * b


def train_flops(cfg, b: int, s: int) -> float:
    """The model's work for one train step: 6 flops a matmul weight a
    token (forward, and backward twice), the head included; attention's
    causal QK and PV products, 4·hd a pair a head forward and twice that
    backward.  No remat recompute and no masked pairs are counted."""
    tokens = b * s
    mm = cfg["n_layers"] * layer_matmul_params(cfg) + head_params(cfg)
    attn = 12.0 * cfg["d_head"] * cfg["n_heads"] * b * attention_pairs(
        s, cfg.get("sliding_window")) * cfg["n_layers"]
    return 6.0 * mm * tokens + attn


def decode_bytes(cfg, b: int, length: int) -> float:
    """Bytes one decode step of ``b`` sequences must read, at cache
    position ``length`` (the new token's): every weight once (fp32), of
    the embedding only the ``b`` rows it looks up; the key/value cache as
    filled, ``length + 1`` entries up to the window (bf16); and the SSM's
    state (fp32) and conv window (fp32), read and written."""
    w = 4 * (cfg["n_layers"] * (layer_matmul_params(cfg) + 4 * cfg["d_model"])
             + cfg["d_model"] * cfg["padded_vocab_size"] + b * cfg["d_model"])
    filled = length + 1
    if cfg.get("sliding_window"):
        filled = min(filled, cfg["sliding_window"])
    kv = 2 * 2 * b * filled * cfg["n_kv_heads"] * cfg["d_head"]
    state = 0
    if _hybrid(cfg):
        sc = cfg["ssm"]
        _, nh, conv = ssm_dims(cfg)
        state = 2 * 4 * b * (nh * sc["head_dim"] * sc["d_state"]
                             + (sc["d_conv"] - 1) * conv)
    return float(w + cfg["n_layers"] * (kv + state))


# --- the profiler's trace ---------------------------------------------------


def union_busy(spans: Iterable[Tuple[float, float]], lo: float,
               hi: float) -> Tuple[float, List[Tuple[float, float]]]:
    """The time inside [lo, hi] covered by ``spans``, and the gaps between
    them there, longest first.  Times in any one unit."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in spans
                     if a < hi and b > lo)
    busy, end, gaps = 0.0, lo, []
    for a, b in clipped:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    return busy, gaps


def kernel_totals(events, lo: float,
                  hi: float) -> Dict[str, Tuple[float, int]]:
    """Device time and count by name of the ``(name, start, end)`` device
    events that start inside [lo, hi]."""
    out: Dict[str, Tuple[float, int]] = {}
    for name, a, b in events:
        if lo <= a < hi:
            t, n = out.get(name, (0.0, 0))
            out[name] = (t + (b - a), n + 1)
    return out
