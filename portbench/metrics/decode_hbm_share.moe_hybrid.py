"""The decode step's share of the card's memory bandwidth, for a decoder
of Mamba2 and attention layers by ``layer_types`` with an expert layer
after each: the bytes the window's steps must move (:func:`step_bytes`)
over their ``decode_s`` times 3.35 TB/s, in percent.  The bytes are
counted from the configuration file, never from the program."""
HBM_BYTES_PER_S = 3.35e12       # NVIDIA H100 SXM data sheet

UNIT = "%"
LAYER = "model step"
MOVES = "gen_tokens_per_s"
SOURCE = "program_span"
WORKLOADS = ["granite-4.0-h-small.batch_decode"]


def _ssm_dims(cfg):
    s = cfg["ssm"]
    d_in = s["expand"] * cfg["d_model"]
    return d_in, d_in // s["head_dim"], d_in + 2 * s["n_groups"] * s["d_state"]


def weight_params(cfg) -> int:
    """Every weight a step reads once: the norms, each layer's mixer
    (Mamba2: projections, conv and its bias, A_log, D, dt_bias, the gated
    norm; attention: the four projections), its router, the experts it
    holds and the shared expert, and the head (the tied embedding)."""
    d, s, m = cfg["d_model"], cfg["ssm"], cfg["moe"]
    d_in, nh, conv = _ssm_dims(cfg)
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    mamba = (d * (2 * d_in + 2 * s["n_groups"] * s["d_state"] + nh)
             + s["d_conv"] * conv + conv + 3 * nh + d_in + d_in * d)
    attention = 2 * d * h * hd + 2 * d * kv * hd
    ffn = (d * m["n_experts"]
           + (m["experts_held"] or m["n_experts"]) * 3 * d * m["d_expert"]
           + 3 * d * cfg["d_ff"])
    n = d + d * cfg["padded_vocab_size"]
    for kind in cfg["layer_types"]:
        n += 2 * d + ffn + (mamba if kind == "mamba" else attention)
    return n


def step_bytes(cfg, b: int, length: int) -> float:
    """Bytes one decode step of ``b`` sequences at cache position
    ``length`` (the new token's) must move: the weights once (fp32), the
    ``b`` embedding rows it looks up (fp32), each Mamba2 layer's state
    (fp32) and conv window (fp32) read and written, and each attention
    layer's keys and values as filled, ``length + 1`` entries (bf16)."""
    s = cfg["ssm"]
    _, nh, conv = _ssm_dims(cfg)
    state = 2 * 4 * b * (nh * s["head_dim"] * s["d_state"]
                         + (s["d_conv"] - 1) * conv)
    kv = 2 * 2 * b * (length + 1) * cfg["n_kv_heads"] * cfg["d_head"]
    n_mamba = sum(k == "mamba" for k in cfg["layer_types"])
    n_attn = len(cfg["layer_types"]) - n_mamba
    return float(4 * (weight_params(cfg) + b * cfg["d_model"])
                 + n_mamba * state + n_attn * kv)


def read(rec, trace):
    waves = rec.get("waves", ())
    seconds = sum(s for w in waves for s in w["decode_s"])
    if not seconds:
        return None
    nbytes = sum(step_bytes(rec["cfg"], w["batch"], w["prompt_len"] + k)
                 for w in waves for k in range(len(w["decode_s"])))
    return 100.0 * nbytes / (seconds * HBM_BYTES_PER_S)
