"""The plain reference of the benchmark's decoder configurations, in
float32 PyTorch operations: no kernel, no cache, no batching tricks, no
graph.  It imports nothing of the program under test.

A configuration (its file's dict) names a ``block``:

* ``gqa`` — pre-norm attention with grouped key/value heads and rotary
  positions, then a SwiGLU FFN (internlm2-1.8b);
* ``hybrid`` — attention and a Mamba2 SSD mixer side by side on the same
  normed input, each output normed and the two averaged, then the FFN
  (hymba-1.5b as the port runs it; ``reduced``, ``published`` and
  ``assumed`` in its file say where that departs from the published
  model, and a file that asks for the published mechanisms is refused).

The weights are a tree of dicts: ``embed`` (V', d), ``head`` (d, V'),
``ln_f`` and ``blocks``, one dict a layer, with the names the benchmark's
weights use (``weights.py``).  V' is the vocabulary padded to 128; the pad
rows and columns are zeros that no token reaches, and the logits and the
loss are taken over the real vocabulary.

Serving: the program prefills a prompt in float32 and then decodes
through a bfloat16 key/value cache, and its decode step casts the softmax
to the cache's type before the product with the values
(``precision.cache`` in the configuration).  ``forward(...,
cache_rows_from=s)`` computes the attention of every row from ``s`` on in
that arithmetic: keys and values rounded to bfloat16, the probabilities
rounded to bfloat16, and the output rounded to bfloat16.  Rows before
``s`` are float32 throughout.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def tf32(enabled: bool):
    """Matmuls in TF32 (the control's precision) while ``enabled``."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def rms(x, w, eps):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rotary(x, pos, theta):
    """Rotate-half rotary embedding of x (B,S,H,D) at positions (S,)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos.float()[:, None] * inv
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    a, b = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([a * c - b * s, a * s + b * c], dim=-1)


def _attend(q, k, v, window, q0: int, rounded: bool):
    """Rows ``q0 ..`` of causal attention; q (B,R,H,D), k/v (B,S,Hkv,D)."""
    b, r, h, d = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    qg = q.reshape(b, r, hkv, rep, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) / math.sqrt(d)
    qpos = torch.arange(q0, q0 + r, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    keep = kpos <= qpos
    if window is not None:
        keep = keep & (kpos > qpos - window)
    p = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
    if rounded:
        p = p.to(torch.bfloat16).float()
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v).reshape(b, r, h, d)
    if rounded:
        o = o.to(torch.bfloat16).float()
    return o


def attention(lp, x, cfg, pos, cache_rows_from: Optional[int]):
    b, s, _ = x.shape
    h, hkv, d = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    q = rotary((x @ lp["wq"]).view(b, s, h, d), pos, cfg["rope_theta"])
    k = rotary((x @ lp["wk"]).view(b, s, hkv, d), pos, cfg["rope_theta"])
    v = (x @ lp["wv"]).view(b, s, hkv, d)
    window = cfg.get("sliding_window")
    r = s if cache_rows_from is None else cache_rows_from
    parts = [_attend(q[:, :r], k[:, :r], v[:, :r], window, 0, False)]
    if r < s:
        kb = k.to(torch.bfloat16).float()
        vb = v.to(torch.bfloat16).float()
        parts.append(_attend(q[:, r:], kb, vb, window, r, True))
    o = torch.cat(parts, dim=1).reshape(b, s, h * d)
    return o @ lp["wo"]


def ssd(x, dt, A, B, C, D, chunk: int):
    """Mamba2's SSD over a whole sequence, chunk by chunk: x (B,S,H,P),
    dt (B,S,H) after softplus, A (H,) negative, B/C (B,S,G,N), D (H,).
    Within a chunk, y_i = Σ_{j≤i} C_i·B_j exp(Σ_{j<t≤i} dt_t A) dt_j x_j;
    across chunks the state h ← exp(Σ dt A) h + Σ_j exp(..) dt_j B_j x_jᵀ.
    S must be a multiple of ``chunk``."""
    b, s, nh, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc, rep = s // chunk, nh // g
    xc = x.reshape(b, nc, chunk, nh, p)
    dtc = dt.reshape(b, nc, chunk, nh)
    Bh = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Ch = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cum = torch.cumsum(dtc * A, dim=2)                        # (b,c,l,h)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (b,c,i,j,h)
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).tril()[None, None, :, :, None]
    decay = torch.exp(seg.masked_fill(~lower, float("-inf")))
    cb = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    y = torch.einsum("bcijh,bcjhp->bcihp", cb * decay * dtc[:, :, None],
                     xc)
    to_end = torch.exp(cum[:, :, -1:, :] - cum) * dtc         # (b,c,l,h)
    chunk_state = torch.einsum("bcjhn,bcjhp->bchnp",
                               Bh * to_end[..., None], xc)
    state = torch.zeros(b, nh, n, p, dtype=torch.float32, device=x.device)
    before = []
    for c in range(nc):
        before.append(state)
        state = torch.exp(cum[:, c, -1])[..., None, None] * state \
            + chunk_state[:, c]
    before = torch.stack(before, dim=1)                       # (b,c,h,n,p)
    y = y + torch.einsum("bcihn,bchnp->bcihp", Ch, before) \
        * torch.exp(cum)[..., None]
    y = y + xc * D[:, None]
    return y.reshape(b, s, nh, p)


def mamba2(lp, x, cfg):
    sc = cfg["ssm"]
    b, s, d = x.shape
    d_in = sc["expand"] * d
    nh = d_in // sc["head_dim"]
    gn = sc["n_groups"] * sc["d_state"]
    proj = x @ lp["in_proj"]
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * gn, nh], dim=-1)
    k = sc["d_conv"]
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(padded[:, i:i + s] * lp["conv_w"][i] for i in range(k))
    xbc = F.silu(conv + lp["conv_b"])
    xs, B, C = torch.split(xbc, [d_in, gn, gn], dim=-1)
    dt = F.softplus(dt + lp["dt_bias"])
    y = ssd(xs.reshape(b, s, nh, sc["head_dim"]), dt, -torch.exp(lp["A_log"]),
            B.reshape(b, s, sc["n_groups"], sc["d_state"]),
            C.reshape(b, s, sc["n_groups"], sc["d_state"]), lp["D"],
            sc["chunk"])
    y = rms(y.reshape(b, s, d_in) * F.silu(z), lp["norm"], cfg["norm_eps"])
    return y @ lp["out_proj"]


def ffn(lp, x):
    return (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]


def block(lp, x, cfg, pos, cache_rows_from):
    h = rms(x, lp["ln1"], cfg["norm_eps"])
    if cfg["block"] == "gqa":
        x = x + attention(lp["attn"], h, cfg, pos, cache_rows_from)
    elif cfg["block"] == "hybrid":
        mx = lp["mixer"]
        a = attention(mx["attn"], h, cfg, pos, cache_rows_from)
        m = mamba2(mx["ssm"], h, cfg)
        x = x + 0.5 * (rms(a, mx["attn_norm"], cfg["norm_eps"])
                       + rms(m, mx["ssm_norm_out"], cfg["norm_eps"]))
    else:
        raise ValueError(f"no reference for block {cfg['block']!r}")
    return x + ffn(lp["ffn"], rms(x, lp["ln2"], cfg["norm_eps"]))


UNSUPPORTED = ("global_attn_idx", "num_memory_tokens", "kv_reuse_group")


def seq_multiple(cfg) -> int:
    """The length a compared sequence is padded to: the SSD chunk for a
    ``hybrid`` block, whose scan takes whole chunks, and 1 otherwise."""
    return cfg["ssm"]["chunk"] if cfg["block"] == "hybrid" else 1


def forward(params, cfg, tokens, *, cache_rows_from: Optional[int] = None):
    """Logits (B, S, V) over the real vocabulary of ``tokens`` (B, S)."""
    if any(cfg.get(k) for k in UNSUPPORTED) or \
            cfg.get("ssm_form", "mamba2_ssd") != "mamba2_ssd":
        raise NotImplementedError(
            f"{cfg['name']}: the reference runs one window in every layer, "
            "no meta tokens, one cache a layer and Mamba2 SSD heads")
    if tokens.shape[1] % seq_multiple(cfg):
        raise ValueError("pad the sequence to a multiple of the SSD chunk")
    x = params["embed"][tokens]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for lp in params["blocks"]:
        x = block(lp, x, cfg, pos, cache_rows_from)
    x = rms(x, params["ln_f"], cfg["norm_eps"])
    return x @ params["head"][:, :cfg["vocab_size"]]


def token_loss(params, cfg, tokens, labels):
    """Summed next-token cross entropy of (B, S) tokens against labels."""
    logits = forward(params, cfg, tokens)
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, labels[..., None])[..., 0]).sum()
