"""The plain reference of a hybrid Mamba2 / attention decoder with an expert
layer after every mixer (granitemoehybrid: granite-4.0-h-small), in float32
PyTorch operations: no kernel, no cache, no capacity buffer, no graph.  It
imports nothing of the program under test; it reuses ``decoder``'s RMS
norm, Mamba2 mixer (SSD scan included) and SwiGLU.

A configuration (its file's dict) gives ``layer_types``, one entry a
layer: ``mamba`` (the Mamba2 mixer of ``decoder.mamba2``) or
``attention`` (grouped-query attention with no positional encoding, the
scores times ``attention_multiplier``).  Each layer is::

    x = x + residual_multiplier * mixer(rms(x, ln1))
    h = rms(x, ln2)
    x = x + residual_multiplier * (experts(h) + shared(h))

where ``experts`` routes each token to the ``top_k`` experts of the
router's ``n_experts`` logits, with gates the softmax over those
``top_k`` logits, and sums gate × SwiGLU of each expert in a plain loop;
``shared`` is the shared SwiGLU expert (``moe.dense``).  The embedding is
multiplied by ``embedding_multiplier`` after the lookup; the logits are
the final norm times the tied embedding, divided by ``logits_scaling``.

Where it departs from the published model (``reduced``, ``published``
and ``assumed`` in the configuration's file):

* the loop runs over the experts this card holds only, ``moe.
  experts_held`` (0 .. held − 1 of ``n_experts``): a token routed to an
  absent expert gets nothing from it, and its gate is not spread over
  the rest.  That is one card's share of an expert-parallel deployment,
  whose other cards would add the other experts' parts;
* the weights are float32 drawn from the seed (``weights.py``); the
  published ones are bfloat16.

Serving: the program prefills in float32 and decodes through a bfloat16
key/value cache (``precision`` in the file).  ``forward(...,
cache_rows_from=s)`` computes the attention of every row from ``s`` on in
that arithmetic, as ``decoder.attention`` does: keys and values rounded to
bfloat16, the probabilities rounded to bfloat16 and the output rounded to
bfloat16.  The Mamba2 state stays float32 on both paths.
"""
from __future__ import annotations

from typing import Optional

import torch

from portbench.reference import decoder

KINDS = ("mamba", "attention")


def seq_multiple(cfg) -> int:
    """The SSD chunk: the Mamba2 scan takes whole chunks."""
    return cfg["ssm"]["chunk"]


def _attend(q, k, v, q0: int, scale: float, rounded: bool):
    """Rows ``q0 ..`` of causal attention; q (B,R,H,D), k/v (B,S,Hkv,D)."""
    b, r, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, r, hkv, h // hkv, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) * scale
    qpos = torch.arange(q0, q0 + r, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    p = torch.softmax(scores.masked_fill(kpos > qpos, float("-inf")), dim=-1)
    if rounded:
        p = p.to(torch.bfloat16).float()
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v).reshape(b, r, h, d)
    if rounded:
        o = o.to(torch.bfloat16).float()
    return o


def attention(lp, x, cfg, cache_rows_from: Optional[int]):
    """Grouped-query attention with no positional encoding."""
    b, s, _ = x.shape
    h, hkv, d = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    scale = cfg["attention_multiplier"]
    q = (x @ lp["wq"]).view(b, s, h, d)
    k = (x @ lp["wk"]).view(b, s, hkv, d)
    v = (x @ lp["wv"]).view(b, s, hkv, d)
    r = s if cache_rows_from is None else cache_rows_from
    parts = [_attend(q[:, :r], k[:, :r], v[:, :r], 0, scale, False)]
    if r < s:
        kb = k.to(torch.bfloat16).float()
        vb = v.to(torch.bfloat16).float()
        parts.append(_attend(q[:, r:], kb, vb, r, scale, True))
    return torch.cat(parts, dim=1).reshape(b, s, h * d) @ lp["wo"]


def experts(lp, x, cfg):
    """The routed experts this card holds, gate-weighted, plus the shared
    expert, of (B, S, D) x."""
    m = cfg["moe"]
    t = x.reshape(-1, x.shape[-1])
    top, ids = (t @ lp["router"]).topk(m["top_k"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(t)
    for e in range(m["experts_held"] or m["n_experts"]):
        rows, slot = (ids == e).nonzero(as_tuple=True)
        if not rows.numel():
            continue
        w = {name: lp[name][e] for name in ("w_gate", "w_up", "w_down")}
        # a token meets an expert at most once: the rows are distinct
        y[rows] = y[rows] + gates[rows, slot, None] * decoder.ffn(w, t[rows])
    y = y + decoder.ffn(lp["dense"], t)
    return y.reshape(x.shape)


def forward(params, cfg, tokens, *, cache_rows_from: Optional[int] = None):
    """Logits (B, S, V) over the real vocabulary of ``tokens`` (B, S)."""
    if any(kind not in KINDS for kind in cfg["layer_types"]):
        raise NotImplementedError(f"{cfg['name']}: layers are one of {KINDS}")
    if tokens.shape[1] % seq_multiple(cfg):
        raise ValueError("pad the sequence to a multiple of the SSD chunk")
    eps, rm = cfg["norm_eps"], cfg["residual_multiplier"]
    x = params["embed"][tokens] * cfg["embedding_multiplier"]
    for kind, lp in zip(cfg["layer_types"], params["blocks"]):
        h = decoder.rms(x, lp["ln1"], eps)
        if kind == "attention":
            a = attention(lp["attn"], h, cfg, cache_rows_from)
        else:
            a = decoder.mamba2(lp["ssm"], h, cfg)
        x = x + rm * a
        x = x + rm * experts(lp["moe"], decoder.rms(x, lp["ln2"], eps), cfg)
    x = decoder.rms(x, params["ln_f"], eps)
    return x @ params["embed"][:cfg["vocab_size"]].T / cfg["logits_scaling"]
