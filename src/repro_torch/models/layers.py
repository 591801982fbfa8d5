"""Layer primitives of the decoder zoo, in PyTorch: the counterpart of
``repro.models.layers``.

* GQA attention (dense / chunked online softmax / the flash kernel /
  decode), with sliding windows;
* RoPE and M-RoPE (Qwen2-VL's (t, h, w) sections);
* MLA — multi-head latent attention (prefill expansion, absorbed decode);
* Mamba2 SSD — chunked state-space duality scan (prefill) and stateful
  decode;
* the Hymba hybrid block — parallel attention and SSM heads;
* FFN: SwiGLU / squared-ReLU / GELU (tanh approximation, as
  ``jax.nn.gelu``);
* MoE: top-k router with scatter-based capacity dispatch (and arctic's
  parallel dense residual).

Params are plain dicts of tensors with the reference's names and shapes;
initializers live next to the forward functions and take an explicit
``torch.Generator``.  Softmax/norm math runs in float32 whatever the
compute dtype.

``impl`` takes ``"dense" | "chunked" | "kernel"``.  ``"kernel"`` is the
counterpart of the reference's ``"pallas"``: attention goes through
:func:`repro_torch.kernels.ops.flash_attention` and the SSD scan through
:func:`repro_torch.kernels.ops.ssd_chunk_scan`, which run the Hopper
kernels on a CUDA tensor and their plain versions on a CPU tensor.  Unlike
the reference, :func:`ssm_forward` takes the same ``impl`` (the reference's
``hybrid_forward`` leaves its SSM on the ``"jnp"`` scan); both scans compute
the same function.  MLA takes ``"chunked"`` or else dense attention, as the
reference's ``mla_forward`` does, so its ``"kernel"`` is dense too.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd as kssd

IMPLS = ("dense", "chunked", "kernel")


# ---------------------------------------------------------------------------
# small utilities
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def _init(generator, shape, scale, dtype, device):
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * scale).to(dtype)


def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    """``jax.nn.softplus``.  Torch's returns x itself above 20, where the
    difference, log1p(exp(-x)) < 2.1e-9, is below fp32 resolution."""
    return F.softplus(x)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions (...,S) int -> cos/sin (...,S,head_dim//2) float32."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions, head_dim: int, theta: float, sections):
    """M-RoPE (Qwen2-VL): positions (3,B,S) for the (t, h, w) axes ->
    cos/sin (B,S,head_dim//2) float32.

    ``sections`` gives each axis its count of rotary half-dims, in order,
    sum(sections) == head_dim // 2."""
    assert sum(sections) == head_dim // 2, (sections, head_dim)
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * freqs              # (3,B,S,hd/2)
    parts_cos, parts_sin = [], []
    off = 0
    for i, n in enumerate(sections):
        parts_cos.append(torch.cos(ang[i, ..., off:off + n]))
        parts_sin.append(torch.sin(ang[i, ..., off:off + n]))
        off += n
    return torch.cat(parts_cos, -1), torch.cat(parts_sin, -1)


def apply_rope(x, cos, sin):
    """x (B,S,H,D); cos/sin (B,S,D/2) or (S,D/2) — rotate-half convention."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].float()
    sin = sin[:, :, None, :].float()
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def attention_dense(q, k, v, *, causal=True, window=None, q_offset=0):
    """Reference O(S^2)-memory attention. q (B,Sq,H,D), k/v (B,Sk,Hkv,D)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    else:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    scores = scores.masked_fill(~mask[None, None], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def attention_chunked(q, k, v, *, causal=True, window=None,
                      chunk_q=1024, chunk_k=1024):
    """Flash-style chunked attention in torch ops: the flash kernel's
    plain version over key blocks of ``chunk_k``, the softmax cast to v's
    type before its product with v, as in the reference.

    Memory is O(S · chunk_k) per (batch, head) instead of O(S²); blocks
    above the diagonal are masked, not skipped, as in the reference, whose
    query chunks all run at once, so ``chunk_q`` only has to divide S."""
    s, sk = q.shape[1], k.shape[1]
    assert s % chunk_q == 0 and sk % chunk_k == 0, (s, sk, chunk_q, chunk_k)
    return kfa.plain(q, k, v, causal=causal, window=window, block_k=chunk_k,
                     pv_type=v.dtype)


def attention_decode(q, k_cache, v_cache, valid_len: int):
    """Single-token decode. q (B,1,H,D); caches (B,Smax,Hkv,D); valid_len =
    number of valid cache entries (the new token is already written).

    GQA is computed grouped, q (B,1,Hkv,rep,D) against the raw cache.  As
    in the reference, the scores are fp32 (the cache is upcast) and the
    softmax is cast to the cache's type before the product with v, so a
    bf16 cache gives a bf16 output.  Ring-buffer caches: once the buffer
    wraps every slot is valid and in-window, so ``kpos < valid_len`` is
    exact for both layouts."""
    b, _, h, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    qg = q.reshape(b, 1, hkv, rep, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k_cache.float())
    scores = scores / math.sqrt(d)
    kpos = torch.arange(smax, device=q.device)
    scores = scores.masked_fill(~(kpos < valid_len), float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, d)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


def gqa_init(generator, cfg: ArchConfig, dtype, device):
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out_scale = 0.02 / math.sqrt(2.0 * cfg.n_layers)
    return {
        "wq": _init(generator, (d, h * hd), 0.02, dtype, device),
        "wk": _init(generator, (d, hkv * hd), 0.02, dtype, device),
        "wv": _init(generator, (d, hkv * hd), 0.02, dtype, device),
        "wo": _init(generator, (h * hd, d), out_scale, dtype, device),
    }


def gqa_forward(p, x, cos, sin, cfg: ArchConfig, *, impl="dense",
                window=None, chunk=1024):
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if impl == "dense":
        o = attention_dense(q, k, v, causal=True, window=window)
    elif impl == "chunked":
        o = attention_chunked(q, k, v, causal=True, window=window,
                              chunk_q=min(chunk, s), chunk_k=min(chunk, s))
    elif impl == "kernel":
        o = kops.flash_attention(q, k, v, causal=True, window=window)
    else:
        raise ValueError(impl)
    return o.reshape(b, s, h * hd) @ p["wo"], (k, v)


def gqa_decode(p, x, cache_k, cache_v, write_idx: int, valid_len: int, cos,
               sin, cfg: ArchConfig):
    """x (B,1,D).  Writes the new kv at ``write_idx`` (== position, or
    position % window for ring buffers) into the caches **in place** and
    attends over ``valid_len`` entries.  Returns (out, cache_k, cache_v)."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, 1, h, hd)
    k = (x @ p["wk"]).reshape(b, 1, hkv, hd)
    v = (x @ p["wv"]).reshape(b, 1, hkv, hd)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    cache_k[:, write_idx] = k[:, 0].to(cache_k.dtype)
    cache_v[:, write_idx] = v[:, 0].to(cache_v.dtype)
    o = attention_decode(q, cache_k, cache_v, valid_len)
    o = o.reshape(b, 1, h * hd).to(torch.promote_types(o.dtype,
                                                        p["wo"].dtype))
    return o @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (MiniCPM3 / DeepSeek-V2 family)
# ---------------------------------------------------------------------------


def mla_init(generator, cfg: ArchConfig, dtype, device):
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    out_scale = 0.02 / math.sqrt(2.0 * cfg.n_layers)
    return {
        "wq_a": _init(generator, (d, m.q_lora_rank), 0.02, dtype, device),
        "q_norm": torch.ones((m.q_lora_rank,), dtype=dtype, device=device),
        "wq_b": _init(generator, (m.q_lora_rank, h * qk), 0.02, dtype,
                      device),
        "wkv_a": _init(generator, (d, m.kv_lora_rank + m.qk_rope_dim), 0.02,
                       dtype, device),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dtype, device=device),
        "wkv_b": _init(generator, (m.kv_lora_rank,
                                   h * (m.qk_nope_dim + m.v_head_dim)), 0.02,
                       dtype, device),
        "wo": _init(generator, (h * m.v_head_dim, d), out_scale, dtype,
                    device),
    }


def _mla_qkv(p, x, cos, sin, cfg: ArchConfig):
    """Shared projection path; returns q_nope, q_rope, c_kv (normed),
    k_rope.  cos/sin span the ``qk_rope_dim`` rotated dims only."""
    m, h = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wq_b"]).reshape(b, s, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    c_kv, k_rope = torch.split(x @ p["wkv_a"],
                               [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(p, x, cos, sin, cfg: ArchConfig, *, impl="dense",
                chunk=1024):
    """Prefill/train path: expand the latent back to per-head k/v (q/k
    ``qk_nope + qk_rope`` wide, v ``v_head_dim``).  Returns (out, (c_kv,
    k_rope)), the two latents the decode cache keeps.

    ``impl="chunked"`` takes the chunked online softmax; any other impl,
    ``"kernel"`` included, takes dense attention, as the reference's
    ``mla_forward`` does for its ``"pallas"``: the flash kernel never
    sees MLA's unequal q/k and v widths."""
    m, h = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    if impl not in IMPLS:
        raise ValueError(impl)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cos, sin, cfg)
    kvx = (c_kv @ p["wkv_b"]).reshape(b, s, h, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = torch.split(kvx, [m.qk_nope_dim, m.v_head_dim], dim=-1)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_dim)], -1)
    if impl == "chunked":
        o = attention_chunked(q, k, v, causal=True, chunk_q=min(chunk, s),
                              chunk_k=min(chunk, s))
    else:
        o = attention_dense(q, k, v, causal=True)
    return o.reshape(b, s, h * m.v_head_dim) @ p["wo"], (c_kv, k_rope)


def mla_decode(p, x, cache_ckv, cache_krope, length: int, cos, sin,
               cfg: ArchConfig):
    """Absorbed-matmul MLA decode: attention runs in the latent space, so
    the cache stays compressed, (B,Smax,kv_lora) + (B,Smax,rope) only.

    x (B,1,D).  Writes the new latents at ``length`` into the caches **in
    place** (no ring; ``length < Smax``: torch indexing raises where the
    reference's ``dynamic_update_slice`` clamps) and attends over
    ``length + 1`` entries.  As in the reference, the scores are fp32, the
    softmax is cast to the cache's type before its product with ``c_kv``
    (a bf16 cache gives a bf16 ``o_lat``), and ``o_lat`` is then widened
    to ``w_uv``'s type.  Returns (out, cache_ckv, cache_krope)."""
    m, h = cfg.mla, cfg.n_heads
    b = x.shape[0]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cos, sin, cfg)
    cache_ckv[:, length] = c_kv[:, 0].to(cache_ckv.dtype)
    cache_krope[:, length] = k_rope[:, 0].to(cache_krope.dtype)
    w_kv = p["wkv_b"].reshape(m.kv_lora_rank, h, m.qk_nope_dim + m.v_head_dim)
    w_uk, w_uv = w_kv[..., :m.qk_nope_dim], w_kv[..., m.qk_nope_dim:]
    # absorb: q_lat[b,h,r] = sum_n q_nope[b,h,n] w_uk[r,h,n]
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    sc = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), cache_ckv.float())
          + torch.einsum("bqhn,bsn->bhqs", q_rope.float(),
                         cache_krope.float())) * scale
    smax = cache_ckv.shape[1]
    keep = torch.arange(smax, device=x.device) < length + 1
    sc = sc.masked_fill(~keep, float("-inf"))
    pattn = torch.softmax(sc, dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", pattn.to(cache_ckv.dtype),
                         cache_ckv)
    dt = torch.promote_types(o_lat.dtype, w_uv.dtype)
    o = torch.einsum("bqhr,rhv->bqhv", o_lat.to(dt), w_uv.to(dt))
    o = o.reshape(b, 1, h * m.v_head_dim)
    dt = torch.promote_types(o.dtype, p["wo"].dtype)
    return o.to(dt) @ p["wo"].to(dt), cache_ckv, cache_krope


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------


def ffn_init(generator, cfg: ArchConfig, dtype, device, d_ff=None):
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    out_scale = 0.02 / math.sqrt(2.0 * cfg.n_layers)
    p = {"w_up": _init(generator, (d, f), 0.02, dtype, device),
         "w_down": _init(generator, (f, d), out_scale, dtype, device)}
    if cfg.ffn_kind == "swiglu":
        p["w_gate"] = _init(generator, (d, f), 0.02, dtype, device)
    return p


def ffn_forward(p, x, kind: str):
    if kind == "swiglu":
        return (silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if kind == "relu2":
        h = torch.relu(x @ p["w_up"])
        return (h * h) @ p["w_down"]
    if kind == "gelu":
        return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# MoE — top-k router + scatter-based capacity dispatch
# ---------------------------------------------------------------------------


def moe_init(generator, cfg: ArchConfig, dtype, device):
    """The router is fp32 whatever ``dtype``, as in the reference."""
    m, d = cfg.moe, cfg.d_model
    out_scale = 0.02 / math.sqrt(2.0 * cfg.n_layers)
    p = {
        "router": _init(generator, (d, m.n_experts), 0.02, torch.float32,
                        device),
        "w_gate": _init(generator, (m.n_experts, d, m.d_expert), 0.02, dtype,
                        device),
        "w_up": _init(generator, (m.n_experts, d, m.d_expert), 0.02, dtype,
                      device),
        "w_down": _init(generator, (m.n_experts, m.d_expert, d), out_scale,
                        dtype, device),
    }
    if m.dense_residual:
        p["dense"] = ffn_init(generator, cfg, dtype, device)
    return p


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)          # round up to multiple of 8


def _dispatch_positions(flat_ids, n_experts: int):
    """Position of each (token, slot) within its expert's arrival order:
    the reference's cumsum over a one-hot, in integers (its fp32 cumsum is
    exact at these counts, so the positions are the same).

    flat_ids (..., N) int -> pos (..., N) int32."""
    oh = F.one_hot(flat_ids.long(), n_experts).to(torch.int32)
    csum = torch.cumsum(oh, dim=-2, dtype=torch.int32)        # inclusive
    pos = torch.gather(csum, -1, flat_ids.long()[..., None])[..., 0] - 1
    return pos.to(torch.int32)


def moe_route(p, xf, top_k: int):
    """Router of (..., T, D) tokens: (logits, probs, gate, ids).

    ``lax.top_k`` puts the lower expert index first on ties, which
    ``torch.topk`` does not promise; a stable descending sort taken to
    ``top_k`` does.  The gates are renormalised over the chosen k."""
    logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = vals[..., :top_k], idx[..., :top_k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return logits, probs, gate, ids


def moe_forward(p, x, cfg: ArchConfig, *, shard_experts=None,
                groups: int = 1):
    """x (B,S,D) -> (y (B,S,D), aux_losses dict).

    Scatter/gather capacity dispatch: tokens are routed to a fixed-capacity
    (E, C, D) buffer with plain scatters (no one-hot dispatch einsum), so
    the expert products stay proportional to the useful work.  Overflowing
    tokens are dropped (their combine weight contribution is zero),
    matching GShard/Switch semantics.

    ``groups > 1`` takes GShard-style local dispatch groups
    (:func:`_moe_forward_grouped`), only when each group fills its
    capacity floor (the reference's gate); otherwise, as with
    ``groups=1``, all tokens form one group.  ``shard_experts`` constrains
    the expert buffers before and after the expert products
    (``transformer._expert_constraint``): (E, C, D) ungrouped, (G, E, C, D)
    grouped, as in the reference."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    if (groups > 1 and t % groups == 0
            and m.capacity_factor * (t // groups) * m.top_k
            / m.n_experts >= 8):
        return _moe_forward_grouped(p, x, cfg, shard_experts, groups)
    return _moe_forward_grouped(p, x, cfg, shard_experts, 1)


def _constrain(shard_experts, buf):
    """``shard_experts`` on a (G, E, C, D) buffer; at one group, on the
    reference's ungrouped (E, C, D) form."""
    if shard_experts is None:
        return buf
    if buf.shape[0] == 1:
        return shard_experts(buf[0])[None]
    return shard_experts(buf)


def _moe_forward_grouped(p, x, cfg: ArchConfig, shard_experts, groups: int):
    """Group-local capacity dispatch (see :func:`moe_forward`); one group
    is the reference's ungrouped path.

    Every (token, slot) past its expert's capacity is written to the one
    spare row ``n_experts · cap`` of its group's buffer, which is thrown
    away (``index_copy_`` with that duplicate index is nondeterministic in
    that row only), and gathers the zero row there.  The combine sums
    ``gate_j · out[slot_j]`` in fp32 in j order and casts once."""
    m = cfg.moe
    b, s, d = x.shape
    g, e, k = groups, m.n_experts, m.top_k
    tg = b * s // g
    xf = x.reshape(g, tg, d)
    logits, probs, gate, ids = moe_route(p, xf, k)           # (g,tg,k)

    cap = moe_capacity(cfg, tg)
    pos = _dispatch_positions(ids.reshape(g, tg * k), e).reshape(g, tg, k)
    keep = pos < cap
    slot = torch.where(keep, ids * cap + pos, e * cap)
    rows = e * cap + 1
    # one flat buffer; group i's rows start at i · rows
    flat = slot + (torch.arange(g, device=x.device) * rows)[:, None, None]
    buf = torch.zeros((g * rows, d), dtype=x.dtype, device=x.device)
    src = xf.reshape(g * tg, d)
    for j in range(k):                                       # k small
        buf.index_copy_(0, flat[:, :, j].reshape(-1), src)
    eb = _constrain(shard_experts,
                    buf.reshape(g, rows, d)[:, :-1].reshape(g, e, cap, d))
    hg = torch.einsum("gecd,edf->gecf", eb, p["w_gate"])
    hu = torch.einsum("gecd,edf->gecf", eb, p["w_up"])
    out = _constrain(shard_experts, torch.einsum(
        "gecf,efd->gecd", silu(hg) * hu, p["w_down"]))
    out_flat = torch.cat([out.reshape(g, e * cap, d),
                          torch.zeros((g, 1, d), dtype=out.dtype,
                                      device=out.device)], 1).reshape(-1, d)

    y = torch.zeros((g, tg, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + gate[:, :, j:j + 1] * out_flat[flat[:, :, j]].float()
    y = y.to(x.dtype).reshape(b, s, d)

    # aux losses: switch load-balance + router z-loss
    me = probs.mean((0, 1))                                   # (E,)
    ce = F.one_hot(ids[..., 0], e).float().mean((0, 1))
    aux = {
        "lb_loss": m.router_aux_coef * m.n_experts * torch.sum(me * ce),
        "z_loss": m.router_z_coef * torch.mean(
            torch.logsumexp(logits, dim=-1) ** 2),
        "dropped_frac": 1.0 - keep.float().mean(),
    }
    if m.dense_residual:
        y = y + ffn_forward(p["dense"], x, cfg.ffn_kind)
    return y, aux


# ---------------------------------------------------------------------------
# Mamba2 — SSD (state-space duality), chunked
# ---------------------------------------------------------------------------


def ssm_dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, nh, conv_dim


def ssm_init(generator, cfg: ArchConfig, dtype, device):
    s = cfg.ssm
    d = cfg.d_model
    d_in, nh, conv_dim = ssm_dims(cfg)
    out_scale = 0.02 / math.sqrt(2.0 * cfg.n_layers)
    in_proj = _init(generator, (d, 2 * d_in + 2 * s.n_groups * s.d_state
                                + nh), 0.02, dtype, device)
    conv_w = _init(generator, (s.d_conv, conv_dim), 0.02, dtype, device)
    u = torch.rand((nh,), generator=generator, device=device,
                   dtype=torch.float32)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))               # inv softplus
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "dt_bias": dt_bias,
        "norm": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": _init(generator, (d_in, d), out_scale, dtype, device),
    }


def _ssm_split(p, x, cfg: ArchConfig):
    """in_proj, split; returns (z, xbc (pre-conv), dt_raw)."""
    d_in, _, conv_dim = ssm_dims(cfg)
    proj = x @ p["in_proj"]
    z, xbc, dt_raw = torch.split(
        proj, [d_in, conv_dim, proj.shape[-1] - d_in - conv_dim], dim=-1)
    return z, xbc, dt_raw


def _causal_conv(xbc, conv_w, conv_b):
    """xbc (B,S,C); depthwise causal conv along S, as a shifted sum of
    slices (no convolution library, so no TF32)."""
    k = conv_w.shape[0]
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + s, :] * conv_w[i]
    return silu(out + conv_b)


def ssd_chunked(xh, dt, A, B_, C_, D, chunk: int, *, return_state=False):
    """Chunked SSD scan (Mamba2 alg. 1) in torch ops: the SSD kernel's
    plain version inside each chunk, then the recurrence across chunks
    (:mod:`repro_torch.kernels.ssd`).

    xh (B,S,nh,hd); dt (B,S,nh) [post-softplus]; A (nh,) negative;
    B_/C_ (B,S,g,d_state); D (nh,). Returns y (B,S,nh,hd), and with
    ``return_state`` also the final recurrent state (B,nh,hd,ds) fp32.
    As in the reference's ``ssd_chunked``, y is summed in fp32 (the
    chunk's own part, ``y_inter`` and D·x) and rounded to xh's type once:
    xh, B and C are widened before the chunk's part.  The kernel path
    (:func:`repro_torch.kernels.ops.ssd_chunk_scan`) rounds a bf16 y twice,
    as the reference's Pallas entry point does.
    """
    assert xh.shape[1] % chunk == 0, (xh.shape[1], chunk)
    parts = kssd.chunk_plain(xh.float(), dt, A, B_.float(), C_.float(), D,
                             chunk)
    y, state = kssd.inter_chunk(*parts, C_, chunk)
    y = y.to(xh.dtype)
    if return_state:
        return y, state
    return y


def ssm_forward(p, x, cfg: ArchConfig, *, return_state=False, impl="dense"):
    """Full-sequence Mamba2 mixer. x (B,S,D) -> y, or with ``return_state``
    -> (y, (final ssm_state (B,nh,hd,ds) fp32, conv_state
    (B,d_conv-1,conv_dim))).  ``impl="kernel"`` scans with
    :func:`repro_torch.kernels.ops.ssd_chunk_scan`, any other with
    :func:`ssd_chunked`."""
    s = cfg.ssm
    d_in, nh, _ = ssm_dims(cfg)
    b, sl, _ = x.shape
    z, xbc_raw, dt_raw = _ssm_split(p, x, cfg)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xh, B_, C_ = torch.split(
        xbc, [d_in, s.n_groups * s.d_state, s.n_groups * s.d_state], dim=-1)
    xh = xh.reshape(b, sl, nh, s.head_dim)
    B_ = B_.reshape(b, sl, s.n_groups, s.d_state)
    C_ = C_.reshape(b, sl, s.n_groups, s.d_state)
    dt = softplus(dt_raw.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    if impl == "kernel":
        y, final = kops.ssd_chunk_scan(xh, dt, A, B_, C_, p["D"],
                                       chunk=min(s.chunk, sl))
    else:
        y, final = ssd_chunked(xh, dt, A, B_, C_, p["D"], min(s.chunk, sl),
                               return_state=True)
    y = y.reshape(b, sl, d_in)
    y = rms_norm(y * silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        k = s.d_conv - 1
        conv_state = xbc_raw[:, -k:, :] if sl >= k else F.pad(
            xbc_raw, (0, 0, k - sl, 0))
        return out, (final, conv_state.to(x.dtype))
    return out


def ssm_decode(p, x, ssm_state, conv_state, cfg: ArchConfig):
    """Stateful single-token decode.

    x (B,1,D); ssm_state (B,nh,hd,ds) float32; conv_state (B,d_conv-1,
    conv_dim).  Returns (y, new_ssm_state, new_conv_state) as new tensors
    (the caller stores them); the new conv state has the promoted type of
    the old one and x, as in the reference.
    """
    s = cfg.ssm
    d_in, nh, _ = ssm_dims(cfg)
    b = x.shape[0]
    z, xbc, dt_raw = _ssm_split(p, x, cfg)
    xbc = xbc[:, 0]                                          # (B,conv_dim)
    dtype = torch.promote_types(conv_state.dtype, xbc.dtype)
    window = torch.cat([conv_state.to(dtype), xbc[:, None, :].to(dtype)], 1)
    out = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(dtype)) \
        + p["conv_b"]
    xbc_t = silu(out)
    new_conv = window[:, 1:]
    xh, B_, C_ = torch.split(
        xbc_t, [d_in, s.n_groups * s.d_state, s.n_groups * s.d_state], dim=-1)
    xh = xh.reshape(b, nh, s.head_dim)
    rep = nh // s.n_groups
    B_ = B_.reshape(b, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    C_ = C_.reshape(b, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    dt = softplus(dt_raw[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                   # (B,nh)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt, xh.float(), B_.float())
    new_state = dA[:, :, None, None] * ssm_state + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, C_.float())
    y = y + xh.float() * p["D"][None, :, None]
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = rms_norm(y * silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], new_state, new_conv


# ---------------------------------------------------------------------------
# Hymba hybrid block pieces (parallel attn + SSM heads)
# ---------------------------------------------------------------------------


def hybrid_init(generator, cfg: ArchConfig, dtype, device):
    return {
        "attn": gqa_init(generator, cfg, dtype, device),
        "ssm": ssm_init(generator, cfg, dtype, device),
        "attn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ssm_norm_out": torch.ones((cfg.d_model,), dtype=dtype,
                                   device=device),
    }


def hybrid_forward(p, x, cos, sin, cfg: ArchConfig, *, impl="dense",
                   chunk=1024):
    a, kv = gqa_forward(p["attn"], x, cos, sin, cfg, impl=impl,
                        window=cfg.sliding_window, chunk=chunk)
    m = ssm_forward(p["ssm"], x, cfg, impl=impl)
    y = 0.5 * (rms_norm(a, p["attn_norm"], cfg.norm_eps)
               + rms_norm(m, p["ssm_norm_out"], cfg.norm_eps))
    return y, kv


def hybrid_decode(p, x, cache, write_idx: int, valid_len: int, cos, sin,
                  cfg: ArchConfig):
    """``cache`` holds this layer's k, v (updated in place), ssm and conv;
    returns (y, {"k", "v", "ssm", "conv"}) with the new ssm and conv
    states."""
    a, ck, cv = gqa_decode(p["attn"], x, cache["k"], cache["v"], write_idx,
                           valid_len, cos, sin, cfg)
    m, st, conv = ssm_decode(p["ssm"], x, cache["ssm"], cache["conv"], cfg)
    y = 0.5 * (rms_norm(a, p["attn_norm"], cfg.norm_eps)
               + rms_norm(m, p["ssm_norm_out"], cfg.norm_eps))
    return y, {"k": ck, "v": cv, "ssm": st, "conv": conv}
