"""Layer primitives of the decoder zoo, in PyTorch: the counterpart of
``repro.models.layers`` for the families this port serves.

* GQA attention (dense / chunked online softmax / the flash kernel /
  decode), with sliding windows;
* Mamba2 SSD — chunked state-space duality scan (prefill) and stateful
  decode;
* the Hymba hybrid block — parallel attention and SSM heads;
* FFN: SwiGLU / squared-ReLU / GELU (tanh approximation, as
  ``jax.nn.gelu``).

MLA, MoE and M-RoPE wait for ROADMAP A8; :func:`check_supported` names
them.  Params are plain dicts of tensors with the reference's names and
shapes; initializers live next to the forward functions and take an
explicit ``torch.Generator``.  Softmax/norm math runs in float32 whatever
the compute dtype.

``impl`` takes ``"dense" | "chunked" | "kernel"``.  ``"kernel"`` is the
counterpart of the reference's ``"pallas"``: attention goes through
:func:`repro_torch.kernels.ops.flash_attention` and the SSD scan through
:func:`repro_torch.kernels.ops.ssd_chunk_scan`, which run the Hopper
kernels on a CUDA tensor and their plain versions on a CPU tensor.  Unlike
the reference, :func:`ssm_forward` takes the same ``impl`` (the reference's
``hybrid_forward`` leaves its SSM on the ``"jnp"`` scan); both scans compute
the same function.
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


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the parts of the zoo this port does not run yet."""
    missing = []
    if cfg.attn_kind == "mla":
        missing.append("MLA attention")
    if cfg.moe is not None:
        missing.append("MoE FFN")
    if cfg.pos_kind == "mrope":
        missing.append("M-RoPE")
    if cfg.input_mode != "tokens":
        missing.append("the embedding frontend")
    if missing:
        raise NotImplementedError(
            f"{cfg.name} needs {', '.join(missing)}, which the PyTorch port "
            f"does not have yet (ROADMAP A8)")


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
