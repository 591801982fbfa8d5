"""The decoder of the zoo, in PyTorch: the counterpart of
``repro.models.transformer`` for all ten architectures (attention kinds
``gqa``, ``mla``, ``hybrid`` and ``none``; a dense FFN or MoE; token,
codebook or embedding inputs; RoPE, M-RoPE or none), and beyond the
reference, attention kind ``pattern`` (granite-4.0-h-small): each layer's
mixer from ``cfg.layer_types`` (GQA or Mamba2, each followed by the MoE),
the cache's entries stacking only the layers that have them, and the
embedding, residual and logit multipliers.

* The reference's ``lax.scan`` over stacked layer params becomes a Python
  loop over ``params["blocks"]``, a list of one dict a layer.
* Public layouts are the reference's: activations (B,S,D), q/k/v
  (B,S,H,D), logits (B,S,V) or (B,S,K,V), and caches as a dict of tensors
  stacked on a leading layer axis, exactly as :func:`init_cache` allocates
  them (``repro.models.transformer.init_cache``).
* :func:`decode_step` updates the cache **in place** and returns it.
* :func:`forward` recomputes each block in the backward pass when
  ``remat`` is on (``cfg.remat`` by default), the counterpart of the
  reference's ``jax.checkpoint(body, policy=nothing_saveable)``;
  :func:`loss_fn` is the next-token cross entropy (plus the MoE router's
  auxiliary losses) the train step differentiates.
* The embedding frontend (qwen2-vl-2b) takes ``inputs["embeds"]``
  (B,S,D) and M-RoPE ``inputs["positions"]`` (3,B,S); such a model has no
  ``embed`` table.
* Sharding: :class:`ShardRules` maps logical dims to mesh axes, and
  :func:`param_pspecs` / :func:`cache_pspecs` give the reference's
  partition specs as plain tuples (one entry a dimension: an axis name,
  ``None`` or a tuple of names), blocks stacked with a leading layer
  entry as in the reference; ``convert.unstack_specs`` lays them over the
  port's per-layer lists.  ``rules=`` reaches every place where the
  reference constrains an activation; on a plain tensor the constraint is
  the identity, on a ``DTensor`` a redistribution.  ``rules.moe_groups``
  sets the MoE dispatch groups, which changes the numbers (GShard's
  per-group capacity), as in the reference.  :func:`param_shapes` builds
  the parameters on the ``meta`` device (``jax.eval_shape``'s
  counterpart).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.spans import region


def default_device(device=None) -> torch.device:
    """``cuda:0`` unless the caller names a device; raises when CUDA is
    asked for and there is no card."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{dev} was asked for and no CUDA device is "
                           f"available; pass device='cpu' to run on the host")
    return dev


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


def P(*entries) -> tuple:
    """A partition spec as a plain tuple, one entry a dimension, normalised
    as ``jax.sharding.PartitionSpec`` normalises its entries: a tuple of
    one axis name becomes the name, an empty tuple ``None``.  So
    ``P(*spec) == tuple(jax.sharding.PartitionSpec(*spec))``."""
    def entry(e):
        if isinstance(e, (tuple, list)):
            return None if not e else e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(entry(e) for e in entries)


@dataclasses.dataclass(frozen=True)
class ShardRules:
    """Maps logical dims to mesh axes. ``None`` fields replicate."""
    batch: tuple = ("data",)          # ("pod","data") on the multi-pod mesh
    model: Optional[str] = "model"
    fsdp: Optional[str] = None        # ZeRO-3 axis for params (usually "data")
    seq: Optional[str] = None         # sequence-parallel axis for activations
    moe_groups: int = 1               # local dispatch groups (= batch shards)
    model_size: int = 1               # mesh size of the model axis

    def act(self, x, *spec):
        """The activation constraint: a ``DTensor`` is redistributed to the
        spec's placements on its own mesh; a plain tensor, whose one copy
        is the whole value, comes back unchanged (the reference's
        constraint on a one-device mesh is likewise the identity)."""
        if not L.is_dtensor(x):
            return x
        from repro_torch.launch.mesh import placements
        return _Constrain.apply(x, placements(P(*spec), x.device_mesh))


class _Constrain(torch.autograd.Function):
    """A ``DTensor`` redistributed to ``placements``, its gradient laid
    out the same way: the reference's sharding constraint, whose
    transpose constrains the cotangent to the same spec.  DTensor's own
    ``redistribute`` would hand a pending sum's gradient back as a
    pending sum, and the products upstream of it could then take
    gathered weights (DTensor's cost model counts bytes moved, not the
    product's work)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


NO_RULES = None


def _c(rules, x, *spec):
    if rules is None:
        return x
    return rules.act(x, *spec)


def _expert_constraint(rules):
    """MoE buffer constraint: (E,C,D) -> model on E; grouped (G,E,C,D) ->
    batch axes on G, model on E (group-local dispatch)."""
    def f(e):
        if e.ndim == 4:
            return _c(rules, e, rules.batch, rules.model, None, None)
        return _c(rules, e, rules.model, None, None)
    return f


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def _block_init(generator, cfg: ArchConfig, dtype, device, layer: int):
    kind = cfg.mixer(layer)
    p = {"ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if kind == "gqa":
        p["attn"] = L.gqa_init(generator, cfg, dtype, device)
    elif kind == "mla":
        p["attn"] = L.mla_init(generator, cfg, dtype, device)
    elif kind == "hybrid":
        p["mixer"] = L.hybrid_init(generator, cfg, dtype, device)
    elif kind == "none":
        p["ssm"] = L.ssm_init(generator, cfg, dtype, device)
    else:
        raise ValueError(kind)
    if cfg.moe is not None:
        p["ln2"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
        p["moe"] = L.moe_init(generator, cfg, dtype, device)
    elif cfg.d_ff:
        p["ln2"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
        p["ffn"] = L.ffn_init(generator, cfg, dtype, device)
    return p


def init_params(cfg: ArchConfig, *, generator: Optional[torch.Generator]
                = None, device=None, dtype=torch.float32, seed: int = 0):
    """Random parameters with the reference's shapes and scales
    (``transformer.py:78-120``, ``layers.py``): normal draws × 0.02 (output
    projections × 0.02/√(2L)), norms at 1, the pad rows of ``embed`` and
    pad columns of ``head`` zeroed, ``A_log = log(1..nh)``, ``D = 1``,
    ``dt_bias`` the inverse softplus of a log-uniform draw in
    [dt_min, dt_max] and an fp32 MoE router whatever ``dtype``; no
    ``embed`` in embeddings mode.  The draws come from ``generator``
    (made from ``seed`` on ``device`` when not given), so they are not
    the reference's: tests carry the reference's weights across with
    :mod:`repro_torch.models.convert`."""
    device = default_device(device)
    if generator is None:
        # meta tensors draw nothing, and a meta generator does not exist
        generator = torch.Generator(
            device="cpu" if device.type == "meta" else device
        ).manual_seed(seed)
    params = {}
    v, d, kb = cfg.padded_vocab_size, cfg.d_model, cfg.n_codebooks
    if cfg.input_mode == "tokens":
        shape = (v, d) if kb == 1 else (kb, v, d)
        emb = L._init(generator, shape, 0.02, dtype, device)
        emb[..., cfg.vocab_size:, :] = 0.0      # pad rows (never indexed)
        params["embed"] = emb
    params["ln_f"] = torch.ones((d,), dtype=dtype, device=device)
    if not cfg.tie_embeddings:
        shape = (d, v) if kb == 1 else (kb, d, v)
        head = L._init(generator, shape, 0.02, dtype, device)
        head[..., cfg.vocab_size:] = 0.0        # pad cols -> pad logits == 0
        params["head"] = head
    params["blocks"] = [_block_init(generator, cfg, dtype, device, i)
                        for i in range(cfg.n_layers)]
    return params


def param_shapes(cfg: ArchConfig, dtype=torch.bfloat16):
    """The parameters as meta tensors (shapes and types, no memory): the
    counterpart of the reference's ``jax.eval_shape`` of ``init_params``."""
    return init_params(cfg, device="meta", dtype=dtype)


def param_count(params) -> int:
    """Elements over every tensor of a parameter tree."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return sum(param_count(v) for v in params)


# ---------------------------------------------------------------------------
# partition specs (the reference's tree: blocks stacked, leading layer entry)
# ---------------------------------------------------------------------------


def _block_pspecs(cfg: ArchConfig, r: ShardRules):
    if cfg.attn_kind == "pattern":
        raise NotImplementedError(
            f"{cfg.name}: blocks of a per-layer pattern do not stack into "
            f"one spec tree")
    m, f = r.model, r.fsdp
    rep1 = P(None, None)                       # stacked (L, d) norms
    p = {"ln1": rep1}
    if cfg.attn_kind in ("gqa", "hybrid"):
        # TP shards whole heads; where the kv heads do not divide the model
        # axis, the (small) kv projections are replicated instead
        # (Megatron-style), as in the reference
        kv_rep = (r.model_size > 1
                  and cfg.n_kv_heads % max(r.model_size, 1) != 0)
        mkv = None if kv_rep else m
        attn = {"wq": P(None, f, m), "wk": P(None, f, mkv),
                "wv": P(None, f, mkv), "wo": P(None, m, f)}
    if cfg.attn_kind == "gqa":
        p["attn"] = attn
    elif cfg.attn_kind == "mla":
        p["attn"] = {
            "wq_a": P(None, f, None), "q_norm": rep1,
            "wq_b": P(None, None, m),
            "wkv_a": P(None, f, None), "kv_norm": rep1,
            "wkv_b": P(None, None, m),
            "wo": P(None, m, f),
        }
    if cfg.attn_kind in ("none", "hybrid"):
        # the packed SSM projections are not TP-shardable: replicated over
        # 'model', sharded only on the FSDP axis
        ssm = {"in_proj": P(None, f, None),
               "conv_w": P(None, None, None), "conv_b": P(None, None),
               "A_log": P(None, None), "D": P(None, None),
               "dt_bias": P(None, None),
               "norm": P(None, None), "out_proj": P(None, None, f)}
        if cfg.attn_kind == "none":
            p["ssm"] = ssm
        else:
            p["mixer"] = {"attn": attn, "ssm": ssm,
                          "attn_norm": rep1, "ssm_norm_out": rep1}
    if cfg.moe is not None:
        p["ln2"] = rep1
        moe = {"router": P(None, None, None),
               "w_gate": P(None, m, f, None),
               "w_up": P(None, m, f, None),
               "w_down": P(None, m, None, f)}
        if cfg.moe.dense_residual:
            moe["dense"] = {"w_up": P(None, f, m), "w_down": P(None, m, f),
                            **({"w_gate": P(None, f, m)}
                               if cfg.ffn_kind == "swiglu" else {})}
        p["moe"] = moe
    elif cfg.d_ff:
        p["ln2"] = rep1
        ffn = {"w_up": P(None, f, m), "w_down": P(None, m, f)}
        if cfg.ffn_kind == "swiglu":
            ffn["w_gate"] = P(None, f, m)
        p["ffn"] = ffn
    return p


def param_pspecs(cfg: ArchConfig, rules: ShardRules):
    """The reference's spec tree (``blocks`` stacked: each spec has a
    leading ``None`` for the layer axis); ``convert.unstack_specs`` lays
    it over the port's per-layer lists."""
    m, f = rules.model, rules.fsdp
    specs = {"ln_f": P(None), "blocks": _block_pspecs(cfg, rules)}
    if cfg.input_mode == "tokens":
        specs["embed"] = (P(m, f) if cfg.n_codebooks == 1
                          else P(None, m, f))
    if not cfg.tie_embeddings:
        specs["head"] = (P(f, m) if cfg.n_codebooks == 1
                         else P(None, f, m))
    return specs


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _embed_inputs(params, cfg: ArchConfig, inputs):
    if cfg.input_mode == "embeddings":
        return inputs["embeds"]
    # F.embedding, not indexing: its backward sums each row's gradient in a
    # fixed order, where indexing's (index_put_ with accumulate) does not
    tok = inputs["tokens"]
    if cfg.n_codebooks == 1:
        x = L.embedding(tok, params["embed"])
    else:
        # musicgen: (B,S,K) codebook ids, summed embeddings
        x = L.embedding(tok[..., 0], params["embed"][0])
        for k in range(1, cfg.n_codebooks):
            x = x + L.embedding(tok[..., k], params["embed"][k])
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return x


def _logits(params, cfg: ArchConfig, x, rules=None):
    if cfg.tie_embeddings or cfg.n_codebooks == 1:
        logits = (x @ params["embed"].T if cfg.tie_embeddings
                  else x @ params["head"])
        logits = _c(rules, logits, (rules.batch if rules else None), None,
                    (rules.model if rules else None))
    else:
        logits = L.codebook_logits(x, params["head"])
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


def _positions_cos_sin(cfg: ArchConfig, inputs, seq_len: int,
                       head_dim: int, device):
    if cfg.pos_kind == "none":
        return None, None
    if cfg.pos_kind == "mrope":
        return L.mrope_cos_sin(inputs["positions"], head_dim,
                               cfg.rope_theta, cfg.mrope_sections)
    pos = torch.arange(seq_len, device=device)
    return L.rope_cos_sin(pos, head_dim, cfg.rope_theta)


def _rope_dim(cfg: ArchConfig) -> int:
    """The rotated width: MLA rotates its ``qk_rope_dim`` dims only."""
    return (cfg.mla.qk_rope_dim if cfg.attn_kind == "mla"
            else cfg.head_dim)


def _residual(x, y, cfg: ArchConfig):
    """``x + y``, y times the residual multiplier where there is one."""
    if cfg.residual_multiplier != 1.0:
        y = y * cfg.residual_multiplier
    return x + y


def _ffn(lp, x, cfg: ArchConfig, rules=None):
    """The block's second half: (x, aux) with MoE's aux losses, else {}."""
    if cfg.moe is not None:
        h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        y, aux = L.moe_forward(
            lp["moe"], h2, cfg,
            shard_experts=(_expert_constraint(rules) if rules else None),
            groups=(rules.moe_groups if rules else 1))
        return _residual(x, y, cfg), aux
    if cfg.d_ff:
        h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = _residual(x, L.ffn_forward(lp["ffn"], h2, cfg.ffn_kind), cfg)
    return x, {}


def _has_ffn(cfg: ArchConfig) -> bool:
    return cfg.moe is not None or bool(cfg.d_ff)


def _act_spec(rules):
    """The (B, S, D) activations' spec: batch axes, sequence axis."""
    return ((rules.batch if rules else None), rules.seq if rules else None,
            None)


def block_forward(lp, x, cos, sin, cfg: ArchConfig, *, layer: int, impl,
                  chunk, rules: Optional[ShardRules] = None):
    """Decoder block ``layer``. Returns (x, aux_dict)."""
    kind = cfg.mixer(layer)
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "gqa":
        a, _ = L.gqa_forward(lp["attn"], h, cos, sin, cfg, impl=impl,
                             window=cfg.sliding_window, chunk=chunk)
    elif kind == "mla":
        a, _ = L.mla_forward(lp["attn"], h, cos, sin, cfg, impl=impl,
                             chunk=chunk)
    elif kind == "hybrid":
        a, _ = L.hybrid_forward(lp["mixer"], h, cos, sin, cfg, impl=impl,
                                chunk=chunk)
    else:                                           # the Mamba2 mixer
        a = L.ssm_forward(lp["ssm"], h, cfg, impl=impl)
        if not _has_ffn(cfg):                       # mamba2: no FFN
            return x + a, {}
    x, aux = _ffn(lp, _c(rules, _residual(x, a, cfg), *_act_spec(rules)),
                  cfg, rules)
    return _c(rules, x, *_act_spec(rules)), aux


def _dtensor_scoped(fn):
    """``fn(params, cfg, *args, **kw)`` under :func:`layers.dtensor_scope`
    of ``params`` and ``args``: with ``DTensor`` parameters the model's
    own constants join them as replicated ``DTensor``s."""
    @functools.wraps(fn)
    def scoped(params, cfg, *args, **kw):
        with L.dtensor_scope(params, args):
            return fn(params, cfg, *args, **kw)
    return scoped


@_dtensor_scoped
def forward(params, cfg: ArchConfig, inputs, *, impl="dense", chunk=1024,
            rules: Optional[ShardRules] = None,
            remat: Optional[bool] = None):
    """Full-sequence forward. Returns (logits, aux): for MoE archs the
    router's ``lb_loss`` and ``z_loss`` summed over the layers and
    ``dropped_frac`` their mean, else {}.

    With ``remat`` (``cfg.remat`` when None) and gradients enabled, each
    block keeps only its input for the backward pass and runs again
    there.  ``impl="kernel"`` raises under autograd: the kernels are
    forward-only, as the reference's Pallas kernels are (its ``jax.grad``
    fails inside ``pallas_call``)."""
    remat = cfg.remat if remat is None else remat
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in pytree.tree_leaves(params))
    if grad and impl == "kernel":
        raise NotImplementedError(
            "impl='kernel' has no gradient: the kernels, like the "
            "reference's Pallas kernels, are forward-only; differentiate "
            "impl='dense' or 'chunked'")
    x = _c(rules, _embed_inputs(params, cfg, inputs), *_act_spec(rules))
    cos, sin = _positions_cos_sin(cfg, inputs, x.shape[1], _rope_dim(cfg),
                                  x.device)
    aux = ({"lb_loss": 0.0, "z_loss": 0.0, "dropped_frac": 0.0}
           if cfg.moe is not None else {})
    for i, lp in enumerate(params["blocks"]):
        if remat and grad:
            # the blocks draw no random numbers: no RNG state to replay
            x, a = checkpoint(block_forward, lp, x, cos, sin, cfg, layer=i,
                              impl=impl, chunk=chunk, rules=rules,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = block_forward(lp, x, cos, sin, cfg, layer=i, impl=impl,
                                 chunk=chunk, rules=rules)
        for k, v in a.items():
            aux[k] = aux[k] + v
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    if cfg.moe is not None:
        aux["dropped_frac"] = aux["dropped_frac"] / cfg.n_layers
    return _logits(params, cfg, x, rules), aux


def token_ce(logits, labels, cfg: ArchConfig):
    """Each label's cross entropy, ``lse − gold``, in fp32: the
    vocab-pad columns masked to −1e30 before an fp32 log-sum-exp, the
    gold logit a ``gather`` of the label's column (the reference sums
    logits × one-hot, a single nonzero product, so the values are the
    same without a (…, V) one-hot)."""
    vp = cfg.padded_vocab_size
    if vp != cfg.vocab_size:
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits.float()).to(logits.dtype)
    lse = torch.logsumexp(logits.float(), dim=-1)
    gold = L.reduced(torch.gather(logits, -1, labels.long()[..., None]))
    gold = gold[..., 0]
    return lse - gold.float()


@_dtensor_scoped
def loss_fn(params, cfg: ArchConfig, inputs, *, impl="dense", chunk=1024,
            rules: Optional[ShardRules] = None,
            remat: Optional[bool] = None):
    """Next-token cross entropy, plus ``lb_loss + z_loss`` for MoE archs.
    Returns (loss, metrics): ``ce`` and ``loss``, and for MoE archs the
    three aux values of :func:`forward`.

    The mean of :func:`token_ce`, so no gradient reaches the zero pad
    columns of the head.  Labels are (B, S), or (B, S, K) against
    (B, S, K, V) logits for codebook archs."""
    logits, aux = forward(params, cfg, inputs, impl=impl, chunk=chunk,
                          rules=rules, remat=remat)
    ce = token_ce(logits, inputs["labels"], cfg).mean()
    loss = ce
    metrics = {"ce": ce}
    if cfg.moe is not None:
        loss = loss + aux["lb_loss"] + aux["z_loss"]
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# decode (single-token serve step)
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Per-layer cache, stacked on a leading layer axis.

    Sliding-window archs get a ring buffer of ``window`` entries; MLA
    caches the compressed latent (``ckv``, ``krope``); SSM archs carry O(1)
    state (fp32 whatever ``dtype``).  Under a per-layer pattern each entry
    stacks the layers that have it only: ``k``/``v`` the attention layers,
    ``ssm``/``conv`` the Mamba2 ones, each at its
    ``cfg.state_index``."""
    device = default_device(device)
    c = {}
    n_kv = cfg.n_mixers("gqa", "hybrid")
    if n_kv:
        size = max_len
        if cfg.sliding_window is not None:
            size = min(max_len, cfg.sliding_window)
        hkv, hd = cfg.n_kv_heads, cfg.head_dim
        c["k"] = torch.zeros((n_kv, batch, size, hkv, hd), dtype=dtype,
                             device=device)
        c["v"] = torch.zeros((n_kv, batch, size, hkv, hd), dtype=dtype,
                             device=device)
    if cfg.attn_kind == "mla":
        n, m = cfg.n_layers, cfg.mla
        c["ckv"] = torch.zeros((n, batch, max_len, m.kv_lora_rank),
                               dtype=dtype, device=device)
        c["krope"] = torch.zeros((n, batch, max_len, m.qk_rope_dim),
                                 dtype=dtype, device=device)
    n_ssm = cfg.n_mixers("none", "hybrid")
    if n_ssm:
        s = cfg.ssm
        _, nh, conv_dim = L.ssm_dims(cfg)
        c["ssm"] = torch.zeros((n_ssm, batch, nh, s.head_dim, s.d_state),
                               dtype=torch.float32, device=device)
        c["conv"] = torch.zeros((n_ssm, batch, s.d_conv - 1, conv_dim),
                                dtype=dtype, device=device)
    return c


def cache_pspecs(cfg: ArchConfig, rules: ShardRules):
    """Decode caches: batch on the batch axes, the long (sequence) dim on
    model (context-parallel decode); the SSM state on the batch axes
    only (its head count does not divide the model axis)."""
    b = rules.batch
    m = rules.model
    c = {}
    if cfg.n_mixers("gqa", "hybrid"):
        c["k"] = P(None, b, m, None, None)
        c["v"] = P(None, b, m, None, None)
    if cfg.attn_kind == "mla":
        c["ckv"] = P(None, b, m, None)
        c["krope"] = P(None, b, m, None)
    if cfg.n_mixers("none", "hybrid"):
        c["ssm"] = P(None, b, None, None, None)
        c["conv"] = P(None, b, None, None)
    return c


def _store(cache, name: str, layer: int, value) -> None:
    """Write one layer's new state into the stacked cache in place.  A
    state whose type is wider than the cache's (the fp32 conv window over
    a bf16 cache) widens the whole stacked entry once, as the reference's
    scan outputs do.  A captured step must not rebind an entry, so
    ``serve.DecodeGraph`` refuses a cache that its first step widens."""
    if cache[name].dtype != value.dtype:
        cache[name] = cache[name].to(
            torch.promote_types(cache[name].dtype, value.dtype))
    cache[name][layer].copy_(value)


def _ssm_step(cache, j: int, dtype, impl: str, step):
    """Run ``step(ssm, conv) -> (out, new_ssm, new_conv)`` on the stacked
    ``ssm`` and ``conv`` entries at ``j`` and keep its states.  Where
    :func:`L.ssm_in_place` the step updates them in place, so a conv entry
    narrower than ``dtype`` is widened first, as :func:`_store` would
    widen it after; otherwise the new states are stored.  Returns out."""
    in_place = L.ssm_in_place(impl, cache["ssm"])
    wide = torch.promote_types(cache["conv"].dtype, dtype)
    if in_place and cache["conv"].dtype != wide:
        cache["conv"] = cache["conv"].to(wide)
    out, st, conv = step(cache["ssm"][j], cache["conv"][j])
    if not in_place:
        _store(cache, "ssm", j, st)
        _store(cache, "conv", j, conv)
    return out


def block_decode(lp, x, cache, layer: int, length, cos, sin,
                 cfg: ArchConfig, rules: Optional[ShardRules] = None, *,
                 impl: str = "dense"):
    """One block of one decode step; updates ``cache`` (the stacked dict)
    at ``layer`` in place.  ``length`` is an int or a 0-d tensor on the
    cache's device.  ``impl="kernel"`` runs GQA and hybrid attention
    through the fused decode attention, and the Mamba2 and hybrid SSM step
    through the fused SSM decode, which updates the stacked ``ssm`` and
    ``conv`` entries in place (on a ``DTensor`` cache the SSM step stays op
    by op); MLA blocks ignore it.  Under a per-layer pattern the layer's
    state lies at its ``cfg.state_index`` in its own entries.  Returns x."""
    kind = cfg.mixer(layer)
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "gqa":
        j = cfg.state_index(layer)
        with region("mixer.attn"):
            a, _, _ = L.gqa_decode(lp["attn"], h, cache["k"][j],
                                   cache["v"][j], length, cos, sin, cfg,
                                   impl=impl)
        x = _residual(x, a, cfg)
    elif kind == "mla":
        a, _, _ = L.mla_decode(lp["attn"], h, cache["ckv"][layer],
                               cache["krope"][layer], length, cos, sin, cfg)
        x = x + a
    elif kind == "hybrid":
        def hybrid(ssm, conv):
            sub = {"k": cache["k"][layer], "v": cache["v"][layer],
                   "ssm": ssm, "conv": conv}
            a, sub = L.hybrid_decode(lp["mixer"], h, sub, length, cos, sin,
                                     cfg, impl=impl)
            return a, sub["ssm"], sub["conv"]
        x = x + _ssm_step(cache, layer, h.dtype, impl, hybrid)
    else:
        j = cfg.state_index(layer)
        with region("mixer.ssm"):
            y = _ssm_step(cache, j, h.dtype, impl,
                          lambda ssm, conv: L.ssm_decode(
                              lp["ssm"], h, ssm, conv, cfg, impl=impl))
        if not _has_ffn(cfg):                       # mamba2: no FFN
            return _c(rules, x + y, *_act_spec(rules))
        x = _residual(x, y, cfg)
    # the residual stream's constraints (the identity on a plain tensor)
    # reduce a DTensor's pending sums once a block, where XLA's sharding
    # propagation does so without being told
    x = _c(rules, x, *_act_spec(rules))
    return _c(rules, _ffn(lp, x, cfg, rules)[0], *_act_spec(rules))


DECODE_IMPLS = ("dense", "kernel")


@_dtensor_scoped
def decode_step(params, cfg: ArchConfig, cache, inputs, *,
                rules: Optional[ShardRules] = None, impl: str = "dense"):
    """One serve step: new token at position ``inputs['length']``.

    inputs: tokens (B,1) or (B,1,K) / embeds (B,1,D); positions (3,B,1)
    for M-RoPE; length, a 0-d integer tensor on the cache's device (the
    reference's form) or a host int (the dry-run's).  With a tensor
    nothing reads the position on the host, so every position runs the
    same ops on the same shapes: the step a CUDA graph can capture
    (``serve.make_decode_fn``).  ``impl="kernel"`` runs each GQA or
    hybrid layer's attention core (rope, slot writes, attention over the
    valid keys) as one ``kernels.ops.decode_attention`` call, and each
    Mamba2 or hybrid layer's SSM recurrence (conv window, dt, the state
    update in place, C·h + D·x) as one ``kernels.ops.ssm_decode`` call:
    their plain versions on a CPU cache, the kernels on the card;
    ``"dense"`` runs them op by op, and is what a ``DTensor`` cache takes.
    Returns (logits, cache) — the same cache dict, updated in place."""
    if impl not in DECODE_IMPLS:
        raise ValueError(f"impl must be one of {DECODE_IMPLS}, got {impl!r}")
    # the constraint is the identity on a plain tensor; a DTensor lookup
    # in a vocab-sharded table is reduced here, as forward's is
    x = _c(rules, _embed_inputs(params, cfg, inputs), *_act_spec(rules))
    length = inputs["length"]
    if not torch.is_tensor(length):
        length = int(length)
    if cfg.pos_kind == "mrope":
        cos, sin = L.mrope_cos_sin(inputs["positions"], _rope_dim(cfg),
                                   cfg.rope_theta, cfg.mrope_sections)
    elif cfg.pos_kind == "rope":
        pos = (length.reshape(1) if torch.is_tensor(length)
               else torch.tensor([length], device=x.device))
        cos, sin = L.rope_cos_sin(pos, _rope_dim(cfg), cfg.rope_theta)
        cos, sin = cos[None], sin[None]             # (1,1,hd/2)
    else:
        cos = sin = None
    for i, lp in enumerate(params["blocks"]):
        x = block_decode(lp, x, cache, i, length, cos, sin, cfg, rules,
                         impl=impl)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, x, rules), cache
