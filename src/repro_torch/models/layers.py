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
  parallel dense residual, granite's shared expert); a layer may hold only
  a share of the experts its router scores (``MoEConfig.experts_held``)
  and route dropless, and :func:`counting` counts its routed pairs and
  rows;
* GQA attention's scores times ``cfg.attention_multiplier`` where one is
  given (granite), else divided by √D.

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

import contextlib
import math
import sys
import threading

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops as kops
from repro_torch.kernels.decode_attention import ring_slot
from repro_torch.kernels import ssd as kssd
from repro_torch.kernels import ssm_decode as kssm
from repro_torch.spans import region

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
    # scaled in place: a full-width tensor (arctic's 17.9 GB expert
    # stacks) is never held twice
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32).mul_(scale).to(dtype)


def silu(x):
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# DTensor support: every helper below is the identity (or the plain op) on
# a plain tensor; DTensor's module is imported only once a DTensor exists
# ---------------------------------------------------------------------------


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``DTensor``.  Where DTensor's module was never
    imported no DTensor exists, so plain callers never pay its import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def from_local(local, mesh, placements, shape):
    """A ``DTensor`` of global ``shape`` (laid out contiguously) over each
    rank's ``local`` shard, unchecked: the shape is given because an
    uneven split would otherwise be taken for an even one."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def dtensor_scope(*trees):
    """The scope a model call runs in: with a ``DTensor`` among ``trees``'
    leaves, ``implicit_replication``, under which every plain tensor the
    model makes itself (RoPE tables, masks, ``arange``s, zero buffers;
    the same on every rank) joins a ``DTensor`` op as a replicated
    ``DTensor`` on that op's mesh; otherwise nothing."""
    import contextlib
    from torch.utils._pytree import tree_leaves
    if not any(is_dtensor(t) for t in tree_leaves(trees)):
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    if not DTensor._op_dispatcher._allow_implicit_replication:
        # not re-entrant: its exit turns the replication off, so an inner
        # scope would end the outer one's
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def _cuts(t, dim: int, size: int) -> bool:
    """Whether a ``DTensor``'s shards of dimension ``dim`` cut it where a
    split of that dimension into (``size``, rest) would not: DTensor
    does not unflatten such an uneven split, where XLA pads.  False for a
    plain tensor."""
    if not is_dtensor(t):
        return False
    from torch.distributed.tensor import Shard
    dim, n = dim % t.ndim, 1
    for width, pl in zip(t.device_mesh.shape, t.placements):
        if isinstance(pl, Shard) and pl.dim % t.ndim == dim:
            n *= width
    return size % n != 0


def _placed(t, fn):
    """``t`` redistributed to ``fn(mesh dim's placement) -> placement``
    on each mesh dim (nothing moves where every placement stays)."""
    new = [fn(pl) for pl in t.placements]
    return t if new == list(t.placements) else t.redistribute(
        t.device_mesh, new)


def reduced(t):
    """A ``DTensor`` with its pending sums (``Partial`` placements, such
    as a lookup in a vocab-sharded table leaves) reduced to
    ``Replicate``; a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return _placed(t, lambda pl: Replicate() if pl.is_partial() else pl)


def embedding(tok, table):
    """``F.embedding(tok, table)``.  On a ``DTensor`` table it is the
    vocab-parallel lookup (Megatron's): the table's model-dim shards
    (FSDP) are gathered, each rank looks up the ids in its vocab slice
    under ``local_map`` (zero rows elsewhere) and the rows are summed
    across the vocab shards, a ``Partial`` the caller's constraint
    reduces.  DTensor's own lookup leaves a masked partial whose
    backward it cannot redistribute."""
    if not is_dtensor(table):
        return F.embedding(tok, table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    table = _placed(table, lambda pl: pl if pl == Shard(0) else Replicate())
    tok = _placed(tok, lambda pl: pl if pl == Shard(0) else Replicate())
    out = [Shard(0) if t == Shard(0) else Partial() if w == Shard(0)
           else Replicate() for t, w in zip(tok.placements, table.placements)]
    grad = [Partial() if t == Shard(0) else w
            for t, w in zip(tok.placements, table.placements)]
    _, (lo, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)

    def lookup(ids, rows):
        ids = ids - lo
        keep = (ids >= 0) & (ids < rows.shape[0])
        y = F.embedding(torch.where(keep, ids, 0), rows)
        return y * keep[..., None].to(y.dtype)

    return local_map(lookup, out_placements=out,
                     in_placements=(list(tok.placements),
                                    list(table.placements)),
                     in_grad_placements=(list(tok.placements), grad),
                     device_mesh=mesh)(tok, table)


def _gathered(t, dim: int):
    """A ``DTensor`` replicated on the mesh dims that shard ``dim``."""
    from torch.distributed.tensor import Replicate, Shard
    return _placed(t, lambda pl: Replicate() if isinstance(pl, Shard)
                   and pl.dim % t.ndim == dim % t.ndim else pl)


def write_slot(cache, idx, value) -> None:
    """``cache[:, idx] = value`` in ``cache``'s type, in place: (B, S,
    ...) caches, (B, ...) values.  ``idx`` is an int or a 0-d tensor on
    the cache's device, written with ``index_copy_`` (a 0-d tensor index
    reads its value on the host).  A ``DTensor`` cache whose sequence
    dim is sharded (context-parallel decode) is written by the rank that
    holds slot ``idx``, in its own shard: DTensor's ``setitem`` would
    gather the whole cache first."""
    if not is_dtensor(cache):
        if torch.is_tensor(idx):
            cache.index_copy_(1, idx.reshape(1).long(),
                              value[:, None].to(cache.dtype))
        else:
            cache[:, idx] = value.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = cache.device_mesh

    def slot_placement(pl):            # the cache's, without its dim 1
        if not isinstance(pl, Shard) or pl.dim == 1:
            return Replicate()
        return Shard(pl.dim - 1) if pl.dim > 1 else pl

    value = value.redistribute(mesh, [slot_placement(pl)
                                      for pl in cache.placements])
    local = cache.to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    if offset[1] <= idx < offset[1] + shape[1]:
        local[:, idx - offset[1]] = value.to_local().to(cache.dtype)


def heads(t, *shape, split: bool = True):
    """``t.reshape(*shape)``, the last dim split into (heads, width).  A
    ``DTensor`` whose shards would cut a head (40 heads, or 8 kv heads,
    over a 16-wide model axis) is gathered on the mesh dims that shard
    its last dim, reshaped, and (with ``split``) split there again on
    whole heads, the first ranks taking the ceiling as XLA's padded
    split does (12 heads over 16 ranks: one head each on ranks 0-11).
    A plain tensor is reshaped as it is."""
    if not _cuts(t, -1, shape[-2]):
        return t.reshape(*shape)
    from torch.distributed.tensor import Shard
    last = t.ndim - 1
    cut = [isinstance(pl, Shard) and pl.dim % t.ndim == last
           for pl in t.placements]
    t = _gathered(t, last).reshape(*shape)
    if not split:
        return t
    return t.redistribute(t.device_mesh, [
        Shard(len(shape) - 2) if c else pl
        for c, pl in zip(cut, t.placements)])


def merge_heads(t, *shape):
    """``t.reshape(*shape)``, the last two (heads, width) dims merged:
    the inverse of :func:`heads`.  A ``DTensor`` split unevenly on its
    heads is gathered there first; then each rank merges its own shard
    and the result keeps ``t``'s placements (a head split becomes the
    same split of the merged dim), laid out contiguously as the plain
    reshape's is.  By hand, as ``local_map`` does: DTensor's own view
    would give a size-1 dim an odd stride (a following matmul then takes
    a bmm, other bits) and cannot unflatten an uneven split of the
    merged dim in the backward pass."""
    if not is_dtensor(t):
        return t.reshape(*shape)
    if _cuts(t, -2, t.shape[-2]):
        t = _gathered(t, -2)
    local = t.to_local()
    local = local.reshape(*local.shape[:-2], -1).contiguous()
    return from_local(local, t.device_mesh, t.placements, shape)


def _on_rows(fn, batched, shared):
    """``fn(*batched, *shared)`` on each rank's batch rows, as
    ``local_map`` would, for regions where DTensor lacks a sharding
    strategy: the ``batched`` DTensors (batch on dim 0) keep the first
    one's batch splits and are replicated on the other mesh dims, the
    ``shared`` ones are replicated and their gradients are pending sums
    over the batch splits.  ``fn`` returns a tuple of tensors with the
    batch on dim 0, laid out as the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    lead = batched[0]
    mesh = lead.device_mesh
    rows = [pl if pl == Shard(0) else Replicate() for pl in lead.placements]
    summed = [Partial() if pl == Shard(0) else Replicate() for pl in rows]
    rep = [Replicate()] * mesh.ndim
    local = [t.redistribute(mesh, rows).to_local() for t in batched]
    local += [t.redistribute(mesh, rep).to_local(grad_placements=summed)
              for t in shared]
    return tuple(from_local(o.contiguous(), mesh, rows,
                            (lead.shape[0], *o.shape[1:]))
                 for o in fn(*local))


def codebook_logits(x, head):
    """``einsum("bsd,kdv->bskv", x, head)``: K codebook heads over (B, S,
    D) x.  On ``DTensor``s it runs on each rank's shards, as ``local_map``
    would: x keeps its (batch, sequence) splits, the head its (codebook,
    vocab) splits on the other mesh dims, the rest is replicated (DTensor's
    own einsum flattens a sharded dim, which some torch versions
    refuse)."""
    if not is_dtensor(x):
        return torch.einsum("bsd,kdv->bskv", x, head)
    from torch.distributed.tensor import Partial, Replicate, Shard
    xp, hp, out, xg, hg = [], [], [], [], []
    for a, b in zip(x.placements, head.placements):
        if a in (Shard(0), Shard(1)):      # the head's sums pend here
            xp.append(a), hp.append(Replicate()), out.append(a)
            xg.append(a), hg.append(Partial())
        elif b in (Shard(0), Shard(2)):    # so do x's
            xp.append(Replicate()), hp.append(b)
            out.append(Shard(b.dim + 1)), xg.append(Partial()), hg.append(b)
        else:
            for lst in (xp, hp, out, xg, hg):
                lst.append(Replicate())
    mesh = x.device_mesh
    x, head = x.redistribute(mesh, xp), head.redistribute(mesh, hp)
    y = torch.einsum("bsd,kdv->bskv", x.to_local(grad_placements=xg),
                     head.to_local(grad_placements=hg))
    return from_local(y.contiguous(), mesh, out,
                      (*x.shape[:2], head.shape[0], head.shape[2]))


def _attend(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)``, an attention core over (B, S, H, D) q and
    (B, S, Hkv, D) k/v.  On ``DTensor``s it runs on each rank's (batch,
    head) shards, as ``local_map`` would: q keeps its batch and head
    splits, k/v take the same ones (where q's head shards do not line up
    with whole kv groups, k/v are first repeated to q's heads), and the
    output is laid out as q.  Plain tensors go straight to ``fn``."""
    if not is_dtensor(q):
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import Replicate, Shard
    q = _placed(q, lambda pl: pl if isinstance(pl, Shard)
                and pl.dim in (0, 2) else Replicate())
    places = list(q.placements)
    n = math.prod(width for width, pl in zip(q.device_mesh.shape, places)
                  if pl == Shard(2))
    if k.shape[2] != q.shape[2] and (k.shape[2] % n or q.shape[2] % n):
        rep = q.shape[2] // k.shape[2]
        k, v = (_repeat_kv(_gathered(t, 2), rep) for t in (k, v))
    k, v = (t.redistribute(t.device_mesh, places) for t in (k, v))
    o = fn(q.to_local(), k.to_local(), v.to_local(), **kw).contiguous()
    return from_local(o, q.device_mesh, places, (*q.shape[:3], v.shape[3]))


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


def _scaled(scores, d: int, scale):
    """Scores times ``scale``; None divides by √d, as every architecture
    but those with an attention multiplier does."""
    return scores / math.sqrt(d) if scale is None else scores * scale


def attention_dense(q, k, v, *, causal=True, window=None, q_offset=0,
                    scale=None):
    """Reference O(S^2)-memory attention. q (B,Sq,H,D), k/v (B,Sk,Hkv,D);
    scores times ``scale`` (None: 1/√D)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = _scaled(scores, d, scale)
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
                      chunk_q=1024, chunk_k=1024, scale=None):
    """Flash-style chunked attention in torch ops: the flash kernel's
    plain version over key blocks of ``chunk_k``, the softmax cast to v's
    type before its product with v, as in the reference.

    Memory is O(S · chunk_k) per (batch, head) instead of O(S²); blocks
    above the diagonal are masked, not skipped, as in the reference, whose
    query chunks all run at once, so ``chunk_q`` only has to divide S."""
    s, sk = q.shape[1], k.shape[1]
    assert s % chunk_q == 0 and sk % chunk_k == 0, (s, sk, chunk_q, chunk_k)
    return kfa.plain(q, k, v, causal=causal, window=window, block_k=chunk_k,
                     pv_type=v.dtype, scale=scale)


def attention_decode(q, k_cache, v_cache, valid_len, scale=None):
    """Single-token decode. q (B,1,H,D); caches (B,Smax,Hkv,D); valid_len =
    number of valid cache entries (the new token is already written), an
    int or a 0-d tensor on the device; scores times ``scale`` (None:
    1/√D).

    GQA is computed grouped, q (B,1,Hkv,rep,D) against the raw cache.  As
    in the reference, the scores are fp32 (the cache is upcast) and the
    softmax is cast to the cache's type before the product with v, so a
    bf16 cache gives a bf16 output.  Ring-buffer caches: once the buffer
    wraps every slot is valid and in-window, so ``kpos < valid_len`` is
    exact for both layouts."""
    b, _, h, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    if _cuts(q, 2, hkv):
        q = _gathered(q, 2)
    qg = q.reshape(b, 1, hkv, rep, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k_cache.float())
    scores = _scaled(scores, d, scale)
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
    # k/v stay gathered where their heads are cut: attention repeats
    # them to q's heads first
    q = heads(x @ p["wq"], b, s, h, hd)
    k = heads(x @ p["wk"], b, s, hkv, hd, split=False)
    v = heads(x @ p["wv"], b, s, hkv, hd, split=False)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    scale = cfg.attention_multiplier
    if impl == "dense":
        o = _attend(attention_dense, q, k, v, causal=True, window=window,
                    scale=scale)
    elif impl == "chunked":
        o = _attend(attention_chunked, q, k, v, causal=True, window=window,
                    chunk_q=min(chunk, s), chunk_k=min(chunk, s), scale=scale)
    elif impl == "kernel":
        o = kops.flash_attention(q, k, v, causal=True, window=window,
                                 scale=scale)
    else:
        raise ValueError(impl)
    return merge_heads(o, b, s, h * hd) @ p["wo"], (k, v)


def gqa_decode(p, x, cache_k, cache_v, length, cos, sin, cfg: ArchConfig,
               *, impl="dense"):
    """x (B,1,D) at position ``length`` (an int, or a 0-d tensor on the
    device).  Writes the new kv at the position's slot (the position, or
    position % window for ring buffers) into the caches **in place** and
    attends over the valid entries (:func:`~repro_torch.kernels.
    decode_attention.ring_slot`).  Returns (out, cache_k, cache_v).

    ``impl="dense"`` runs the rope, the slot writes and the attention op
    by op; ``impl="kernel"`` runs them as one
    :func:`repro_torch.kernels.ops.decode_attention` call, which derives
    the slot and the valid keys from the position itself; a ``DTensor``
    raises there."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = heads(x @ p["wq"], b, 1, h, hd)
    k = heads(x @ p["wk"], b, 1, hkv, hd, split=False)
    v = heads(x @ p["wv"], b, 1, hkv, hd, split=False)
    ring = cfg.sliding_window is not None
    if impl == "kernel":
        o = kops.decode_attention(q[:, 0], k[:, 0], v[:, 0], cache_k,
                                  cache_v, length, cos, sin, ring=ring,
                                  scale=cfg.attention_multiplier)
        o = o.to(torch.promote_types(cache_v.dtype, p["wo"].dtype))
        return o @ p["wo"], cache_k, cache_v
    if impl != "dense":
        raise ValueError(f"decode takes impl 'dense' or 'kernel', got "
                         f"{impl!r}")
    write_idx, valid_len = ring_slot(length, cache_k.shape[1], ring)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    write_slot(cache_k, write_idx, k[:, 0])
    write_slot(cache_v, write_idx, v[:, 0])
    o = attention_decode(q, cache_k, cache_v, valid_len,
                         cfg.attention_multiplier)
    o = merge_heads(o, b, 1, h * hd).to(torch.promote_types(o.dtype,
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
    q = heads(cq @ p["wq_b"], b, s, h, m.qk_nope_dim + m.qk_rope_dim)
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
    kvx = heads(c_kv @ p["wkv_b"], b, s, h, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = torch.split(kvx, [m.qk_nope_dim, m.v_head_dim], dim=-1)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_dim)], -1)
    if impl == "chunked":
        o = _attend(attention_chunked, q, k, v, causal=True,
                    chunk_q=min(chunk, s), chunk_k=min(chunk, s))
    else:
        o = _attend(attention_dense, q, k, v, causal=True)
    return (merge_heads(o, b, s, h * m.v_head_dim) @ p["wo"],
            (c_kv, k_rope))


def mla_decode(p, x, cache_ckv, cache_krope, length, cos, sin,
               cfg: ArchConfig):
    """Absorbed-matmul MLA decode: attention runs in the latent space, so
    the cache stays compressed, (B,Smax,kv_lora) + (B,Smax,rope) only.

    x (B,1,D).  Writes the new latents at ``length`` (an int or a 0-d
    tensor on the device) into the caches **in place** (no ring;
    ``length < Smax``: torch indexing raises where the reference's
    ``dynamic_update_slice`` clamps) and attends over
    ``length + 1`` entries.  As in the reference, the scores are fp32, the
    softmax is cast to the cache's type before its product with ``c_kv``
    (a bf16 cache gives a bf16 ``o_lat``), and ``o_lat`` is then widened
    to ``w_uv``'s type.  Returns (out, cache_ckv, cache_krope)."""
    m, h = cfg.mla, cfg.n_heads
    b = x.shape[0]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cos, sin, cfg)
    write_slot(cache_ckv, length, c_kv[:, 0])
    write_slot(cache_krope, length, k_rope[:, 0])
    w_kv = heads(p["wkv_b"], m.kv_lora_rank, h, m.qk_nope_dim + m.v_head_dim)
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
    o = merge_heads(o, b, 1, h * m.v_head_dim)
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
    """The router is fp32 whatever ``dtype``, as in the reference; it
    scores every expert, and the expert stacks hold the ``moe.held``
    experts this layer computes."""
    m, d = cfg.moe, cfg.d_model
    out_scale = 0.02 / math.sqrt(2.0 * cfg.n_layers)
    p = {
        "router": _init(generator, (d, m.n_experts), 0.02, torch.float32,
                        device),
        "w_gate": _init(generator, (m.held, d, m.d_expert), 0.02, dtype,
                        device),
        "w_up": _init(generator, (m.held, d, m.d_expert), 0.02, dtype,
                      device),
        "w_down": _init(generator, (m.held, m.d_expert, d), out_scale,
                        dtype, device),
    }
    if m.dense_residual:
        p["dense"] = ffn_init(generator, cfg, dtype, device)
    return p


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Rows an expert takes from ``n_tokens`` tokens: all of them where
    the layer is dropless (a token's top-k experts are distinct, so none
    is dropped), else the capacity factor's share, at least 8."""
    m = cfg.moe
    if m.dropless:
        return n_tokens
    c = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)          # round up to multiple of 8


def _one_hot(ids, n: int):
    """``F.one_hot(ids, n)`` as int32, written as a comparison: the same
    integers, without the range check that reads ``ids`` on the host on
    the CPU."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(
        torch.int32)


def _dispatch_positions(flat_ids, n_experts: int):
    """Position of each (token, slot) within its expert's arrival order:
    the reference's cumsum over a one-hot, in integers (its fp32 cumsum is
    exact at these counts, so the positions are the same).

    flat_ids (..., N) int -> pos (..., N) int32."""
    oh = _one_hot(flat_ids, n_experts)
    csum = torch.cumsum(oh, dim=-2, dtype=torch.int32)        # inclusive
    pos = torch.gather(csum, -1, flat_ids.long()[..., None])[..., 0] - 1
    return pos.to(torch.int32)


_COUNTING = threading.local()


def moe_counter():
    """The counter :func:`counting` installed on this thread, or None."""
    return getattr(_COUNTING, "counter", None)


@contextlib.contextmanager
def counting(counter):
    """Installs ``counter``, a 0-d int64 tensor (None: nothing is
    counted), on this thread until the block ends: each expert layer adds
    to it, on the device, the (token, held expert) pairs it routes, so a
    step captured under it adds them at every replay."""
    was = moe_counter()
    _COUNTING.counter = counter
    try:
        yield counter
    finally:
        _COUNTING.counter = was


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


def _moe_dispatch(router, x, cfg: ArchConfig, groups: int):
    """Route ``groups`` groups of x's tokens and scatter them into one
    (G, E, C, D) capacity buffer of the E = ``moe.held`` experts the layer
    holds (a (token, j) sent to an absent expert is dropped as one past
    capacity is).  Returns (buffer, flat slot of each (token, j) in a flat
    (G·(E·C + 1), D) buffer, gates, and the router's statistics: the mean
    of ``probs`` over the tokens, the share of first choices per expert,
    the mean squared log-sum-exp and the share of kept slots), and the
    kept (token, j) pairs, a 0-d int64 tensor."""
    m = cfg.moe
    b, s, d = x.shape
    g, e, k = groups, m.held, m.top_k
    tg = b * s // g
    xf = x.reshape(g, tg, d)
    logits, probs, gate, ids = moe_route({"router": router}, xf, k)

    cap = moe_capacity(cfg, tg)
    pos = _dispatch_positions(ids.reshape(g, tg * k),
                              m.n_experts).reshape(g, tg, k)
    keep = pos < cap
    if e < m.n_experts:
        keep = keep & (ids < e)
    kept = keep.sum()
    slot = torch.where(keep, ids * cap + pos, e * cap)
    rows = e * cap + 1
    # one flat buffer; group i's rows start at i · rows
    flat = slot + (torch.arange(g, device=x.device) * rows)[:, None, None]
    buf = torch.zeros((g * rows, d), dtype=x.dtype, device=x.device)
    src = xf.reshape(g * tg, d)
    for j in range(k):                                       # k small
        buf.index_copy_(0, flat[:, :, j].reshape(-1), src)
    eb = buf.reshape(g, rows, d)[:, :-1].reshape(g, e, cap, d)
    stats = (probs.mean((0, 1)),                             # (E,)
             _one_hot(ids[..., 0], m.n_experts).float().mean((0, 1)),
             torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
             kept / keep.numel())
    return eb, flat, gate, stats, kept


def _moe_combine(out, flat, gate, shape, dtype):
    """The combine: ``gate_j · out[slot_j]`` summed in fp32 in j order,
    cast once, each dropped slot gathering the zero spare row."""
    g, e, cap, d = out.shape
    out_flat = torch.cat([out.reshape(g, e * cap, d),
                          torch.zeros((g, 1, d), dtype=out.dtype,
                                      device=out.device)], 1).reshape(-1, d)
    y = torch.zeros((g, flat.shape[1], d), dtype=torch.float32,
                    device=out.device)
    for j in range(flat.shape[2]):
        y = y + gate[:, :, j:j + 1] * out_flat[flat[:, :, j]].float()
    return y.to(dtype).reshape(shape)


def _moe_local(x, router, groups: int):
    """The dispatch and combine of a ``DTensor`` x under ``local_map``:
    each rank takes the groups of its own batch rows (GShard's
    group-local dispatch, the reference's ``rules.moe_groups``), so the
    routing, the scatter and the gather stay on the rank.  Where the
    groups do not split over the batch shards (one group for a decode
    step's few tokens), x's batch is gathered and every rank routes all
    of it.  Returns (dispatch(cfg) -> DTensors, combine(out, ...) ->
    y), both run by the caller."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    n = 1
    for width, pl in zip(mesh.shape, x.placements):
        n *= width if pl == Shard(0) else 1
    split = groups % n == 0
    x = _placed(x, lambda pl: pl if split and pl == Shard(0)
                else Replicate())
    rows = list(x.placements)                      # batch/group dim 0
    rep = [Replicate()] * mesh.ndim
    # each rank's router gradient sums its own rows only
    summed = [Partial() if pl == Shard(0) else Replicate() for pl in rows]
    router = _placed(router, lambda pl: Replicate())
    local_groups = groups // n if split else groups

    def dispatch(cfg):
        # each rank's statistics are one row of an (n, ...) stack whose
        # mean is taken as a DTensor op, so that their gradient reaches
        # every rank's share (a Partial("avg") output's would not be
        # scaled by 1/n)
        def local(xl, r):
            eb, flat, gate, stats, _ = _moe_dispatch(r, xl, cfg,
                                                     local_groups)
            return (eb, flat, gate, *(st[None] for st in stats))

        eb, flat, gate, *stats = local_map(
            local, out_placements=(rows,) * 7, in_placements=(rows, rep),
            in_grad_placements=(rows, summed), device_mesh=mesh)(x, router)
        return eb, flat, gate, tuple(st.mean(0) for st in stats)

    def combine(out, flat, gate):
        out = _placed(out, lambda pl: pl if pl == Shard(0)
                      else Replicate())
        out = out.redistribute(mesh, rows)
        return local_map(
            lambda o, f, g_: _moe_combine(o, f, g_, (
                x.to_local().shape), x.dtype),
            out_placements=rows, in_placements=(rows, rows, rows),
            device_mesh=mesh)(out, flat, gate)

    return dispatch, combine


def _moe_forward_grouped(p, x, cfg: ArchConfig, shard_experts, groups: int):
    """Group-local capacity dispatch (see :func:`moe_forward`); one group
    is the reference's ungrouped path.

    Every (token, slot) past its expert's capacity is written to the one
    spare row ``n_experts · cap`` of its group's buffer, which is thrown
    away (``index_copy_`` with that duplicate index is nondeterministic in
    that row only), and gathers the zero row there.  The combine sums
    ``gate_j · out[slot_j]`` in fp32 in j order and casts once.

    On ``DTensor``s the dispatch and the combine run on each rank's own
    groups under ``local_map`` (:func:`_moe_local`), DTensor having no
    sharding strategy for the top-k sort, the cumsum and the scatter;
    the expert products between them run on the experts' model shards as
    the buffer's constraint lays them out.

    Under :func:`counting` a plain tensor's kept (token, slot) pairs are
    added to the counter after the layer's regions (a ``DTensor``'s are
    not counted)."""
    m = cfg.moe
    with region("moe.route"):
        if is_dtensor(x):
            dispatch, combine = _moe_local(x, p["router"], groups)
            eb, flat, gate, stats = dispatch(cfg)
            routed = None
        else:
            eb, flat, gate, stats, routed = _moe_dispatch(p["router"], x,
                                                          cfg, groups)
        # aux losses: switch load-balance + router z-loss
        me, ce, z, kept = stats
        aux = {
            "lb_loss": m.router_aux_coef * m.n_experts * torch.sum(me * ce),
            "z_loss": m.router_z_coef * z,
            "dropped_frac": 1.0 - kept,
        }
    with region("moe.experts"):
        eb = _constrain(shard_experts, eb)
        hg = torch.einsum("gecd,edf->gecf", eb, p["w_gate"])
        hu = torch.einsum("gecd,edf->gecf", eb, p["w_up"])
        out = _constrain(shard_experts, torch.einsum(
            "gecf,efd->gecd", silu(hg) * hu, p["w_down"]))
        if is_dtensor(x):
            y = combine(out, flat, gate)
        else:
            y = _moe_combine(out, flat, gate, x.shape, x.dtype)
    if m.dense_residual:
        with region("moe.shared"):
            y = y + ffn_forward(p["dense"], x, cfg.ffn_kind)
    counter = moe_counter()
    if counter is not None and routed is not None:
        counter.add_(routed)        # outside the regions: no layer's work
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
    slices (no convolution library, so no TF32).  On ``DTensor``s it runs
    on each rank's batch rows (:func:`_on_rows`): DTensor's ``pad`` fails
    to plan its redistribution on some torch versions."""
    if is_dtensor(xbc):
        return _on_rows(lambda *a: (_causal_conv(*a),), (xbc,),
                        (conv_w, conv_b))[0]
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
    as the reference's Pallas entry point does.  ``DTensor``s are scanned
    on each rank's batch rows (:func:`_on_rows`).
    """
    assert xh.shape[1] % chunk == 0, (xh.shape[1], chunk)
    if is_dtensor(xh):
        # on each rank's batch rows: the cumsum's backward (a flip) has
        # no DTensor strategy on some torch versions
        out = _on_rows(lambda x_, dt_, b_, c_, a_, d_: ssd_chunked(
            x_, dt_, a_, b_, c_, d_, chunk, return_state=True),
            (xh, dt, B_, C_), (A, D))
        return out if return_state else out[0]
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
        # a copy: a view of the tail would keep the layer's whole
        # in-projection alive in the cache until the prefill ends
        conv_state = xbc_raw[:, -k:, :].clone() if sl >= k else F.pad(
            xbc_raw, (0, 0, k - sl, 0))
        return out, (final, conv_state.to(x.dtype))
    return out


def ssm_in_place(impl: str, ssm_state) -> bool:
    """Whether :func:`ssm_decode` at ``impl`` updates the states in place
    (``impl="kernel"`` on a plain tensor) rather than returning new ones."""
    return impl == "kernel" and not is_dtensor(ssm_state)


def ssm_decode(p, x, ssm_state, conv_state, cfg: ArchConfig, *,
               impl="dense"):
    """Stateful single-token decode.

    x (B,1,D); ssm_state (B,nh,hd,ds) float32; conv_state (B,d_conv-1,
    conv_dim).  Returns (y, new_ssm_state, new_conv_state).  Op by op
    (``impl="dense"``, or a ``DTensor`` state) the states are new tensors
    (the caller stores them); the new conv state has the promoted type of
    the old one and x, as in the reference.  Where :func:`ssm_in_place`,
    the conv window's step, dt, the state update and y are one
    :func:`repro_torch.kernels.ops.ssm_decode` call, which updates
    ``ssm_state`` and ``conv_state`` in place and returns them: a conv
    state narrower than x raises, so the caller widens it first.
    """
    s = cfg.ssm
    z, xbc, dt_raw = _ssm_split(p, x, cfg)
    args = (xbc[:, 0], dt_raw[:, 0], conv_state, ssm_state, p["conv_w"],
            p["conv_b"], p["dt_bias"], p["A_log"], p["D"])
    if ssm_in_place(impl, ssm_state):
        y = kops.ssm_decode(*args, n_groups=s.n_groups)
        new_state, new_conv = ssm_state, conv_state
    else:
        y, new_state, new_conv = kssm.step(*args, n_groups=s.n_groups)
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


def hybrid_decode(p, x, cache, length, cos, sin, cfg: ArchConfig, *,
                  impl="dense"):
    """``cache`` holds this layer's k, v (updated in place), ssm and conv;
    returns (y, {"k", "v", "ssm", "conv"}) with the new ssm and conv
    states (``cache``'s own, updated in place, where
    :func:`ssm_in_place`).  ``length`` and ``impl`` as :func:`gqa_decode`
    and :func:`ssm_decode` take them."""
    a, ck, cv = gqa_decode(p["attn"], x, cache["k"], cache["v"], length,
                           cos, sin, cfg, impl=impl)
    with region("mixer.ssm"):
        m, st, conv = ssm_decode(p["ssm"], x, cache["ssm"], cache["conv"],
                                 cfg, impl=impl)
    y = 0.5 * (rms_norm(a, p["attn_norm"], cfg.norm_eps)
               + rms_norm(m, p["ssm_norm_out"], cfg.norm_eps))
    return y, {"k": ck, "v": cv, "ssm": st, "conv": conv}
