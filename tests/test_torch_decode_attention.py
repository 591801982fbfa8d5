"""The fused decode attention's plain version on the CPU: against the
port's op-by-op step (two ``apply_rope``, two ``write_slot``,
``attention_decode``) and against the reference's ``gqa_decode``, on the
same numpy inputs; ``decode_step(impl="kernel")`` against
``impl="dense"``; and what ``impl="kernel"`` refuses.

Tolerances: those of ``tests/test_torch_attention.py``, 2e-5 in fp32 and
5e-2 where a bf16 cache rounds the softmax and the output (the two sides
add in another order).  The cache rows written must be equal: both round
the same roped values."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro_torch import configs as tconfigs
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

B, S, HKV, DM = 2, 24, 2, 64
# (head_dim, query heads a kv group, cache type, rope, ring buffer)
CASES = [
    (64, 1, "fp32", "shared", False),
    (64, 5, "bf16", "shared", True),
    (64, 16, "bf16", "rows", False),
    (128, 1, "bf16", None, True),
    (128, 5, "fp32", "rows", False),
    (128, 16, "bf16", "shared", True),
    (192, 1, "bf16", "rows", False),
    (192, 5, "bf16", None, False),
    (192, 16, "fp32", "shared", True),
]
# positions: one valid key, mid-cache, a full cache, past a ring's wrap
POSITIONS = {"one": 0, "mid": S // 2 + 1, "full": S - 1, "wrapped": S + 5}
GRID = [(case, where) for case in CASES for where in POSITIONS
        if where != "wrapped" or case[4]]
TYPES = {"fp32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(cache):
    return dict(atol=5e-2, rtol=5e-2) if cache == "bf16" \
        else dict(atol=2e-5, rtol=2e-5)


def _configs(d, rep, rope, ring):
    """The reference's and the port's GQA config at these widths."""
    kw = dict(n_heads=HKV * rep, n_kv_heads=HKV, d_head=d, d_model=DM,
              sliding_window=S if ring else None,
              pos_kind="rope" if rope else "none")
    return (dataclasses.replace(
        jconfigs.get_arch("internlm2-1.8b").reduced(), **kw),
        dataclasses.replace(
        tconfigs.get_arch("internlm2-1.8b").reduced(), **kw))


def _inputs(case, seed=0):
    """numpy x (B,1,DM), the four projections, both caches, cos/sin."""
    d, rep, _, rope, _ = case
    h = HKV * rep
    rng = np.random.default_rng(seed)
    w = {"wq": (DM, h * d), "wk": (DM, HKV * d), "wv": (DM, HKV * d),
         "wo": (h * d, DM)}
    p = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in w.items()}
    x = rng.standard_normal((B, 1, DM)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S, HKV, d)).astype(np.float32)
              for _ in range(2))
    cos = sin = None
    if rope is not None:
        ang = rng.uniform(0, 6, (B if rope == "rows" else 1, 1, d // 2))
        cos, sin = (f(ang).astype(np.float32) for f in (np.cos, np.sin))
    return p, x, kc, vc, cos, sin


def _slot(n, ring):
    return (n % S, min(n + 1, S)) if ring else (n, n + 1)


@pytest.mark.parametrize("ring,where", [
    (ring, where) for ring in (False, True) for where in POSITIONS
    if where != "wrapped" or ring])
def test_ring_slot_on_host_and_device(ring, where):
    """``ring_slot`` gives the slot and the valid keys of a position as
    ints for an int and as 0-d tensors for a tensor, the same pair."""
    n = POSITIONS[where]
    want = _slot(n, ring)
    assert tda.ring_slot(n, S, ring) == want
    got = tda.ring_slot(torch.tensor(n), S, ring)
    assert all(torch.is_tensor(t) for t in got)
    assert tuple(int(t) for t in got) == want


@pytest.mark.parametrize("case,where", GRID)
def test_fused_plain_matches_op_by_op_and_reference(case, where):
    """One GQA layer's decode at every case and position: the fused path's
    plain version (``gqa_decode(impl="kernel")``) against the port's
    op-by-op ``gqa_decode`` and the reference's ``gqa_decode``: the layer's
    output within the tolerance, the caches after it equal (to the
    reference's within its rounding of the same values)."""
    d, rep, cache, rope, ring = case
    jd, td = TYPES[cache]
    jcfg, tcfg = _configs(d, rep, rope, ring)
    p, x, kc, vc, cos, sin = _inputs(case)
    n = POSITIONS[where]
    widx, valid = _slot(n, ring)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tcos, tsin = ((None, None) if cos is None
                  else (torch.from_numpy(cos), torch.from_numpy(sin)))
    fused_k, fused_v = (torch.from_numpy(c).to(td) for c in (kc, vc))
    calls = []
    plain = tda.plain

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)
    tda.plain = counted
    try:
        got, _, _ = TL.gqa_decode(tp, torch.from_numpy(x), fused_k, fused_v,
                                  torch.tensor(n), tcos, tsin, tcfg,
                                  impl="kernel")
    finally:
        tda.plain = plain
    assert calls == [1]
    dense_k, dense_v = (torch.from_numpy(c).to(td) for c in (kc, vc))
    want, _, _ = TL.gqa_decode(tp, torch.from_numpy(x), dense_k, dense_v, n,
                               tcos, tsin, tcfg)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(fused_k, dense_k) and torch.equal(fused_v, dense_v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **_tol(cache))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jcos, jsin = ((None, None) if cos is None
                  else (jnp.asarray(cos), jnp.asarray(sin)))
    jout, jk, jv = JL.gqa_decode(jp, jnp.asarray(x), jnp.asarray(kc, jd),
                                 jnp.asarray(vc, jd), widx, valid, jcos,
                                 jsin, jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), **_tol(cache))
    for mine, ref in ((fused_k, jk), (fused_v, jv)):
        np.testing.assert_allclose(mine.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   **_tol(cache))


@pytest.mark.parametrize("case", CASES[:3])
@pytest.mark.parametrize("where", ["one", "mid", "full"])
def test_ops_entry_point_matches_layers_pieces(case, where):
    """``ops.decode_attention`` on unroped q, k, v against the pieces it
    replaces, called in turn: ``apply_rope`` twice, ``write_slot`` twice,
    ``attention_decode``; (B, 1, H·D) in fp32 holding the cache's
    rounding."""
    d, rep, cache, rope, ring = case
    td = TYPES[cache][1]
    rng = np.random.default_rng(5)
    h = HKV * rep
    q = torch.from_numpy(rng.standard_normal((B, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, HKV, d)).astype(
        np.float32)) for _ in range(2))
    kc, vc = (torch.from_numpy(rng.standard_normal((B, S, HKV, d)).astype(
        np.float32)).to(td) for _ in range(2))
    _, _, _, _, cos, sin = _inputs(case)
    cos, sin = ((None, None) if cos is None
                else (torch.from_numpy(cos), torch.from_numpy(sin)))
    n = POSITIONS[where]
    widx, valid = _slot(n, ring)
    k1, v1 = kc.clone(), vc.clone()
    got = ops.decode_attention(q, k, v, k1, v1, n, cos, sin, ring=ring)
    qr, kr = q[:, None], k[:, None]
    if cos is not None:
        qr, kr = TL.apply_rope(qr, cos, sin), TL.apply_rope(kr, cos, sin)
    k2, v2 = kc.clone(), vc.clone()
    TL.write_slot(k2, torch.tensor(widx), kr[:, 0])
    TL.write_slot(v2, torch.tensor(widx), v)
    want = TL.attention_decode(qr, k2, v2, valid).reshape(B, 1, h * d)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert got.shape == (B, 1, h * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.float().numpy(),
                               **_tol(cache))


DECODE_ARCHS = ["hymba-1.5b", "internlm2-1.8b", "qwen2-vl-2b",
                "mistral-nemo-12b", "musicgen-medium"]


def _step_inputs(cfg, n, g):
    inp = {"length": torch.tensor(n, dtype=torch.int32)}
    if cfg.input_mode == "embeddings":
        inp["embeds"] = torch.randn((B, 1, cfg.d_model), generator=g)
    else:
        shape = (B, 1, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, 1)
        inp["tokens"] = torch.randint(0, cfg.vocab_size, shape, generator=g)
    if cfg.pos_kind == "mrope":
        inp["positions"] = torch.full((3, B, 1), n, dtype=torch.int32)
    return inp


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step_kernel_matches_dense(arch):
    """``decode_step(impl="kernel")`` on a CPU cache against
    ``impl="dense"``, four steps from a filled bf16 cache, past hymba's
    16-slot ring: the logits within the fp32 tolerance at every step and
    every cache entry equal after each."""
    cfg = tconfigs.get_arch(arch).reduced()
    params = TT.init_params(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(2)
    cache = TT.init_cache(cfg, B, S, dtype=torch.bfloat16, device="cpu")
    for name, t in cache.items():
        cache[name] = torch.randn(t.shape, generator=g).to(
            torch.float32 if name == "conv" else t.dtype)
    dense = {k: v.clone() for k, v in cache.items()}
    start = 14 if cfg.sliding_window else S - 4
    for n in range(start, start + 4):
        inp = _step_inputs(cfg, n, g)
        got, cache = TT.decode_step(params, cfg, cache, inp, impl="kernel")
        want, dense = TT.decode_step(params, cfg, dense, inp)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                                   rtol=2e-5)
        for name, t in dense.items():
            assert torch.equal(cache[name], t), (arch, n, name)


def test_decode_step_refuses_an_unknown_impl():
    cfg = tconfigs.get_arch("internlm2-1.8b").reduced()
    params = TT.init_params(cfg, device="cpu", seed=0)
    cache = TT.init_cache(cfg, B, S, device="cpu")
    inp = _step_inputs(cfg, 3, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="impl"):
        TT.decode_step(params, cfg, cache, inp, impl="chunked")


@pytest.mark.parametrize("d", [40, 272])
def test_kernel_refuses_an_unsupported_head_dim(d):
    """A head_dim off the kernel's grid (a multiple of 16 up to 256) raises
    on either device's path, naming the limit."""
    q = torch.zeros((1, 4, d))
    k = v = torch.zeros((1, 2, d))
    kc = torch.zeros((1, 8, 2, d), dtype=torch.bfloat16)
    for fn in (ops.decode_attention, tda.launch):
        with pytest.raises(ValueError, match="multiple of 16"):
            fn(q, k, v, kc, kc.clone(), 3, None, None, ring=False)


def test_kernel_refuses_a_dtensor_cache():
    """``impl="kernel"`` on a DTensor cache raises: the kernel takes plain
    tensors, and a sharded cache decodes with ``impl="dense"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = tconfigs.get_arch("internlm2-1.8b").reduced()
    params = TT.init_params(cfg, device="cpu", seed=0)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0])
        cache = {k: DTensor.from_local(v, mesh, [Replicate()])
                 for k, v in TT.init_cache(cfg, B, S, device="cpu").items()}
        inp = _step_inputs(cfg, 3, torch.Generator().manual_seed(0))
        with pytest.raises(TypeError, match="DTensor"):
            TT.decode_step(params, cfg, cache, inp, impl="kernel")
        q = torch.zeros((B, cfg.n_heads, cfg.head_dim))
        k = torch.zeros((B, cfg.n_kv_heads, cfg.head_dim))
        with pytest.raises(TypeError, match="DTensor"):
            ops.decode_attention(q, k, k, cache["k"][0], cache["v"][0], 3,
                                 None, None, ring=False)
    finally:
        dist.destroy_process_group()
