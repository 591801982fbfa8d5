"""The port's M-RoPE and embedding frontend (qwen2-vl-2b) against the
reference on the CPU: ``mrope_cos_sin`` with distinct (t, h, w) positions,
and the model's forward, prefill and decode on patch embeddings.

Tolerance 1e-6 for the rotary tables (the same fp32 products), 2e-3 for
the model, that of ``tests/test_serve.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve.engine import prefill_with_cache as jprefill
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import prefill_with_cache

ARCH = "qwen2-vl-2b"
MODEL_TOL = dict(atol=2e-3, rtol=2e-3)


def _grid_positions(b, grid, n_text):
    """An image of ``grid``×``grid`` patches at t = 0 with (h, w) grid
    positions, then text continuing on all three axes from the grid's
    maximum + 1: the three axes differ over the image."""
    hh, ww = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    img = np.stack([np.zeros(grid * grid, int), hh.ravel(), ww.ravel()])
    start = grid
    txt = np.tile(np.arange(start, start + n_text), (3, 1))
    pos = np.concatenate([img, txt], axis=1)[:, None]
    return np.repeat(pos, b, axis=1).astype(np.int32)


@pytest.mark.parametrize("arch_width", [("reduced", 16, (2, 3, 3)),
                                        ("full", 128, (16, 24, 24))])
def test_mrope_cos_sin_matches_the_reference(arch_width):
    _, head_dim, sections = arch_width
    pos = _grid_positions(2, 4, 8)
    pos[1] += 3                                   # shift the h axis
    want_c, want_s = JL.mrope_cos_sin(jnp.asarray(pos), head_dim, 1e6,
                                      sections)
    got_c, got_s = TL.mrope_cos_sin(torch.from_numpy(pos), head_dim, 1e6,
                                    sections)
    assert tuple(got_c.shape) == (2, 24, head_dim // 2)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-6)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6)
    # each section follows its own axis: over the image, the h section
    # equals plain RoPE at the h positions, not at the t positions
    t_sec = sections[0]
    h_rope, _ = TL.rope_cos_sin(torch.from_numpy(pos[1]), head_dim, 1e6)
    np.testing.assert_allclose(
        got_c[..., t_sec:t_sec + sections[1]].numpy(),
        h_rope[..., t_sec:t_sec + sections[1]].numpy(), atol=1e-6)
    t_rope, _ = TL.rope_cos_sin(torch.from_numpy(pos[0]), head_dim, 1e6)
    assert not np.allclose(got_c[:, :16].numpy(), t_rope[:, :16].numpy())


def _carried():
    cfg = get_arch(ARCH).reduced()
    tcfg = tconfigs.get_arch(ARCH).reduced()
    jp = JT.init_params(jax.random.key(0), cfg, jnp.float32)
    tp = convert.load_reference_params(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return cfg, tcfg, jp, tp


def _inputs(cfg, b, grid, n_text, seed):
    s = grid * grid + n_text
    emb = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return {"embeds": emb, "positions": _grid_positions(b, grid, n_text)}


def _both(arr, lo=None, hi=None):
    if lo is not None:
        arr = {"embeds": arr["embeds"][:, lo:hi],
               "positions": arr["positions"][:, :, lo:hi]}
    return ({k: jnp.asarray(v) for k, v in arr.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in arr.items()})


def test_embeddings_model_has_no_embed_table():
    _, tcfg, jp, tp = _carried()
    assert "embed" not in tp and "embed" not in jp
    assert "embed" not in TT.init_params(tcfg, device="cpu")
    assert "head" in tp


@pytest.mark.parametrize("impl", [("dense", "dense"), ("chunked", "chunked"),
                                  ("kernel", "pallas")])
def test_forward_on_embeddings_matches_the_reference(impl):
    cfg, tcfg, jp, tp = _carried()
    jin, tin = _both(_inputs(cfg, 2, 4, 16, 1))
    want, _ = JT.forward(jp, cfg, jin, impl=impl[1], chunk=16, remat=False)
    got, aux = TT.forward(tp, tcfg, tin, impl=impl[0], chunk=16)
    assert aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_on_embeddings_match_the_reference(cache_dtype):
    """Prefill a 4×4 grid and 8 text positions, then decode 4 steps with
    (3,B,1) positions continuing the text: logits and caches."""
    cfg, tcfg, jp, tp = _carried()
    jd, td = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    seq = _inputs(cfg, 2, 4, 12, 2)
    S, N = 24, 4
    jin, tin = _both(seq, 0, S)
    want, jc = jprefill(jp, cfg, jin, max_len=S + N, cache_dtype=jd)
    got, tc = prefill_with_cache(tp, tcfg, tin, max_len=S + N,
                                 impl="kernel", cache_dtype=td)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    for i in range(N):
        jin, tin = _both(seq, S + i, S + i + 1)
        jin["length"] = jnp.asarray(S + i, jnp.int32)
        tin["length"] = S + i
        want, jc = JT.decode_step(jp, cfg, jc, jin)
        got, tc = TT.decode_step(tp, tcfg, tc, tin)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
    for name in jc:
        assert tc[name].dtype == td
        np.testing.assert_allclose(tc[name].float().numpy(),
                                   np.asarray(jc[name], np.float32),
                                   err_msg=name, **MODEL_TOL)


def test_decode_matches_the_full_forward_on_embeddings():
    """The port alone: each decode step's logits equal the full forward's
    at that position (prefill 16 + 4 steps, fp32 cache)."""
    _, tcfg, _, tp = _carried()
    seq = _inputs(tcfg, 1, 4, 4, 3)
    _, full_in = _both(seq)
    full, _ = TT.forward(tp, tcfg, full_in)
    _, cache = prefill_with_cache(tp, tcfg, _both(seq, 0, 16)[1],
                                  max_len=20, cache_dtype=torch.float32)
    for i in range(4):
        tin = _both(seq, 16 + i, 17 + i)[1]
        tin["length"] = 16 + i
        lg, cache = TT.decode_step(tp, tcfg, cache, tin)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 16 + i].numpy(),
                                   **MODEL_TOL)
