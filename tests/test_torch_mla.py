"""The port's MLA (minicpm3-4b's multi-head latent attention) against the
reference on the CPU: the layer's prefill expansion (dense and chunked),
its absorbed-matmul decode over fp32 and bf16 latent caches, the
``"kernel"`` impl (dense attention, as the reference's ``"pallas"``), and
``tests/test_serve.py``'s multi-token incremental decode through the port.

Tolerance 1e-5 for the layer (one block of fp32 sums taken in another
order) and 2e-3 for the model, that of ``tests/test_serve.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import prefill_with_cache

ARCH = "minicpm3-4b"
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-3, rtol=2e-3)


def _layer(seed=0):
    """One MLA layer's weights made by the reference, carried across."""
    cfg = get_arch(ARCH).reduced()
    jp = JL.mla_init(jax.random.key(seed), cfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return cfg, tconfigs.get_arch(ARCH).reduced(), jp, tp


def _rope(cfg, positions):
    pos = np.asarray(positions)
    jcs = JL.rope_cos_sin(jnp.asarray(pos), cfg.mla.qk_rope_dim,
                          cfg.rope_theta)
    tcs = TL.rope_cos_sin(torch.from_numpy(pos), cfg.mla.qk_rope_dim,
                          cfg.rope_theta)
    return jcs, tcs


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_mla_forward_matches_the_reference(impl):
    cfg, tcfg, jp, tp = _layer()
    x = np.random.default_rng(0).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    (jc, js), (tc, ts) = _rope(cfg, np.arange(32))
    want, (wckv, wkr) = JL.mla_forward(jp, jnp.asarray(x), jc, js, cfg,
                                       impl=impl, chunk=8)
    got, (gckv, gkr) = TL.mla_forward(tp, torch.from_numpy(x), tc, ts, tcfg,
                                      impl=impl, chunk=8)
    assert got.shape == want.shape == (2, 32, cfg.d_model)
    assert tuple(gckv.shape) == (2, 32, cfg.mla.kv_lora_rank)
    assert tuple(gkr.shape) == (2, 32, cfg.mla.qk_rope_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(gckv.numpy(), np.asarray(wckv), **LAYER_TOL)
    np.testing.assert_allclose(gkr.numpy(), np.asarray(wkr), **LAYER_TOL)


def test_mla_kernel_impl_is_dense_attention():
    """``impl="kernel"`` launches no flash kernel for MLA (v is narrower
    than q/k) and gives the dense path's bits, as the reference's
    ``"pallas"`` does."""
    cfg, tcfg, _, tp = _layer(1)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    _, (tc, ts) = _rope(cfg, np.arange(24))
    before = tfa.LAUNCHES["flash_attention"].count
    got, _ = TL.mla_forward(tp, x, tc, ts, tcfg, impl="kernel")
    want, _ = TL.mla_forward(tp, x, tc, ts, tcfg, impl="dense")
    assert tfa.LAUNCHES["flash_attention"].count == before
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        TL.mla_forward(tp, x, tc, ts, tcfg, impl="pallas")


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_the_reference(cache_dtype):
    """Three absorbed decode steps over a cache holding 10 random latents:
    outputs and both caches after each step.  A bf16 cache gives a bf16
    softmax·c_kv product widened by the fp32 ``w_uv``, on both sides."""
    cfg, tcfg, jp, tp = _layer(2)
    rng = np.random.default_rng(2)
    smax, filled = 16, 10
    ckv = rng.standard_normal((2, smax, cfg.mla.kv_lora_rank)).astype(
        np.float32)
    kr = rng.standard_normal((2, smax, cfg.mla.qk_rope_dim)).astype(
        np.float32)
    ckv[:, filled:] = 0.0
    kr[:, filled:] = 0.0
    jd = getattr(jnp, cache_dtype)
    td = getattr(torch, cache_dtype)
    jckv, jkr = jnp.asarray(ckv, jd), jnp.asarray(kr, jd)
    tckv = torch.from_numpy(ckv).to(td)
    tkr = torch.from_numpy(kr).to(td)
    for step in range(3):
        length = filled + step
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        (jc, js), (tc, ts) = _rope(cfg, [length])
        want, jckv, jkr = JL.mla_decode(jp, jnp.asarray(x), jckv, jkr,
                                        jnp.asarray(length, jnp.int32),
                                        jc[None], js[None], cfg)
        got, tckv, tkr = TL.mla_decode(tp, torch.from_numpy(x), tckv, tkr,
                                       length, tc[None], ts[None], tcfg)
        assert got.dtype == torch.float32 and tckv.dtype == td
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LAYER_TOL)
        np.testing.assert_allclose(
            tckv.float().numpy(), np.asarray(jckv, np.float32), **LAYER_TOL)
        np.testing.assert_allclose(
            tkr.float().numpy(), np.asarray(jkr, np.float32), **LAYER_TOL)


def test_mla_decode_past_the_cache_raises():
    """No ring: a write at ``length == Smax`` raises in the port, where
    the reference's ``dynamic_update_slice`` clamps to the last slot."""
    cfg, tcfg, _, tp = _layer(3)
    ckv = torch.zeros((1, 4, cfg.mla.kv_lora_rank))
    kr = torch.zeros((1, 4, cfg.mla.qk_rope_dim))
    _, (tc, ts) = _rope(cfg, [4])
    with pytest.raises(IndexError):
        TL.mla_decode(tp, torch.zeros((1, 1, cfg.d_model)), ckv, kr, 4,
                      tc[None], ts[None], tcfg)


def test_mla_rotates_qk_rope_dim_only():
    cfg = tconfigs.get_arch(ARCH)
    assert TT._rope_dim(cfg) == cfg.mla.qk_rope_dim == 32
    assert cfg.head_dim == 64 and TT._rope_dim(
        tconfigs.get_arch("internlm2-1.8b")) == 128


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-130m",
                                  "hymba-1.5b", "minicpm3-4b"])
def test_multi_token_incremental_decode(arch):
    """``tests/test_serve.py``'s case through the port alone: decode 6
    tokens sequentially after a 12-token prefill; each step's logits match
    the port's full forward, on weights carried from the reference."""
    cfg = get_arch(arch).reduced()
    tcfg = tconfigs.get_arch(arch).reduced()
    params = convert.load_reference_params(
        jax.tree_util.tree_map(
            np.asarray, JT.init_params(jax.random.key(0), cfg, jnp.float32)),
        tcfg, device="cpu")
    B, S, N = 1, 12, 6
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S + N)))
    full, _ = TT.forward(params, tcfg, {"tokens": toks}, remat=False)
    _, cache = prefill_with_cache(params, tcfg, {"tokens": toks[:, :S]},
                                  max_len=S + N, cache_dtype=torch.float32)
    for i in range(N):
        lg, cache = TT.decode_step(params, tcfg, cache,
                                   {"tokens": toks[:, S + i:S + i + 1],
                                    "length": S + i})
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, S + i].numpy(),
                                   **MODEL_TOL)
