"""The five archs that ``chip_smoke.py`` serves at full width since ROADMAP
A11, at their real head structures on the CPU (``zoo_heads.head_config``:
2 layers, narrow d_model and vocab; mistral-nemo 8/2 at D 128, nemotron
12/1 at D 192, arctic 14/2 at D 128 with top-2 and the dense residual,
musicgen 6/6 at D 64 over 4 codebooks, mamba2 with d_state 128 and 64-wide
heads), against the reference on weights carried across from it:

* the reference's ``prefill_with_cache(impl="pallas")``, its Pallas flash
  kernel in interpret mode, against the port's ``impl="kernel"`` (the
  plain versions on the CPU): prefill logits and every cache entry within
  2e-3, the tolerance of ``tests/test_torch_serve.py``;
* both ``BatchServer``s' greedy tokens, equal;
* the flash kernel's plain version against the reference's Pallas kernel
  at each arch's full head counts and D (64 tokens), and the SSD chunk
  scan's at mamba2's full widths;

and each phase's memory plan (``chip_smoke.serve_plan``) pinned: its fp32
parameter bytes counted on ``meta`` at the phase's depth, and its reckoned
peak under 75 GB, so that a config or depth edit fails here and not on the
card."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ssd import ssd_chunk_scan as jssd
from repro.models import transformer as JT
from repro.serve import BatchServer as JServer
from repro.serve import Request as JRequest
from repro.serve.engine import prefill_with_cache as jprefill
from repro_torch.configs import get_arch as tget_arch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as tssd
from repro_torch.models import convert
from repro_torch.models import transformer as TT
from repro_torch.serve import BatchServer, Request
from repro_torch.serve.engine import prefill_with_cache

from zoo_heads import ARCHS, full_heads, head_config

TOL = dict(atol=2e-3, rtol=2e-3)
ATTN_ARCHS = [a for a in ARCHS if a != "mamba2-130m"]
# the phases' fp32 parameter bytes at their depth, counted on meta
PARAM_BYTES = {"serve_mamba2": 516_007_680,
               "serve_musicgen": 5_537_077_248,
               "serve_mistral": 48_991_129_600,
               "serve_nemotron": 51_564_994_560,
               "serve_arctic": 56_279_781_376}


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _carried(arch):
    cfg, tcfg = head_config(jget_arch, arch), head_config(tget_arch, arch)
    jp = JT.init_params(jax.random.key(1), cfg, jnp.float32)
    tp = convert.load_reference_params(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return cfg, tcfg, jp, tp


def _tokens(cfg, rng, b, n):
    shape = (b, n, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, n)
    return rng.integers(0, cfg.vocab_size, shape)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_head_config_keeps_the_full_heads(arch):
    """Both packages build the same config, with the full arch's GQA
    group, head_dim, codebooks, top-k and dense residual, d_state and SSM
    head width."""
    cfg, full = head_config(tget_arch, arch), tget_arch(arch)
    jcfg = head_config(jget_arch, arch)
    assert cfg.n_layers == 2 and cfg.d_model == 64 and cfg.vocab_size == 256
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "n_codebooks",
                  "ffn_kind", "attn_kind", "tie_embeddings"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    for part in ("moe", "ssm"):
        if getattr(full, part) is not None:
            mine = dict(vars(getattr(cfg, part)))
            if part == "moe":
                # the port's expert share, which the reference lacks, at
                # its default: every expert held, capacity-bound routing
                assert (mine.pop("experts_held"), mine.pop("dropless")) == (
                    0, False)
            assert mine == vars(getattr(jcfg, part))
    if full.n_heads:
        assert cfg.n_heads // cfg.n_kv_heads == \
            full.n_heads // full.n_kv_heads
        assert cfg.head_dim == full.head_dim
    if full.moe is not None:
        assert (cfg.moe.top_k, cfg.moe.dense_residual) == \
            (full.moe.top_k, full.moe.dense_residual)
    if full.ssm is not None:
        assert (cfg.ssm.d_state, cfg.ssm.head_dim) == \
            (full.ssm.d_state, full.ssm.head_dim)
    assert cfg.n_codebooks == full.n_codebooks      # musicgen's 4


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_the_reference_at_full_heads(arch):
    """S = 64: two of mamba2's 32-token chunks; a bf16 cache, as the
    server keeps it."""
    cfg, tcfg, jp, tp = _carried(arch)
    toks = _tokens(cfg, np.random.default_rng(2), 2, 64)
    want, wcache = jprefill(jp, cfg, {"tokens": jnp.asarray(toks)},
                            max_len=72, impl="pallas",
                            cache_dtype=jnp.bfloat16)
    flash0 = tfa.LAUNCHES["flash_attention"].count
    got, gcache = prefill_with_cache(tp, tcfg,
                                     {"tokens": torch.from_numpy(toks)},
                                     max_len=72, impl="kernel",
                                     cache_dtype=torch.bfloat16)
    assert tfa.LAUNCHES["flash_attention"].count == flash0   # plain
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(gcache) == set(wcache)
    for name in wcache:
        assert tuple(gcache[name].shape) == wcache[name].shape, name
        np.testing.assert_allclose(_f32(gcache[name]), _f32(wcache[name]),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_server_tokens_equal_the_reference_at_full_heads(arch):
    """Two waves (prompt lengths 20 and 8) through both servers, 6 new
    tokens each; musicgen samples codebook 0 and repeats it over the 4."""
    cfg, tcfg, jp, tp = _carried(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 20, 20, 8, 8)]
    jserver = JServer(jp, cfg, n_slots=3, max_len=32)
    tserver = BatchServer(tp, tcfg, n_slots=3, max_len=32, device="cpu")
    for i, p in enumerate(prompts):
        jserver.submit(JRequest(request_id=f"r{i}", prompt=p,
                                max_new_tokens=6))
        tserver.submit(Request(request_id=f"r{i}", prompt=p,
                               max_new_tokens=6))
    want = jserver.run(max_requests=len(prompts), idle_timeout_s=0.5)
    got = tserver.run(max_requests=len(prompts), idle_timeout_s=0.5)
    assert [r.request_id for r in got] == [r.request_id for r in want]
    for a, b in zip(got, want):
        assert len(a.result_tokens) == 6
        assert a.result_tokens == b.result_tokens, a.request_id


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_flash_plain_matches_the_reference_kernel_at_full_heads(arch):
    """q (1, 64, H, D), k/v (1, 64, Hkv, D) at the full arch's head counts
    (query head h reads KV head h // (H // Hkv)), causal, fp32: 2e-5, the
    tolerance of tests/test_kernels.py."""
    h, hkv, d = full_heads(tget_arch, arch)
    assert full_heads(jget_arch, arch) == (h, hkv, d)
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 64, h, d)).astype(np.float32)
    k = rng.standard_normal((1, 64, hkv, d)).astype(np.float32)
    v = rng.standard_normal((1, 64, hkv, d)).astype(np.float32)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, interpret=True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_ssd_plain_matches_the_reference_kernel_at_mamba2_widths():
    """mamba2-130m's full widths, 24 heads of 64 on one B/C group of
    d_state 128, 64 tokens in two 32-token chunks: 2e-5 (both run the
    same chunked algorithm, tests/test_torch_ssd.py)."""
    full = tget_arch("mamba2-130m")
    m = full.ssm
    nh = m.expand * full.d_model // m.head_dim
    rng = np.random.default_rng(8)
    arrs = (rng.standard_normal((1, 64, nh, m.head_dim)).astype(np.float32),
            rng.uniform(0.001, 0.1, (1, 64, nh)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (nh,)).astype(np.float32),
            rng.standard_normal((1, 64, m.n_groups, m.d_state)
                                ).astype(np.float32),
            rng.standard_normal((1, 64, m.n_groups, m.d_state)
                                ).astype(np.float32),
            rng.standard_normal((nh,)).astype(np.float32))
    y_k, fin_k = jssd(*(jnp.asarray(a) for a in arrs), chunk=32,
                      interpret=True)
    before = tssd.LAUNCHES["ssd_chunk_scan"].count
    y, fin = ops.ssd_chunk_scan(*(torch.from_numpy(a) for a in arrs),
                                chunk=32)
    assert tssd.LAUNCHES["ssd_chunk_scan"].count == before
    assert (nh, m.d_state) == (24, 128)
    for got, want in ((y, y_k), (fin, fin_k)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("phase", sorted(PARAM_BYTES))
def test_zoo_phase_memory_plan(phase):
    """The plan of each ``ZOO_SERVE`` phase: the weights' bytes as pinned,
    and the reckoned peak under ``PLAN_LIMIT_BYTES`` (75 GB), 5 GB short
    of the card."""
    import dataclasses
    cs = _chip_smoke()
    (arch, layers, waves), = [row[1:] for row in cs.ZOO_SERVE
                              if row[0] == phase]
    full = tget_arch(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    plan = cs.serve_plan(torch, TT, cfg, waves)
    assert plan["params"] == PARAM_BYTES[phase]
    assert plan["peak"] < cs.PLAN_LIMIT_BYTES <= cs.CARD_BYTES - 5e9
    assert plan["peak"] > plan["params"] + plan["logits"]
    assert len(waves) == 2 and layers <= full.n_layers


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_prefill_conv_state_owns_its_memory(arch):
    """The SSM prefill's conv state is a copy of the in-projection's last
    d_conv - 1 positions, not a view: a view kept every layer's whole
    in-projection alive until the prefill stacked its cache (5.3 GB at
    mamba2-130m's 4,096-token wave on the card)."""
    from repro_torch.models import layers as TL
    cfg = (head_config(tget_arch, arch) if arch in ARCHS
           else tget_arch(arch).reduced())
    p = TT.init_params(cfg, device="cpu", seed=0)["blocks"][0]
    p = p["ssm"] if "ssm" in p else p["mixer"]["ssm"]
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator(
        ).manual_seed(0))
    _, (_, conv) = TL.ssm_forward(p, x, cfg, return_state=True,
                                  impl="kernel")
    assert conv.shape == (2, cfg.ssm.d_conv - 1, TL.ssm_dims(cfg)[2])
    assert conv.untyped_storage().nbytes() == \
        conv.numel() * conv.element_size()


# each phase's reckoned peak since its prefill goes through CUDA graphs
# (chip_smoke.serve_plan), in bytes
PLAN_PEAK_BYTES = {"serve_mamba2": 8_894_494_464,
                   "serve_musicgen": 31_860_660_224,
                   "serve_mistral": 74_846_916_608,
                   "serve_nemotron": 67_362_906_112,
                   "serve_arctic": 60_961_136_640}


@pytest.mark.parametrize("phase", sorted(PLAN_PEAK_BYTES))
def test_zoo_phase_memory_plan_holds_the_prefill_graphs(phase):
    """The plan reckons the prefill graphs' shared pool (each kept graph's
    last-position logits and cache, held from its wave on, and the widest
    wave's working set with its logits at every position) and an eager
    prefill beside it (the graph's warm-up, the eager check): the kernel
    run's peak holds both, the dense run's the dense path's transients;
    the larger is pinned, under 75 GB.  The pool holds no more graphs'
    outputs than a prefill function keeps, however many prompt lengths
    are served."""
    import dataclasses
    from repro_torch.serve.engine import MAX_PREFILL_GRAPHS
    cs = _chip_smoke()
    (arch, layers, waves), = [row[1:] for row in cs.ZOO_SERVE
                              if row[0] == phase]
    cfg = dataclasses.replace(tget_arch(arch), n_layers=layers)
    plan = cs.serve_plan(torch, TT, cfg, waves)
    cache, logits, last = plan["cache"], plan["logits"], plan["last_logits"]
    assert logits == last * max(waves)
    assert plan["prefill_graph_pool"] >= 2 * (cache + last) + cache + logits
    assert plan["eager_prefill"] >= logits + 2 * cache
    assert plan["kernel_run"] >= (plan["params"] + plan["prefill_graph_pool"]
                                  + plan["eager_prefill"])
    assert plan["dense_run"] >= (plan["params"] + 3 * cache + logits
                                 + 2 * plan["transient"])
    assert plan["peak"] == max(plan["kernel_run"], plan["dense_run"])
    assert plan["peak"] == PLAN_PEAK_BYTES[phase]
    assert plan["peak"] < cs.PLAN_LIMIT_BYTES
    step = max(waves) // (2 * MAX_PREFILL_GRAPHS)
    many = [step * i for i in range(1, 2 * MAX_PREFILL_GRAPHS + 1)]
    pools = [cs.serve_plan(torch, TT, cfg, w)["prefill_graph_pool"]
             for w in (many, many[-MAX_PREFILL_GRAPHS:])]
    assert pools[0] == pools[1]
