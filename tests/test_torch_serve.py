"""The port's serving path against the reference on the CPU, for all ten
archs: prefill logits and every captured cache entry (hymba's ring past
its 16-token window and MLA's latents included), incremental decode, the
batched server's greedy tokens (its refusal of qwen2-vl's embeddings, as
the reference's), and the launcher, on weights carried across from the
reference.

Tolerance 2e-3, that of ``tests/test_serve.py`` (a few layers of fp32 sums
taken in another order; a bf16 cache entry may round the other way where
the fp32 value sits on a rounding boundary, which at the reduced widths'
magnitudes, under 1, is one ulp of at most 2^-9)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, list_archs
from repro.models import transformer as JT
from repro.serve import BatchServer as JServer
from repro.serve import Request as JRequest
from repro.serve.engine import prefill_with_cache as jprefill
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd as tssd
from repro_torch.launch import serve as tlaunch
from repro_torch.models import convert
from repro_torch.models import transformer as TT
from repro_torch.serve import BatchServer, Request
from repro_torch.serve.engine import prefill_with_cache

ARCHS = list_archs()
CACHE_DTYPES = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = dict(atol=2e-3, rtol=2e-3)


def _carried(arch):
    cfg = get_arch(arch).reduced()
    jp = JT.init_params(jax.random.key(0), cfg, jnp.float32)
    tcfg = tconfigs.get_arch(arch).reduced()
    tp = convert.load_reference_params(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return cfg, tcfg, jp, tp


def _seq(cfg, rng, b, n):
    """numpy inputs for positions 0..n-1: token ids (codebook ids for
    musicgen), or embeddings with distinct (t, h, w) M-RoPE positions."""
    if cfg.input_mode == "embeddings":
        return {"embeds": rng.standard_normal((b, n, cfg.d_model)).astype(
                    np.float32),
                "positions": np.stack([np.arange(n), np.arange(n) // 4 + 1,
                                       np.arange(n) % 4 + 2])[:, None]
                .repeat(b, 1).astype(np.int32)}
    shape = (b, n, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, n)
    return {"tokens": rng.integers(0, cfg.vocab_size, shape)}


def _at(seq, lo, hi, length=None):
    """Positions lo..hi-1 of ``seq`` for both packages; with ``length``,
    a decode step's inputs."""
    part = {k: (v[:, :, lo:hi] if k == "positions" else v[:, lo:hi])
            for k, v in seq.items()}
    jin = {k: jnp.asarray(v) for k, v in part.items()}
    tin = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in part.items()}
    if length is not None:
        jin["length"] = jnp.asarray(length, jnp.int32)
        tin["length"] = length
    return jin, tin


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cache_dtype", sorted(CACHE_DTYPES))
def test_prefill_with_cache_matches_the_reference(arch, cache_dtype):
    """S = 24 is past hymba's 16-slot ring, so the ring scatter wraps."""
    jd, td = CACHE_DTYPES[cache_dtype]
    cfg, tcfg, jp, tp = _carried(arch)
    jin, tin = _at(_seq(cfg, np.random.default_rng(2), 2, 24), 0, 24)
    want, wcache = jprefill(jp, cfg, jin, max_len=32, cache_dtype=jd)
    got, gcache = prefill_with_cache(tp, tcfg, tin, max_len=32,
                                     impl="kernel", cache_dtype=td)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(gcache) == set(wcache)
    for name in wcache:
        assert tuple(gcache[name].shape) == wcache[name].shape, name
        assert str(gcache[name].dtype).split(".")[-1] == \
            str(wcache[name].dtype), name
        np.testing.assert_allclose(_f32(gcache[name]), _f32(wcache[name]),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_incremental_decode_matches_the_reference(arch):
    """Prefill 12 tokens, then decode 6 one at a time on both sides, each
    step's logits and the cache afterwards."""
    cfg, tcfg, jp, tp = _carried(arch)
    S, N = 12, 6
    seq = _seq(cfg, np.random.default_rng(3), 1, S + N)
    jin, tin = _at(seq, 0, S)
    _, jc = jprefill(jp, cfg, jin, max_len=S + N, cache_dtype=jnp.float32)
    _, tc = prefill_with_cache(tp, tcfg, tin, max_len=S + N, impl="kernel",
                               cache_dtype=torch.float32)
    for i in range(N):
        jin, tin = _at(seq, S + i, S + i + 1, S + i)
        want, jc = JT.decode_step(jp, cfg, jc, jin)
        got, tc = TT.decode_step(tp, tcfg, tc, tin)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in jc:
        np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_the_reference_cache(arch):
    """The reference's prefill cache carried across with
    ``load_reference_cache`` decodes in the port as in the reference."""
    cfg, tcfg, jp, tp = _carried(arch)
    S = 24
    seq = _seq(cfg, np.random.default_rng(6), 2, S + 2)
    _, jc = jprefill(jp, cfg, _at(seq, 0, S)[0], max_len=S + 2)
    tc = convert.load_reference_cache(
        jax.tree_util.tree_map(np.asarray, jc), device="cpu")
    assert {k: str(v.dtype).split(".")[-1] for k, v in tc.items()} == \
        {k: str(v.dtype) for k, v in jc.items()}
    for i in range(2):
        jin, tin = _at(seq, S + i, S + i + 1, S + i)
        want, jc = JT.decode_step(jp, cfg, jc, jin)
        got, tc = TT.decode_step(tp, tcfg, tc, tin)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ring_buffer_decode_past_the_window_matches_the_reference():
    """hymba's ring: prefill 24 tokens (window 16, bf16 cache as the server
    keeps it), then decode 8 more, wrapping the ring again."""
    cfg, tcfg, jp, tp = _carried("hymba-1.5b")
    S, N = 24, 8
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, S + N))
    _, jc = jprefill(jp, cfg, {"tokens": jnp.asarray(toks[:, :S])},
                     max_len=S + N)
    _, tc = prefill_with_cache(tp, tcfg,
                               {"tokens": torch.from_numpy(toks[:, :S])},
                               max_len=S + N, impl="kernel")
    assert tc["k"].shape[2] == cfg.sliding_window
    for i in range(N):
        want, jc = JT.decode_step(
            jp, cfg, jc, {"tokens": jnp.asarray(toks[:, S + i:S + i + 1]),
                          "length": jnp.asarray(S + i, jnp.int32)})
        got, tc = TT.decode_step(
            tp, tcfg, tc, {"tokens": torch.from_numpy(toks[:, S + i:S + i + 1]),
                           "length": S + i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_server_tokens_equal_the_reference(arch):
    """Two waves (prompt lengths 20 and 8) through both servers; the port's
    takes its default ``impl="kernel"`` (plain versions on the CPU).  Both
    refuse qwen2-vl's embedding frontend in the first wave."""
    cfg, tcfg, jp, tp = _carried(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 20, 20, 8, 8)]
    jserver = JServer(jp, cfg, n_slots=3, max_len=32)
    tserver = BatchServer(tp, tcfg, n_slots=3, max_len=32, device="cpu")
    assert tserver.impl == "kernel"
    for i, p in enumerate(prompts):
        jserver.submit(JRequest(request_id=f"r{i}", prompt=p,
                                max_new_tokens=6))
        tserver.submit(Request(request_id=f"r{i}", prompt=p,
                               max_new_tokens=6))
    if cfg.input_mode == "embeddings":
        for server in (jserver, tserver):
            with pytest.raises(NotImplementedError, match="embedding"):
                server.run(max_requests=len(prompts), idle_timeout_s=0.5)
        return
    want = jserver.run(max_requests=len(prompts), idle_timeout_s=0.5)
    got = tserver.run(max_requests=len(prompts), idle_timeout_s=0.5)
    assert [r.request_id for r in got] == [r.request_id for r in want]
    for a, b in zip(got, want):
        assert a.result_tokens == b.result_tokens, a.request_id
        assert a.t_first_token is not None and a.t_done is not None
    assert [w["prompt_len"] for w in tserver.waves] == [20, 8]
    assert [len(w["decode_s"]) for w in tserver.waves] == [5, 5]
    assert tserver.metrics["completed"] == len(prompts)


def test_batch_server_runs_on_the_card_by_default(monkeypatch):
    _, tcfg, _, tp = _carried("hymba-1.5b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchServer(tp, tcfg)


def test_launch_serve_runs_on_the_host(capsys):
    flash0 = tfa.LAUNCHES["flash_attention"].count
    ssd0 = tssd.LAUNCHES["ssd_chunk_scan"].count
    rc = tlaunch.main(["--arch", "hymba-1.5b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--prompt-len",
                       "20", "--new-tokens", "4", "--max-len", "24"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "completed 3/3 requests, 12 tokens" in out
    assert "first-token latency" in out
    # the host takes the plain versions: no kernel launch
    assert tfa.LAUNCHES["flash_attention"].count == flash0
    assert tssd.LAUNCHES["ssd_chunk_scan"].count == ssd0


@pytest.mark.parametrize("arch", ["minicpm3-4b", "qwen3-moe-235b-a22b",
                                  "arctic-480b", "qwen2-vl-2b"])
def test_launch_serve_runs_the_new_families(arch, capsys):
    """MLA and both MoE archs serve through the launcher on the host;
    qwen2-vl returns 1, as the reference's launcher does."""
    rc = tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "2", "--slots", "2", "--prompt-len",
                       "16", "--new-tokens", "3", "--max-len", "20"])
    out = capsys.readouterr().out
    if arch == "qwen2-vl-2b":
        assert rc == 1 and "embedding frontend" in out
        return
    assert rc == 0
    assert "completed 2/2 requests, 6 tokens" in out
