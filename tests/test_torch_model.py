"""The port's configs and decoder against the reference on the CPU: every
config field equal for all ten archs, parameter shapes equal, and
``forward`` logits (and the MoE aux losses) on weights carried across
from the reference.

Tolerance 2e-3 for logits, that of ``tests/test_serve.py`` for model-level
comparisons (a few layers of fp32 sums taken in another order; softplus in
torch returns x above 20, a difference under fp32 resolution)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, list_archs
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.models import convert, layers as TL
from repro_torch.models import transformer as TT

ALL = list_archs()
PARITY_ARCHS = ALL


# fields the port's configs have and the reference's lack (a per-layer
# pattern, the multipliers, a layer's share of its experts), with the
# values every configuration of the reference's zoo must keep: the
# defaults, which change nothing
PORT_ONLY = {"layer_types": (), "attention_multiplier": None,
             "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
             "logits_scaling": 1.0}
PORT_ONLY_MOE = {"experts_held": 0, "dropless": False}


def _as_reference(cfg) -> dict:
    """``dataclasses.asdict`` of a port config without its port-only
    fields, each checked at its default first."""
    d = dataclasses.asdict(cfg)
    for key, value in PORT_ONLY.items():
        assert d.pop(key) == value, key
    if d["moe"] is not None:
        for key, value in PORT_ONLY_MOE.items():
            assert d["moe"].pop(key) == value, key
    return d


@pytest.mark.parametrize("arch", ALL)
def test_configs_equal_the_reference(arch):
    ref, port = get_arch(arch), tconfigs.get_arch(arch)
    assert _as_reference(port) == dataclasses.asdict(ref)
    for c_ref, c_port in ((ref, port), (ref.reduced(), port.reduced())):
        assert _as_reference(c_port) == dataclasses.asdict(c_ref)
        for attr in ("param_count", "active_param_count",
                     "padded_vocab_size", "head_dim"):
            assert getattr(c_port, attr) == getattr(c_ref, attr), attr
    assert tconfigs.list_archs() == ALL
    assert set(tconfigs.SHAPES) == set(__import__(
        "repro.configs", fromlist=["SHAPES"]).SHAPES)


@pytest.mark.parametrize("arch", ALL)
def test_init_shapes_match_the_reference(arch):
    cfg = tconfigs.get_arch(arch).reduced()
    ref = JT.param_shapes(get_arch(arch).reduced(), jnp.float32)
    port = TT.init_params(cfg, device="cpu")
    assert set(port) == set(ref)
    for name in port:
        if name == "blocks":
            continue
        assert tuple(port[name].shape) == ref[name].shape, name
    flat_ref = jax.tree_util.tree_leaves_with_path(ref["blocks"])
    for path, leaf in flat_ref:
        keys = [p.key for p in path]
        for block in port["blocks"]:
            t = block
            for k in keys:
                t = t[k]
            assert tuple(t.shape) == leaf.shape[1:], keys
            assert str(t.dtype) == f"torch.{leaf.dtype}", keys
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(ref))
    assert TT.param_count(port) == n_ref


def test_init_values_follow_the_reference_scheme():
    cfg = tconfigs.get_arch("hymba-1.5b").reduced()
    p = TT.init_params(cfg, device="cpu", seed=3)
    assert not p["embed"][cfg.vocab_size:].any()
    assert not p["head"][:, cfg.vocab_size:].any()
    ssm = p["blocks"][0]["mixer"]["ssm"]
    _, nh, _ = TL.ssm_dims(cfg)
    torch.testing.assert_close(ssm["A_log"],
                               torch.log(torch.arange(1.0, nh + 1)))
    assert torch.equal(ssm["D"], torch.ones(nh))
    dt = TL.softplus(ssm["dt_bias"])
    assert bool(((dt >= cfg.ssm.dt_min * 0.999)
                 & (dt <= cfg.ssm.dt_max * 1.001)).all())
    std = float(p["blocks"][0]["mixer"]["attn"]["wq"].std())
    assert 0.015 < std < 0.025


def test_init_params_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_params(tconfigs.get_arch("hymba-1.5b").reduced())


def test_load_reference_params_default_device_needs_a_card(monkeypatch):
    """The carried weights go to the card unless the caller asks for the
    host: with no card, the default raises ``default_device``'s error."""
    cfg = get_arch("hymba-1.5b").reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jax.random.key(0), cfg, jnp.float32))
    tcfg = tconfigs.get_arch("hymba-1.5b").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.load_reference_params(tree, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.load_reference_cache({"k": np.zeros((1, 2), np.float32)})


def _carried(arch):
    cfg = get_arch(arch).reduced()
    jp = JT.init_params(jax.random.key(0), cfg, jnp.float32)
    tp = convert.load_reference_params(
        jax.tree_util.tree_map(np.asarray, jp), tconfigs.get_arch(arch)
        .reduced(), device="cpu")
    return cfg, jp, tp


def _inputs(cfg, rng, b=2, s=64):
    """The same numpy inputs for both packages: token ids (codebook ids
    for musicgen), or qwen2-vl's embeddings with distinct (t, h, w)
    M-RoPE positions."""
    if cfg.input_mode == "embeddings":
        arr = {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(
                   np.float32),
               "positions": np.stack([np.arange(s), np.arange(s) // 8,
                                      np.arange(s) % 8])[:, None].repeat(
                   b, 1).astype(np.int32)}
    else:
        shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
        arr = {"tokens": rng.integers(0, cfg.vocab_size, shape)}
    return ({k: jnp.asarray(v) for k, v in arr.items()},
            {k: torch.from_numpy(v) for k, v in arr.items()})


@pytest.mark.parametrize("arch", PARITY_ARCHS)
@pytest.mark.parametrize("impl", [("dense", "dense"), ("kernel", "pallas")])
def test_forward_matches_the_reference(arch, impl):
    port_impl, ref_impl = impl
    cfg, jp, tp = _carried(arch)
    jin, tin = _inputs(cfg, np.random.default_rng(1))
    want, want_aux = JT.forward(jp, cfg, jin, impl=ref_impl, remat=False)
    got, aux = TT.forward(tp, tconfigs.get_arch(arch).reduced(), tin,
                          impl=port_impl)
    assert set(aux) == set(want_aux)
    for name, value in want_aux.items():
        np.testing.assert_allclose(float(aux[name]), float(value),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)
