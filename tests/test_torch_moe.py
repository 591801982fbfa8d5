"""The port's MoE layer (qwen3-moe's top-8 and arctic's top-2 with its
dense residual) against the reference on the CPU: routing ids and
dispatch positions bit-equal (a router with tied columns included),
``moe_capacity`` on a grid, outputs and aux losses within 1e-5, and
``tests/test_moe_dispatch.py``'s invariants through the port.  The MoE
loss and its metrics match the reference's ``loss_fn``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

MOE_ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b"]
TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(arch="qwen3-moe-235b-a22b", **moe_kw):
    """The reduced config in both packages, with ``moe_kw`` replaced."""
    out = []
    for get in (get_arch, tconfigs.get_arch):
        base = get(arch).reduced()
        out.append(dataclasses.replace(
            base, moe=dataclasses.replace(base.moe, **moe_kw)))
    return out


def _layer(cfg, tcfg, seed=0):
    jp = JL.moe_init(jax.random.key(seed), cfg, jnp.float32)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def _x(cfg, shape, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_routing_and_positions_equal_the_reference(tied, top_k):
    """ids from the stable sort equal ``lax.top_k``'s, ties included (the
    tied router has equal columns: the lower expert comes first), and the
    dispatch positions equal the reference's cumsum positions."""
    cfg, tcfg = _cfgs(top_k=top_k, n_experts=8)
    jp, tp = _layer(cfg, tcfg)
    if tied:
        r = np.zeros((cfg.d_model, 8), np.float32)
        r[:, [1, 4, 6]] = np.random.default_rng(5).standard_normal(
            (cfg.d_model, 1))
        jp["router"], tp["router"] = jnp.asarray(r), torch.from_numpy(r)
    jx, tx = _x(cfg, (96,))
    probs = jax.nn.softmax(jx @ jp["router"], axis=-1)
    _, want_ids = jax.lax.top_k(probs, top_k)
    _, _, _, ids = TL.moe_route(tp, tx, top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    if tied:
        assert (ids.numpy()[:, 0] != 0).sum() > 0
    want_pos = JL._dispatch_positions(want_ids.reshape(-1), 8)
    pos = TL._dispatch_positions(ids.reshape(-1), 8)
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))


def test_dispatch_positions_batched_equal_the_reference():
    ids = np.random.default_rng(0).integers(0, 16, (3, 500)).astype(np.int32)
    want = JL._dispatch_positions(jnp.asarray(ids), 16)
    got = TL._dispatch_positions(torch.from_numpy(ids), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("capacity_factor", [0.01, 1.0, 1.25, 2.0, 8.0])
def test_moe_capacity_on_a_grid(capacity_factor):
    for arch in MOE_ARCHS:
        for cfg, tcfg in ((get_arch(arch), tconfigs.get_arch(arch)),
                          _cfgs(arch, capacity_factor=capacity_factor)):
            for n in (1, 7, 64, 511, 4096, 65_536):
                assert TL.moe_capacity(tcfg, n) == JL.moe_capacity(cfg, n)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.3])
def test_moe_forward_matches_the_reference(arch, capacity_factor):
    """y and the three aux values; at 0.3 tokens are dropped."""
    cfg, tcfg = _cfgs(arch, capacity_factor=capacity_factor)
    jp, tp = _layer(cfg, tcfg)
    jx, tx = _x(cfg, (2, 48))
    want, waux = JL.moe_forward(jp, jx, cfg)
    got, aux = TL.moe_forward(tp, tx, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(aux) == set(waux)
    for name in waux:
        np.testing.assert_allclose(float(aux[name]), float(waux[name]),
                                   err_msg=name, **TOL)
    if capacity_factor < 1:
        assert float(aux["dropped_frac"]) > 0


def test_moe_grouped_forward_matches_the_reference():
    cfg, tcfg = _cfgs(capacity_factor=2.0)
    jp, tp = _layer(cfg, tcfg)
    jx, tx = _x(cfg, (4, 16))
    want, waux = JL.moe_forward(jp, jx, cfg, groups=4)
    got, aux = TL.moe_forward(tp, tx, tcfg, groups=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in waux:
        np.testing.assert_allclose(float(aux[name]), float(waux[name]),
                                   err_msg=name, **TOL)


def test_shard_experts_waits_for_the_sharding_rules():
    """The sharding rules are in (ROADMAP A9.3): ``shard_experts`` sees
    the expert buffers before and after the expert products, (E, C, D)
    ungrouped and (G, E, C, D) grouped as in the reference, and an
    identity constraint leaves the outputs bit for bit."""
    cfg, tcfg = _cfgs()
    _, tp = _layer(cfg, tcfg)
    x = _x(cfg, (4, 32))[1]
    for groups, shape in ((1, (4, 80, cfg.d_model)),          # cap 80
                          (4, (4, 4, 24, cfg.d_model))):      # cap 24
        seen = []
        y, _ = TL.moe_forward(tp, x, tcfg, groups=groups,
                              shard_experts=lambda e: seen.append(
                                  tuple(e.shape)) or e)
        assert seen == [shape] * 2, (groups, seen)
        assert torch.equal(y, TL.moe_forward(tp, x, tcfg, groups=groups)[0])


def test_router_is_fp32_whatever_the_dtype():
    tcfg = tconfigs.get_arch("arctic-480b").reduced()
    p = TL.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                    "cpu")
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].dtype == p["dense"]["w_up"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# tests/test_moe_dispatch.py's invariants, through the port
# ---------------------------------------------------------------------------


def _port_layer(tcfg, seed=0):
    return TL.moe_init(torch.Generator().manual_seed(seed), tcfg,
                       torch.float32, "cpu")


def _randn(tcfg, shape, seed=1):
    return torch.randn((*shape, tcfg.d_model),
                       generator=torch.Generator().manual_seed(seed))


def test_grouped_equals_ungrouped_with_headroom():
    _, tcfg = _cfgs(capacity_factor=8.0)
    p = _port_layer(tcfg)
    x = _randn(tcfg, (4, 16))
    y1, a1 = TL.moe_forward(p, x, tcfg, groups=1)
    y4, a4 = TL.moe_forward(p, x, tcfg, groups=4)
    np.testing.assert_allclose(y1.numpy(), y4.numpy(), atol=1e-6)
    assert abs(float(a1["lb_loss"]) - float(a4["lb_loss"])) < 1e-6


def test_capacity_gate_falls_back_ungrouped():
    """4 tokens in 4 groups: the gate refuses the grouped path, so the
    result is the ungrouped one, bit for bit."""
    _, tcfg = _cfgs(capacity_factor=1.25, n_experts=4)
    p = _port_layer(tcfg)
    x = _randn(tcfg, (2, 2))
    y1, _ = TL.moe_forward(p, x, tcfg, groups=1)
    y4, _ = TL.moe_forward(p, x, tcfg, groups=4)
    assert torch.equal(y1, y4)


@given(seed=st.integers(0, 100), n=st.integers(1, 300),
       e=st.integers(1, 16))
@settings(max_examples=20, deadline=None, database=None)
def test_dispatch_positions_dense_per_expert(seed, n, e):
    ids = np.random.default_rng(seed).integers(0, e, size=(n,))
    pos = TL._dispatch_positions(torch.from_numpy(ids), e).numpy()
    for ex in range(e):
        ps = np.sort(pos[ids == ex])
        assert (ps == np.arange(len(ps))).all()


def test_dropped_tokens_contribute_zero():
    """Capacity 8, every token routed to expert 0 (the router's equal
    columns tie the rest): the dropped tokens' rows are exactly zero and
    their count equals the drop count."""
    _, tcfg = _cfgs(capacity_factor=0.01, top_k=1, n_experts=4)
    p = _port_layer(tcfg)
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 0] = 10.0
    x = _randn(tcfg, (1, 64))
    y, aux = TL.moe_forward(p, x, tcfg)
    assert float(aux["dropped_frac"]) > 0.5
    norms = torch.linalg.norm(y[0], dim=-1).numpy()
    assert (norms == 0.0).sum() == round(64 * float(aux["dropped_frac"]))


def test_moe_grad_flows_through_grouped_path():
    _, tcfg = _cfgs(capacity_factor=2.0)
    p = {k: v.requires_grad_() for k, v in _port_layer(tcfg).items()}
    x = _randn(tcfg, (4, 8))
    y, aux = TL.moe_forward(p, x, tcfg, groups=4)
    loss = torch.sum(y ** 2) + aux["lb_loss"]
    names = ("router", "w_gate", "w_up", "w_down")
    grads = torch.autograd.grad(loss, [p[k] for k in names])
    for k, g in zip(names, grads):
        assert float(g.abs().sum()) > 0, k
        assert bool(torch.isfinite(g).all()), k


# ---------------------------------------------------------------------------
# the MoE model: loss and metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_metrics_match_the_reference(arch):
    cfg = get_arch(arch).reduced()
    tcfg = tconfigs.get_arch(arch).reduced()
    jp = JT.init_params(jax.random.key(0), cfg, jnp.float32)
    tp = convert.load_reference_params(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 32))
    labels = rng.integers(0, cfg.vocab_size, (2, 32))
    want, wm = JT.loss_fn(jp, cfg, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(labels)},
                          remat=False)
    got, m = TT.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
    assert set(m) == set(wm) == {"ce", "loss", "lb_loss", "z_loss",
                                 "dropped_frac"}
    np.testing.assert_allclose(float(got), float(want), **TOL)
    for name in wm:
        np.testing.assert_allclose(float(m[name]), float(wm[name]),
                                   err_msg=name, **TOL)
    assert float(m["loss"]) == pytest.approx(
        float(m["ce"]) + float(m["lb_loss"]) + float(m["z_loss"]), rel=1e-6)
