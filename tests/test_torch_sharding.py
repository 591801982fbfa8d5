"""The port's sharding rules, partition specs, meta shapes, meshes and
restore onto placements against the reference on the CPU.

* Spec trees (``param_pspecs``, ``cache_pspecs``, ``train_state_pspecs``
  for AdamW, Adafactor and the int8 error buffers, ``batch_pspec``,
  ``input_pspecs``) equal ``tuple(P)`` of the reference's, entry for
  entry, for all ten archs under ``make_rules`` of both production meshes
  (built as ``AbstractMesh`` on the reference side), fsdp and seq on and
  off.
* Meta shapes and types (``param_shapes``, ``train_state_shapes``,
  ``input_specs`` of every shape cell) equal ``jax.eval_shape``'s at fp32
  and bf16, after ``stack_blocks``.
* ``forward``/``loss_fn``/``decode_step`` with rules on a 1×1 mesh of
  Auto axes (with Explicit axes ``with_sharding_constraint`` asserts
  instead of constraining): logits within 2e-3 (the model tolerance of
  ``tests/test_torch_model.py``), ``dropped_frac`` equal, aux losses
  within 1e-6 relative (fp32 means in another order); ``rules`` with one
  MoE group is bit-identical to ``rules=None``.
* ``restore`` onto a one-rank gloo ``DeviceMesh`` (the counterpart of
  ``tests/test_fault_tolerance.py::test_restore_onto_explicit_mesh_pspecs``),
  and ``make_production_mesh`` on a fake process group in a subprocess.
* bf16 parameters (ROADMAP C, "Probes with no finding"): the reduced
  models within 2e-2 of the logits' scale (one or two bf16 steps through
  a few layers; MoE routing may flip under bf16 noise), and the MoE layer
  on identical bf16 inputs with routing and ``dropped_frac`` equal.
"""
import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, AxisType, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro import compat
from repro.configs import SHAPES, get_arch, list_archs
from repro.launch import mesh as JM
from repro.launch import specs as JSP
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import pipeline as JPL
from repro.train import step as JS
from repro_torch import configs as tconfigs
from repro_torch.ckpt import CheckpointManager, restore, save
from repro_torch.launch import mesh as TM
from repro_torch.launch import specs as TSP
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.train import pipeline as TPL
from repro_torch.train import step as TS

ROOT = Path(__file__).resolve().parents[1]
ALL = list_archs()
MESHES = {"pod": AbstractMesh((16, 16), ("data", "model")),
          "multi_pod": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
MOE_ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b"]


def _tupled(tree):
    """The reference's spec tree with each PartitionSpec as its tuple."""
    return jax.tree_util.tree_map(tuple, tree,
                                  is_leaf=lambda x: isinstance(x, JP))


def _dtype(d):
    return str(d).replace("torch.", "")


def _shapes(tree):
    """{path: (shape, dtype)} of a jax tree of ShapeDtypeStructs or a
    (stacked) port tree of tensors."""
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k, sub in tree.items()
                for p, v in _shapes(sub).items()}
    return {"": (tuple(tree.shape), _dtype(tree.dtype))}


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    return JT.param_shapes(get_arch(arch))


@functools.lru_cache(maxsize=None)
def _port_param_shapes(arch):
    return TT.param_shapes(tconfigs.get_arch(arch))


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL)
def test_spec_trees_equal_the_reference(arch, mesh, fsdp, seq):
    cfg, tcfg = get_arch(arch), tconfigs.get_arch(arch)
    jrules = JM.make_rules(MESHES[mesh], fsdp=fsdp, seq=seq)
    rules = TM.make_rules(MESHES[mesh], fsdp=fsdp, seq=seq)
    assert dataclasses.asdict(rules) == dataclasses.asdict(jrules)
    assert TT.param_pspecs(tcfg, rules) == _tupled(
        JT.param_pspecs(cfg, jrules))
    assert TT.cache_pspecs(tcfg, rules) == _tupled(
        JT.cache_pspecs(cfg, jrules))
    assert TS.batch_pspec(tcfg, rules) == _tupled(JS.batch_pspec(cfg, jrules))
    assert TSP.input_pspecs(tcfg, rules) == _tupled(
        JSP.input_pspecs(cfg, jrules))
    for compression in (None, "int8_pod"):
        tc = TS.TrainConfig(grad_compression=compression)
        jtc = JS.TrainConfig(grad_compression=compression)
        got = TS.train_state_pspecs(tcfg, tc, rules, _port_param_shapes(arch))
        want = JS.train_state_pspecs(cfg, jtc, jrules,
                                     _ref_param_shapes(arch))
        assert got == _tupled(want)


def test_spec_normalises_like_partition_spec():
    for spec in [(("data",), None), ((), "model"), (("pod", "data"), None),
                 (None,), ()]:
        assert TT.P(*spec) == tuple(JP(*spec))


def test_stacked_specs_lay_over_the_port_layout():
    """``unstack_specs`` drops the layer entry under ``blocks``; a spec
    tree over a port state reaches every leaf with a spec of its rank."""
    cfg = tconfigs.get_arch("qwen3-moe-235b-a22b").reduced()
    rules = TT.ShardRules(fsdp="data")
    tc = TS.TrainConfig()
    params, state = TS.train_state_shapes(cfg, tc)
    pspecs, sspecs = TS.train_state_pspecs(cfg, tc, rules, params)
    layered = convert.unstack_specs(pspecs, params)
    assert len(layered["blocks"]) == cfg.n_layers
    assert layered["blocks"][1]["moe"]["w_up"] == ("model", "data", None)
    assert layered["embed"] == pspecs["embed"]
    over_state = convert.unstack_specs(sspecs, state)
    for tree, specs in ((params, layered), (state, over_state)):
        for leaf, spec in convert.leaves_with_specs(tree, specs):
            assert len(spec) <= leaf.ndim, (leaf.shape, spec)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_adafactor_specs_follow_the_stacked_rank(arch):
    """Adafactor's factored specs drop the last and second-to-last entry
    of the *stacked* leaf (ROADMAP finding: the reference reads ``p.ndim``
    of (L, ...) leaves); the port's per-layer or stacked tree gives the
    same specs."""
    tcfg = tconfigs.get_arch(arch)
    assert tcfg.optimizer == "adafactor"
    rules = TT.ShardRules(fsdp="data")
    tc = TS.TrainConfig()
    per_layer = TS.train_state_pspecs(tcfg, tc, rules,
                                      _port_param_shapes(arch))
    stacked = TS.train_state_pspecs(
        tcfg, tc, rules, convert.stack_blocks(_port_param_shapes(arch)))
    assert per_layer == stacked
    w = per_layer[1]["opt"]["v"]["blocks"]["moe"]["w_gate"]
    assert w == {"vr": (None, "model", "data"), "vc": (None, "model", None)}


def test_pipeline_opt_specs_equal_the_reference():
    """``_opt_specs`` marks everything under ``blocks`` stage-sharded; on
    the port's per-layer state each layer's leaves carry the reference's
    stacked leaf's spec."""
    cfg = get_arch("internlm2-1.8b").reduced()
    pc = JPL.PipelineConfig(n_stages=2, microbatches=2)
    _, jstate = JPL.init_pp_state(jax.random.key(0), cfg, JS.TrainConfig(),
                                  pc)
    want = _tupled(JPL._opt_specs(jstate["opt"], pc))
    tcfg = tconfigs.get_arch("internlm2-1.8b").reduced()
    _, state = TPL.init_pp_state(tcfg, TS.TrainConfig(),
                                 TPL.PipelineConfig(2, 2), device="cpu")
    got = TPL._opt_specs(state["opt"], TPL.PipelineConfig(2, 2))
    assert got["mu"]["embed"] == want["mu"]["embed"] == ()
    for layer in got["mu"]["blocks"]:
        assert layer == want["mu"]["blocks"]
    assert set(got) == set(want)


# ---------------------------------------------------------------------------
# meta shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ALL)
def test_meta_shapes_equal_eval_shape(arch, dtype):
    cfg, tcfg = get_arch(arch), tconfigs.get_arch(arch)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    port = TT.param_shapes(tcfg, td)
    assert all(t.is_meta for t in jax.tree_util.tree_leaves(
        convert.stack_blocks(port)))
    assert _shapes(convert.stack_blocks(port)) == _shapes(
        JT.param_shapes(cfg, jd))
    tc, jtc = (TS.TrainConfig(grad_compression="int8_pod"),
               JS.TrainConfig(grad_compression="int8_pod"))
    p, s = TS.train_state_shapes(tcfg, tc, td)
    jp, js = JS.train_state_shapes(cfg, jtc, jd)
    assert _shapes(convert.stack_blocks(p)) == _shapes(jp)
    assert set(s) == set(js)
    assert _shapes(convert.stack_blocks(s["opt"])) == _shapes(js["opt"])
    assert _shapes(convert.stack_blocks(s["ef"])) == _shapes(js["ef"])
    assert _shapes(s["step"]) == _shapes(js["step"])
    for shape in SHAPES.values():
        got = TSP.input_specs(tcfg, shape, td)
        want = JSP.input_specs(cfg, shape, jd)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert _shapes(g) == _shapes(w), shape.name


def test_meta_shapes_take_no_memory_and_no_card(monkeypatch):
    """Meta is the host-free ``eval_shape``: no card is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = TT.param_shapes(tconfigs.get_arch("nemotron-4-340b"))
    assert TT.param_count(p) == tconfigs.get_arch(
        "nemotron-4-340b").param_count
    assert all(t.device.type == "meta"
               for t in jax.tree_util.tree_leaves(convert.stack_blocks(p)))


# ---------------------------------------------------------------------------
# rules through the model
# ---------------------------------------------------------------------------


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _carried(arch, dtype=jnp.float32):
    cfg = get_arch(arch).reduced()
    jp = JT.init_params(jax.random.key(0), cfg, dtype)
    tp = convert.load_reference_params(
        jax.tree_util.tree_map(np.asarray, jp),
        tconfigs.get_arch(arch).reduced(), device="cpu")
    return cfg, jp, tp


def _tokens(cfg, b=4, s=64, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("arch", ["internlm2-1.8b"] + MOE_ARCHS)
def test_forward_and_loss_with_rules_match_the_reference(arch, groups):
    cfg, jp, tp = _carried(arch)
    tcfg = tconfigs.get_arch(arch).reduced()
    arr = _tokens(cfg)
    jrules = JT.ShardRules(batch=("data",), model="model",
                           moe_groups=groups)
    rules = TT.ShardRules(batch=("data",), model="model", moe_groups=groups)
    with compat.set_mesh(_auto_mesh()):
        want, want_aux = jax.jit(
            lambda p, b: JT.forward(p, cfg, b, rules=jrules))(jp, arr)
        _, want_m = jax.jit(
            lambda p, b: JT.loss_fn(p, cfg, b, rules=jrules))(jp, arr)
    tin = {k: torch.from_numpy(v) for k, v in arr.items()}
    got, aux = TT.forward(tp, tcfg, tin, rules=rules)
    _, metrics = TT.loss_fn(tp, tcfg, tin, rules=rules)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)
    assert set(metrics) == set(want_m)
    for name, value in want_m.items():
        if name == "dropped_frac":
            assert float(metrics[name]) == float(value)
        else:
            np.testing.assert_allclose(float(metrics[name]), float(value),
                                       rtol=1e-6, err_msg=name)
    if cfg.moe is not None:
        assert float(aux["dropped_frac"]) == float(want_aux["dropped_frac"])
        # four groups of 64 tokens hold fewer than one group of 256
        assert (float(aux["dropped_frac"]) > 0) == (groups > 1)
    plain, plain_aux = TT.forward(tp, tcfg, tin)
    if groups == 1 or cfg.moe is None:  # rules change nothing else
        assert torch.equal(got, plain)
        assert all(torch.equal(torch.as_tensor(aux[k]),
                               torch.as_tensor(plain_aux[k])) for k in aux)
    else:
        assert not torch.equal(got, plain)


@pytest.mark.parametrize("groups", [1, 4])
def test_decode_step_with_rules_matches_the_reference(groups):
    """One decode step of reduced qwen3-moe: four tokens never fill four
    groups' capacity floor, so both packages dispatch ungrouped and the
    rules leave the port's logits bit for bit as without them."""
    arch = "qwen3-moe-235b-a22b"
    cfg, jp, tp = _carried(arch)
    tcfg = tconfigs.get_arch(arch).reduced()
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 1),
                                            dtype=np.int32)
    jrules = JT.ShardRules(batch=("data",), model="model",
                           moe_groups=groups)
    rules = TT.ShardRules(batch=("data",), model="model", moe_groups=groups)
    with compat.set_mesh(_auto_mesh()):
        want, _ = JT.decode_step(
            jp, cfg, JT.init_cache(cfg, 4, 16, jnp.float32),
            {"tokens": jnp.asarray(tok), "length": jnp.int32(0)},
            rules=jrules)
    inputs = {"tokens": torch.from_numpy(tok), "length": 0}
    got, _ = TT.decode_step(
        tp, tcfg, TT.init_cache(tcfg, 4, 16, torch.float32, device="cpu"),
        inputs, rules=rules)
    plain, _ = TT.decode_step(
        tp, tcfg, TT.init_cache(tcfg, 4, 16, torch.float32, device="cpu"),
        inputs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)
    assert torch.equal(got, plain)


def test_train_step_takes_rules():
    """``make_train_step(rules=...)`` puts the rules into the loss: with
    four MoE groups the metrics carry the grouped ``dropped_frac``."""
    tcfg = tconfigs.get_arch("qwen3-moe-235b-a22b").reduced()
    tc = TS.TrainConfig(lr=1e-3, warmup=1, total_steps=4)
    params, state = TS.init_train_state(tcfg, tc, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _tokens(tcfg).items()}
    rules = TT.ShardRules(moe_groups=4)
    _, _, m4 = TS.make_train_step(tcfg, tc, rules)(params, state, batch)
    _, _, m1 = TS.make_train_step(tcfg, tc)(params, state, batch)
    _, ref = TT.loss_fn(params, tcfg, batch, rules=rules)
    assert float(m4["dropped_frac"]) == float(ref["dropped_frac"]) > 0
    assert float(m1["dropped_frac"]) == 0.0


def test_rules_constrain_a_dtensor_and_leave_a_tensor(one_rank_gloo):
    """``ShardRules.act`` returns a plain tensor itself and redistributes
    a ``DTensor`` to the spec's placements on its mesh."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = TM.make_debug_mesh((1, 1), device="cpu")
    rules = TT.ShardRules(batch=("data",), model="model")
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert rules.act(x, ("data",), None, None) is x
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    y = rules.act(d, ("data",), None, "model")
    assert tuple(y.placements) == (Shard(0), Shard(2))
    assert torch.equal(y.full_tensor(), x)


# ---------------------------------------------------------------------------
# meshes and placements
# ---------------------------------------------------------------------------


def test_placements_and_local_shapes_follow_the_specs():
    from torch.distributed.tensor import Replicate, Shard
    multi = MESHES["multi_pod"]
    assert TM.placements((("pod", "data"), None, "model"), multi) == (
        Shard(0), Shard(0), Shard(2))
    assert TM.placements((None, "model"), multi) == (
        Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="not in the mesh"):
        TM.placements(("pod",), MESHES["pod"])
    with pytest.raises(ValueError, match="twice"):
        TM.placements(("model", "model"), multi)
    assert TM.local_shape((65, 48), (("pod", "data"), "model"), multi) == (
        3, 3)
    # every full-size leaf that divides evenly: the reference's shard shape
    rules = JM.make_rules(multi, fsdp=True)
    for arch in ("internlm2-1.8b", "qwen3-moe-235b-a22b"):
        shapes = _ref_param_shapes(arch)
        specs = JT.param_pspecs(get_arch(arch), rules)
        for leaf, spec in zip(jax.tree_util.tree_leaves(shapes),
                              jax.tree_util.tree_leaves(
                                  specs, is_leaf=lambda x: isinstance(x, JP))):
            got = TM.local_shape(leaf.shape, tuple(spec), multi)
            try:
                want = NamedSharding(multi, spec).shard_shape(leaf.shape)
            except ValueError:          # uneven: the ceiling, as DTensor
                continue
            assert got == tuple(want), (arch, leaf.shape, spec)


_PRODUCTION = textwrap.dedent("""
    import dataclasses, json
    import torch.distributed as dist
    from repro_torch.launch import mesh as TM
    for multi in (False, True):
        mesh = TM.make_production_mesh(multi_pod=multi, device="cpu")
        print(json.dumps({
            "names": list(mesh.mesh_dim_names), "shape": list(mesh.shape),
            "size": mesh.size(), "backend": dist.get_backend(),
            "rules": dataclasses.asdict(TM.make_rules(mesh, fsdp=True))}))
        dist.destroy_process_group()
""")


def test_make_production_mesh_on_a_fake_group():
    """Both production meshes build on a fake group in one process, and
    their rules equal the reference's on the same shapes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PRODUCTION], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in out.stdout.strip().splitlines()]
    for row, name in zip(rows, ("pod", "multi_pod")):
        want = MESHES[name]
        assert row["names"] == list(want.axis_names)
        assert row["shape"] == list(want.shape.values())
        assert row["size"] == int(np.prod(row["shape"]))
        assert row["backend"] == "fake"
        rules = dataclasses.asdict(JM.make_rules(want, fsdp=True))
        assert row["rules"] == json.loads(json.dumps(rules))


# ---------------------------------------------------------------------------
# restore onto placements
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank_gloo():
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://localhost:{_free_port()}")
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_restore_onto_one_rank_mesh_pspecs(one_rank_gloo, tmp_path):
    """Reshard-on-restore onto a one-rank gloo ``DeviceMesh`` of shape
    (1, 1): every leaf a ``DTensor`` with its spec's placements, values
    identical; ``like`` may be meta tensors; the manager restores the
    same way."""
    from torch.distributed.tensor import DTensor
    cfg = tconfigs.get_arch("internlm2-1.8b").reduced()
    params = TT.init_params(cfg, device="cpu")
    save(str(tmp_path), 1, convert.stack_blocks(params))
    mesh = TM.make_debug_mesh((1, 1), device="cpu")
    rules = TT.ShardRules(batch=("data",), model="model", fsdp=None)
    pspecs = convert.unstack_specs(TT.param_pspecs(cfg, rules), params)
    like = convert.stack_blocks(TT.param_shapes(cfg, torch.float32))
    got = restore(str(tmp_path), 1, like=like, mesh=mesh,
                  pspecs=TT.param_pspecs(cfg, rules))
    got = convert.unstack_blocks(got, params)
    for (leaf, spec), (want, _) in zip(
            convert.leaves_with_specs(got, pspecs),
            convert.leaves_with_specs(params, pspecs)):
        assert isinstance(leaf, DTensor)
        assert tuple(leaf.placements) == TM.placements(spec, mesh)
        assert torch.equal(leaf.full_tensor(), want)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    step, again = mgr.restore_latest(like, mesh=mesh,
                                     pspecs=TT.param_pspecs(cfg, rules))
    assert step == 1
    assert isinstance(again["embed"], DTensor)
    assert torch.equal(again["embed"].full_tensor(), params["embed"])


# ---------------------------------------------------------------------------
# bf16 parameters
# ---------------------------------------------------------------------------

BF16_ARCHS = ["internlm2-1.8b", "minicpm3-4b", "hymba-1.5b", "mamba2-130m",
              "arctic-480b"]


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_forward_matches_the_reference(arch):
    cfg, jp, tp = _carried(arch, jnp.bfloat16)
    tcfg = tconfigs.get_arch(arch).reduced()
    assert tp["embed"].dtype == torch.bfloat16
    arr = _tokens(cfg, b=2, s=64, seed=1)
    want, _ = JT.forward(jp, cfg, {"tokens": jnp.asarray(arr["tokens"])},
                         remat=False)
    got, _ = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(
        arr["tokens"])})
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    assert float(np.abs(got.float().numpy() - want).max()) <= 2e-2 * scale


@pytest.mark.parametrize("capacity", [1.25, 0.3])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_moe_layer_matches_the_reference(arch, capacity):
    """The MoE layer on identical bf16 inputs and weights: routing ids
    equal, ``dropped_frac`` equal, aux losses within 1e-6 relative, the
    output within two bf16 steps (2^-6) of its scale: the expert products
    are summed in another order and rounded to bf16, and arctic's dense
    residual is added in bf16, a second rounding."""
    cfg = get_arch(arch).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity))
    tcfg = tconfigs.get_arch(arch).reduced()
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=capacity))
    jp = JL.moe_init(jax.random.key(4), cfg, jnp.bfloat16)
    tp = jax.tree_util.tree_map(lambda a: convert._tensor(a, "cpu"), jp)
    assert tp["w_up"].dtype == torch.bfloat16
    assert tp["router"].dtype == torch.float32
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (4, 64, cfg.d_model)), jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    want, want_aux = JL.moe_forward(jp, x, cfg)
    got, aux = TL.moe_forward(tp, tx, tcfg)
    probs = jax.nn.softmax(x.reshape(-1, cfg.d_model).astype(jnp.float32)
                           @ jp["router"], axis=-1)
    _, want_ids = jax.lax.top_k(probs, cfg.moe.top_k)
    _, _, _, ids = TL.moe_route(tp, tx.reshape(-1, cfg.d_model),
                                cfg.moe.top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    assert float(aux["dropped_frac"]) == float(want_aux["dropped_frac"])
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]),
                                   rtol=1e-6, err_msg=k)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.float().numpy() - want).max()) <= 2**-6 * scale
