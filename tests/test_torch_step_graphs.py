"""The reference's GPipe and int8-compressed steps, compiled, in the port,
on the CPU.

The reference jits its GPipe step (``repro/launch/dryrun.py:245``) and
its int8 step (``:127``); the port's counterparts,
``train.pipeline.make_pp_train_fn`` and ``train.step.
make_compressed_train_fn``, are ``TrainFn`` objects, as
``make_train_fn`` is: one CUDA graph a batch shape on the card, the
params and optimizer state updated in place inside it, and the eager step
on the host.  Here, for reduced internlm2-1.8b and reduced qwen3-moe
(the GPipe step with both stages in one process, 2 stages and 2
microbatches; the int8 step on a one-rank gloo group):

* the static-program guard (``tests/test_torch_train_static.py``'s): no
  op that reads a value on the host under a ``TorchDispatchMode``, and
  one op trace for two consecutive steps;
* each function on CPU tensors, and the in-place body its graphs capture
  (``TS._in_place``, run eagerly), bit for bit the eager step over three
  steps;
* the GPipe function over a two-rank group refuses a CUDA batch before
  any launch (fake CUDA tensors, no card needed), and the hand-off
  between stages is empty after a step;
* the int8 in-place body against the reference's compressed step,
  within ``tests/test_torch_compression.py``'s tolerance.

The captures themselves run on the card (``tests/test_torch_cuda.py -k
"pp_graph or int8_graph"``).

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_step_graphs.py
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro.configs import get_arch
from repro.data import make_batch_iterator as ref_batches
from repro.models import transformer as JT
from repro.train import step as JS
from repro_torch import configs as tconfigs
from repro_torch.data import make_batch_iterator
from repro_torch.models import convert
from repro_torch.train import pipeline as PP
from repro_torch.train import step as TS

from test_torch_compression import INT8_TC, one_rank_gloo  # noqa: F401
from test_torch_decode_static import SYNCS, _Ops

ARCHS = ["internlm2-1.8b", "qwen3-moe-235b-a22b"]
KINDS = ["pp", "int8"]
STEP_TC = dict(lr=1e-3, warmup=2, total_steps=20)
PC = PP.PipelineConfig(n_stages=2, microbatches=2)


def _setup(kind, arch, seed=1):
    """Reduced ``arch``: its params and zero state from a seed (with bf16
    error buffers for the int8 step) and three batches of 4 × 16."""
    cfg = tconfigs.get_arch(arch).reduced()
    tc = TS.TrainConfig(**(INT8_TC if kind == "int8" else STEP_TC))
    params, state = TS.init_train_state(cfg, tc, seed=seed, device="cpu")
    it = make_batch_iterator(cfg, 4, 16, seed=seed, device="cpu")
    return cfg, tc, params, state, [next(it) for _ in range(3)]


def _steps(kind, cfg, tc, request):
    """(the eager step, its compiled function) of ``kind``; the int8 step
    over a one-rank gloo group."""
    if kind == "pp":
        return (PP.make_pp_train_step(cfg, tc, PC),
                PP.make_pp_train_fn(cfg, tc, PC))
    group = request.getfixturevalue("one_rank_gloo")
    return (TS.make_compressed_train_step(cfg, tc, group),
            TS.make_compressed_train_fn(cfg, tc, group))


def _clone(tree):
    return pytree.tree_map(torch.clone, tree)


_TRACES = {}


def _traced_steps(kind, arch, request):
    """The ops of two consecutive steps, each with its outputs' shapes."""
    if (kind, arch) not in _TRACES:
        cfg, tc, params, state, batches = _setup(kind, arch)
        step, _ = _steps(kind, cfg, tc, request)
        traces = []
        for batch in batches[:2]:
            with _Ops() as mode:
                params, state, _ = step(params, state, batch)
            traces.append(mode.ops)
        _TRACES[kind, arch] = traces
    return _TRACES[kind, arch]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_step_reads_nothing_on_the_host(kind, arch, request):
    """Forward, backward (remat recomputing each block), the hand-off or
    the int8 reduction with its collectives, clip and the optimizer: no
    op that reads a tensor's value on the host, in either step."""
    first, second = _traced_steps(kind, arch, request)
    synced = [op for op, _ in first + second if op in SYNCS]
    assert not synced, synced
    assert len(first) > 500


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_steps_are_one_static_program(kind, arch, request):
    """Two consecutive steps dispatch the same ops on the same output
    shapes; the int8 step's all-reduces are among them."""
    first, second = _traced_steps(kind, arch, request)
    assert first == second
    if kind == "int8":
        assert any("allreduce" in op for op, _ in first)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_fn_on_the_host_is_the_eager_step(kind, arch, request):
    """Three steps from the same params and state: the compiled function
    on CPU tensors (no graph, nothing adopted) and the in-place body its
    card graphs capture, each equal to the eager step bit for bit: every
    metric, param and state leaf (the error buffers too) after every
    step.  The body returns no trees: the copies it was given hold the
    new values."""
    cfg, tc, params, state, batches = _setup(kind, arch)
    eager, fn = _steps(kind, cfg, tc, request)
    assert isinstance(fn, TS.TrainFn) and fn.refuse is None
    p_fn, s_fn = _clone(params), _clone(state)
    p_own, s_own = _clone(params), _clone(state)
    own = pytree.tree_leaves((p_own, s_own))
    run = TS._in_place(fn.eager, p_own, s_own)
    for batch in batches:
        params, state, want = eager(params, state, batch)
        p_fn, s_fn, got = fn(p_fn, s_fn, batch)
        in_place = run(batch)
        assert fn.graphs == {} and fn.last is None and fn.params is None
        for m in (got, in_place):
            assert set(m) == set(want)
            for k in want:
                assert torch.equal(m[k], want[k]), k
        assert pytree.tree_leaves((p_own, s_own)) == own
        wanted = pytree.tree_leaves((params, state))
        for tree in ((p_fn, s_fn), (p_own, s_own)):
            for a, b in zip(pytree.tree_leaves(tree), wanted):
                assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(s_own["step"]) == 3
    assert ("ef" in s_own) == (kind == "int8")


def test_pp_fn_refuses_a_multi_rank_group_on_the_card():
    """The GPipe function over two stage ranks (a fake two-rank group,
    rank 0's stage) raises on a CUDA batch, naming ROADMAP A9.5, before
    it adopts a tree or launches anything: fake CUDA tensors, which hold
    no memory and run nothing, show it without a card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = tconfigs.get_arch("internlm2-1.8b").reduced()
    tc = TS.TrainConfig(**STEP_TC)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        fn = PP.make_pp_train_fn(cfg, tc, PC, group=dist.group.WORLD)
        params, state = PP.init_pp_state(cfg, tc, PC, stage=0, seed=1,
                                         device="cpu")
        with FakeTensorMode():
            batch = {k: torch.zeros((4, 16), dtype=torch.int32,
                                    device="cuda")
                     for k in ("tokens", "labels")}
        assert batch["tokens"].device.type == "cuda"
        with pytest.raises(RuntimeError, match="A9.5"):
            fn(params, state, batch)
        assert fn.params is None and fn.graphs == {}
    finally:
        dist.destroy_process_group()


def test_handoff_is_empty_after_a_step(monkeypatch):
    """Every activation the stages hand on is taken by the next stage
    within the step: the hand-off's wire is empty when the step returns
    (so no activation of a captured step is held outside its graph), and
    one left on the wire fails the loss."""
    hops = []

    class Recorded(PP._Handoff):
        def __init__(self):
            super().__init__()
            hops.append(self)

    monkeypatch.setattr(PP, "_Handoff", Recorded)
    cfg, tc, params, state, batches = _setup("pp", "internlm2-1.8b")
    fn = PP.make_pp_train_fn(cfg, tc, PC)
    fn(params, state, batches[0])
    assert len(hops) == 1 and hops[0]._wire == {}
    left = PP._Handoff()
    left.send(torch.ones(2), 0, 1)
    with pytest.raises(RuntimeError, match="never received"):
        left.loss(torch.ones(()), 4)


def test_int8_in_place_body_matches_the_reference(one_rank_gloo):
    """Two steps of the in-place body of ``make_compressed_train_fn`` on a
    one-rank gloo group (reduced internlm2-1.8b, the reference's initial
    params) against the reference's compressed step on a one-device
    'pod' mesh, on the same numpy batches, with
    ``tests/test_torch_compression.py``'s tolerance: loss and grad norm
    1e-5 relative, error buffers finite bf16, params within 5e-5 except
    elements whose int8 gradient rounded the other way (Adam moves those
    by up to 2·lr), fewer than 0.2%."""
    jcfg = get_arch("internlm2-1.8b").reduced()
    cfg = tconfigs.get_arch("internlm2-1.8b").reduced()
    jtc, tc = JS.TrainConfig(**INT8_TC), TS.TrainConfig(**INT8_TC)
    jp, js = JS.init_train_state(jax.random.key(0), jcfg, jtc)
    params = convert.load_reference_params(
        jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    state = TS.init_state(cfg, tc, params)
    jstep = jax.jit(JS.make_compressed_train_step(
        jcfg, jtc, JT.ShardRules(batch=("pod",), model=None),
        jax.make_mesh((1,), ("pod",))))
    fn = TS.make_compressed_train_fn(cfg, tc, one_rank_gloo)
    run = TS._in_place(fn.eager, params, state)
    it = ref_batches(jcfg, 2, 32, seed=1)
    for _ in range(2):
        batch = next(it)
        jp, js, jm = jstep(jp, js, batch)
        m = run({k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    assert int(state["step"]) == 2
    assert all(t.dtype == torch.bfloat16 and torch.isfinite(t).all()
               for t in pytree.tree_leaves(state["ef"]))
    got = convert.to_reference(params)
    n = flipped = 0
    for path, b in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jp)):
        a = got
        for k in path:
            a = a[k.key]
        d = np.abs(a - b)
        assert d.max() <= 2 * INT8_TC["lr"], jax.tree_util.keystr(path)
        n += d.size
        flipped += int((d > 5e-5).sum())
    assert flipped < 0.002 * n, (flipped, n)
