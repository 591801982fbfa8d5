"""The reference's compiled train step in the port, on the CPU.

The reference jits its train step (``repro/launch/train.py:57``); the
port's counterpart, ``train.step.make_train_fn``, keeps one CUDA graph a
batch shape on the card, with the params and the optimizer state updated
in place inside it, and runs ``make_train_step`` eagerly on the host.
Here, for all ten reduced archs:

* the static-program guard, the host's stand-in for "a CUDA graph can
  capture it": under a ``TorchDispatchMode`` a train step (forward,
  backward with remat, clip and optimizer; microbatches 1 and 2)
  dispatches no op that reads a value on the host
  (``tests/test_torch_decode_static.py``'s ``SYNCS``), and two
  consecutive steps dispatch the same ops with the same output shapes;
* ``make_train_fn`` on the host is ``make_train_step`` bit for bit, and
  so is the in-place body the card's graph captures (the step, then its
  new trees copied into the function's buffers), run here eagerly;
  against the reference's jitted step, ``tests/test_torch_train.py``'s
  tolerances;
* ``train_loop`` still asks for the card when no device is named, and a
  train function and its graphs hold no reference cycle.

The capture itself runs on the card (``tests/test_torch_cuda.py -k
train_graph``).

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_train_static.py
"""
import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_arch, list_archs
from repro.data import make_batch_iterator as ref_batches
from repro.train import step as JS
from repro_torch import configs as tconfigs
from repro_torch.data import make_batch_iterator
from repro_torch.launch import train as TLaunch
from repro_torch.models import convert
from repro_torch.train import step as TS

from test_torch_decode_static import SYNCS, _Ops

ARCHS = list_archs()
STEP_TC = dict(lr=1e-3, warmup=2, total_steps=20)   # test_torch_train's
PARAM_ATOL = 5e-5                                   # test_torch_train's
REF_ARCHS = ["internlm2-1.8b", "mamba2-130m", "qwen3-moe-235b-a22b"]


def _setup(arch, micro, seed=1):
    """Reduced ``arch``: its params and zero state from a seed, the train
    config with ``micro`` microbatches, and three batches of 2 × 16."""
    cfg = tconfigs.get_arch(arch).reduced()
    tc = TS.TrainConfig(**STEP_TC, microbatches=micro)
    params, state = TS.init_train_state(cfg, tc, seed=seed, device="cpu")
    it = make_batch_iterator(cfg, 2, 16, seed=seed, device="cpu")
    return cfg, tc, params, state, [next(it) for _ in range(3)]


def _clone(tree):
    return pytree.tree_map(torch.clone, tree)


@functools.lru_cache(maxsize=None)
def _traced_steps(arch, micro):
    """The ops of two consecutive train steps, each with its outputs'
    shapes."""
    cfg, tc, params, state, batches = _setup(arch, micro)
    step = TS.make_train_step(cfg, tc)
    traces = []
    for batch in batches[:2]:
        with _Ops() as mode:
            params, state, _ = step(params, state, batch)
        traces.append(mode.ops)
    return traces


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_reads_nothing_on_the_host(arch, micro):
    """Forward, backward (remat recomputing each block), clip and the
    optimizer (AdamW, or Adafactor over the stacked layout): no op that
    reads a tensor's value on the host, in either step."""
    first, second = _traced_steps(arch, micro)
    synced = [op for op, _ in first + second if op in SYNCS]
    assert not synced, synced
    assert len(first) > 500


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_are_one_static_program(arch, micro):
    """Two consecutive steps (the step count and the learning rate only
    in device tensors) dispatch the same ops on the same output shapes."""
    first, second = _traced_steps(arch, micro)
    assert first == second


def test_guard_sees_an_item():
    """The guard's premise for a train step: a step whose loss is read
    back with ``.item()`` (as a logging hook inside the step would) shows
    a host read."""
    cfg, tc, params, state, batches = _setup("internlm2-1.8b", 1)
    step = TS.make_train_step(cfg, tc)

    def logging_step(p, s, b):
        out = step(p, s, b)
        out[2]["loss"].item()
        return out

    with _Ops() as mode:
        logging_step(params, state, batches[0])
    assert any(op in SYNCS for op, _ in mode.ops)


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_fn_on_the_host_is_make_train_step(arch, micro):
    """Three steps from the same params and state: ``make_train_fn`` on
    CPU tensors (no graph, nothing adopted), and the in-place body its
    card graphs capture (``TS._in_place``, run eagerly here on copies of
    the trees), each equal to ``make_train_step`` bit for bit: loss,
    grad norm, params and state after every step.  The body returns no
    trees: the copies it was given hold the new values."""
    cfg, tc, params, state, batches = _setup(arch, micro)
    eager = TS.make_train_step(cfg, tc)
    fn = TS.make_train_fn(cfg, tc)
    p_fn, s_fn = _clone(params), _clone(state)
    p_own, s_own = _clone(params), _clone(state)
    own = pytree.tree_leaves((p_own, s_own))
    run = TS._in_place(eager, p_own, s_own)
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


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_make_train_fn_matches_the_reference(arch):
    """Three steps of the reference's jitted step and of ``make_train_fn``
    from the reference's initial params and zero state on the same numpy
    batches (AdamW; Adafactor over the stacked layout and the MoE router
    for qwen3-moe): loss and grad norm 1e-5 relative, params within 5e-5
    after each step."""
    jcfg = get_arch(arch).reduced()
    cfg = tconfigs.get_arch(arch).reduced()
    jtc, tc = JS.TrainConfig(**STEP_TC), TS.TrainConfig(**STEP_TC)
    jparams, jstate = JS.init_train_state(jax.random.key(0), jcfg, jtc)
    params = convert.load_reference_params(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    state = TS.init_state(cfg, tc, params)
    jstep = jax.jit(JS.make_train_step(jcfg, jtc))
    fn = TS.make_train_fn(cfg, tc)
    it = ref_batches(jcfg, 4, 32, seed=1)
    for i in range(3):
        batch = next(it)
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        params, state, m = fn(params, state, {
            k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
        got = dict(jax.tree_util.tree_leaves_with_path(
            convert.to_reference(params)))
        for path, b in jax.tree_util.tree_leaves_with_path(
                jax.tree_util.tree_map(np.asarray, jparams)):
            np.testing.assert_allclose(
                got[path], b, atol=PARAM_ATOL, rtol=0,
                err_msg=f"step {i + 1} {jax.tree_util.keystr(path)}")
    assert int(state["step"]) == 3


def test_train_loop_without_a_device_asks_for_the_card():
    """``train_loop`` on its train function still defaults to ``cuda:0``,
    which raises on a host without a card, before any step."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tconfigs.get_arch("mamba2-130m").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLaunch.train_loop(cfg, TS.TrainConfig(), steps=1, batch=1,
                           seq_len=8, log=lambda *_: None)


def test_train_fn_and_its_graphs_hold_no_cycle():
    """A graph keeps the in-place step it runs, and through it the
    function's buffers, but nothing that leads back to its function:
    dropping the last reference to the function frees it and its graphs
    (on the card, their pool) at once, without waiting for the garbage
    collector, and the buffers live on in the caller's trees.  The
    function adopts its trees and the graph is built here as the card's
    first call builds them, but not captured."""
    import gc
    import weakref
    cfg, tc, params, state, batches = _setup("internlm2-1.8b", 1)
    fn = TS.make_train_fn(cfg, tc)
    fn._load(params, state)
    assert pytree.tree_leaves((fn.params, fn.state)) == \
        pytree.tree_leaves((params, state))
    fn.graphs["key"] = TS.TrainGraph(batches[0], fn._run)
    refs = [weakref.ref(fn), weakref.ref(fn.graphs["key"])]
    gc.disable()
    try:
        del fn
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_train_fn_copies_a_foreign_tree_into_its_buffers():
    """After adopting one tree, a call's other leaves (a resumed
    checkpoint) are copied into the function's buffers, which stay the
    leaves the function returns; a tree of another structure or leaf
    shape raises."""
    cfg, tc, params, state, _ = _setup("mamba2-130m", 1)
    fn = TS.make_train_fn(cfg, tc)
    fn._load(params, state)
    own = pytree.tree_leaves((fn.params, fn.state))
    other_p, other_s = _clone(params), _clone(state)
    for t in pytree.tree_leaves(other_p):
        t.add_(1.0)
    other_s["step"].fill_(7)
    fn._load(other_p, other_s)
    assert pytree.tree_leaves((fn.params, fn.state)) == own
    for a, b in zip(own, pytree.tree_leaves((other_p, other_s))):
        assert a is not b and torch.equal(a, b)
    with pytest.raises(ValueError, match="structure"):
        fn._load({"embed": params["embed"]}, state)
    wide = _clone(params)
    wide["ln_f"] = torch.zeros(wide["ln_f"].shape[0] + 1)
    with pytest.raises(ValueError, match="shape"):
        fn._load(wide, state)
