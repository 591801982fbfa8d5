"""The reference's compiled prefill in the port, on the CPU.

The reference jits its prefill (``repro.serve.engine.make_prefill_fn``);
the port's counterpart keeps one CUDA graph a key on the card and runs
``prefill_with_cache`` eagerly on the host.  Here, for all ten archs:

* the static-program guard, the host's stand-in for "a CUDA graph can
  capture it": under a ``TorchDispatchMode`` the prefill with
  ``impl="kernel"`` (the kernels' plain versions here) dispatches no op
  that reads a value on the host (``tests/test_torch_decode_static.py``'s
  ``SYNCS``), and two inputs of one shape dispatch the same ops with the
  same output shapes (hymba's ring past its 16-token window, qwen2-vl's
  embeds and M-RoPE positions, musicgen's codebooks);
* ``make_prefill_fn`` on CPU inputs is ``prefill_with_cache`` bit for bit,
  and within ``tests/test_torch_serve.py``'s tolerance of the reference's
  jitted prefill on the same numpy inputs and weights;
* what bounds the graphs on the card and counts their launches: the last
  position's logits (``last_only``), the most recently used graphs kept,
  launches counted from kernel names.

The capture itself runs on the card (``tests/test_torch_cuda.py -k
prefill_graph``).

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_prefill_static.py
"""
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import list_archs
from repro.serve.engine import make_prefill_fn as jmake_prefill_fn
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import kmeans as tk
from repro_torch.kernels import ssd as tssd
from repro_torch.serve import BatchServer, Request, make_prefill_fn
from repro_torch.serve.engine import prefill_with_cache

from test_torch_decode_static import SYNCS, _carried, _Ops, _seq, _torch

ARCHS = list_archs()
TOL = dict(atol=2e-3, rtol=2e-3)         # tests/test_torch_serve.py's
S, MAX_LEN = 24, 32     # 24 prompt positions: hymba's 16-slot ring wraps


def _traced_prefill(tcfg, tp, seed):
    inputs = _torch(_seq(tcfg, np.random.default_rng(seed), 2, S))
    with torch.no_grad(), _Ops() as mode:   # not inference_mode: the guard
        prefill_with_cache(tp, tcfg, inputs, max_len=MAX_LEN, impl="kernel")
    return mode.ops


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_reads_nothing_on_the_host(arch):
    """The kernel prefill of a 24-token prompt dispatches no op that reads
    a tensor's value on the host."""
    _, tcfg, _, tp = _carried(arch)
    ops = _traced_prefill(tcfg, tp, seed=1)
    synced = [op for op, _ in ops if op in SYNCS]
    assert not synced, synced
    assert len(ops) > 100


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_is_one_static_program(arch):
    """Two inputs of one shape (other tokens, codebook ids or embeddings)
    dispatch the same ops on the same output shapes."""
    _, tcfg, _, tp = _carried(arch)
    first = _traced_prefill(tcfg, tp, seed=1)
    other = _traced_prefill(tcfg, tp, seed=2)
    assert first == other


@pytest.mark.parametrize("arch", ARCHS)
def test_make_prefill_fn_on_the_host_is_the_eager_prefill(arch):
    """On CPU inputs ``make_prefill_fn(impl="kernel")`` is
    ``prefill_with_cache`` bit for bit (logits and every cache entry, bf16
    k/v), records no graph, and is within 2e-3 of the reference's jitted
    prefill on the same weights and numpy inputs."""
    cfg, tcfg, jp, tp = _carried(arch)
    seq = _seq(cfg, np.random.default_rng(3), 2, S)
    prefill = make_prefill_fn(tcfg, MAX_LEN, impl="kernel")
    got, gcache = prefill(tp, _torch(seq))
    with torch.inference_mode():
        want, wcache = prefill_with_cache(tp, tcfg, _torch(seq),
                                          max_len=MAX_LEN, impl="kernel")
    assert prefill.graphs == {} and prefill.last is None
    assert torch.equal(got, want)
    assert set(gcache) == set(wcache)
    for name, t in wcache.items():
        assert gcache[name].dtype == t.dtype, name
        assert torch.equal(gcache[name], t), name
    ref, rcache = jmake_prefill_fn(cfg, MAX_LEN)(
        jp, {k: jnp.asarray(v) for k, v in seq.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert set(rcache) == set(gcache)
    for name, t in rcache.items():
        assert tuple(gcache[name].shape) == t.shape, name
        np.testing.assert_allclose(
            gcache[name].float().numpy(), np.asarray(t, np.float32),
            err_msg=name, **TOL)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "musicgen-medium"])
def test_make_prefill_fn_last_only_is_the_last_position(arch):
    """``last_only`` returns the last position's logits (every codebook's)
    as a (B, 1, ...) tensor of its own, bit for bit those of the whole
    prefill, and the same cache."""
    _, tcfg, _, tp = _carried(arch)
    inputs = _torch(_seq(tcfg, np.random.default_rng(4), 2, S))
    full, fcache = make_prefill_fn(tcfg, MAX_LEN, impl="kernel")(tp, inputs)
    last, lcache = make_prefill_fn(tcfg, MAX_LEN, impl="kernel",
                                   last_only=True)(tp, inputs)
    assert last.shape == (full.shape[0], 1, *full.shape[2:])
    assert torch.equal(last, full[:, -1:])
    assert last.untyped_storage().nbytes() == last.numel() * 4
    assert set(lcache) == set(fcache)
    for name, t in fcache.items():
        assert torch.equal(lcache[name], t), name


def test_prefill_fn_keeps_the_most_recently_used_graphs():
    """A prefill function keeps at most ``MAX_PREFILL_GRAPHS`` graphs: a
    new key drops the least recently used first, and a replayed key
    becomes the most recently used (the bookkeeping of the card's path,
    with stand-ins for the graphs)."""
    from repro_torch.serve.engine import MAX_PREFILL_GRAPHS
    _, tcfg, _, _ = _carried("internlm2-1.8b")
    fn = make_prefill_fn(tcfg, MAX_LEN, impl="kernel")
    keys = list(range(MAX_PREFILL_GRAPHS))
    for key in keys:
        fn._make_room()
        fn.graphs[key] = object()
    assert fn._graph(0) is not None                 # 0 used last now
    fn._make_room()
    fn.graphs["new"] = object()
    assert list(fn.graphs) == [*keys[2:], 0, "new"]
    assert fn._graph(1) is None


def test_launches_counted_from_kernel_names():
    """``count_launches`` reads the launches a graph holds from its kernel
    nodes' mangled names: each flash and SSD instance counts for its
    counter, and nothing else does (a longer identifier that ends in the
    same letters, PyTorch's own kernels; none of them is k-means')."""
    names = [
        "_ZN12_GLOBAL__N_13f329flash_f32ILi64ELb1EEEvPKfS3_S3_Pfiiiiiiif",
        "_ZN12_GLOBAL__N_14bf1610flash_bf16ILi128ELi64EEEv14CUtensorMap_st",
        "_ZN12_GLOBAL__N_116ssd_chunk_kernelIfLi64ELi64EEEvPKT_PKf",
        "_ZN12_GLOBAL__N_116ssd_chunk_kernelI13__nv_bfloat16Li128ELi64EEEv",
        "_ZN12_GLOBAL__N_119my_flash_f32_helperEv",
        "_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_"
        "11FillFunctorIfEE",
        "ampere_sgemm_128x64_tn"]
    counts = build.count_launches(names)
    assert counts[tfa.LAUNCHES["flash_attention"]] == 2
    assert counts[tssd.LAUNCHES["ssd_chunk_scan"]] == 2
    assert all(counts[c] == 0 for c in tk.LAUNCHES.values())
    assert sum(counts.values()) == 4


def test_batch_server_prefill_on_the_host_records_no_graph():
    """The server's prefill is its ``prefill_fn``, which returns the last
    position's logits only; on the host each wave records no prefill graph
    (capture seconds, nodes and kernel nodes None)."""
    _, tcfg, _, tp = _carried("internlm2-1.8b")
    server = BatchServer(tp, tcfg, n_slots=2, max_len=16, device="cpu")
    assert not hasattr(server, "_prefill1")
    logits, _ = server.prefill_fn(tp, _torch(_seq(
        tcfg, np.random.default_rng(2), 2, 6)))
    assert logits.shape[1] == 1
    rng = np.random.default_rng(1)
    for i, n in enumerate((6, 6, 9)):
        server.submit(Request(request_id=f"r{i}", prompt=rng.integers(
            1, tcfg.vocab_size, n).astype(np.int32), max_new_tokens=3))
    done = server.run(max_requests=3, idle_timeout_s=0.5)
    assert [len(r.result_tokens) for r in done] == [3, 3, 3]
    assert [w["prompt_len"] for w in server.waves] == [6, 9]
    for w in server.waves:
        assert w["prefill_capture_s"] is None
        assert w["prefill_nodes"] is None and w["prefill_kernels"] is None
    assert server.prefill_fn.graphs == {}


def test_launch_counter_add():
    """``add`` moves the count by any amount (a replay adds what its
    capture recorded, a capture takes back what it counted), under threads
    too; every kernel module's counter is listed in ``COUNTERS``."""
    c = build.LaunchCounter()
    try:
        c.incr()
        c.add(5)
        c.add(-2)
        assert c.count == 4
        c.reset()
        assert c.count == 0
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            workers = [threading.Thread(target=lambda: [
                (c.add(3), c.incr(), c.add(-2)) for _ in range(500)])
                for _ in range(16)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=30)
            assert not any(w.is_alive() for w in workers)
        finally:
            sys.setswitchinterval(interval)
        assert c.count == 16 * 500 * 2
        assert c in build.COUNTERS
    finally:
        build.COUNTERS.remove(c)
    for launches in (tfa.LAUNCHES, tssd.LAUNCHES, tk.LAUNCHES):
        for counter in launches.values():
            assert counter in build.COUNTERS


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_counts_the_prefill_ops_on_meta(arch):
    """``chip_smoke.prefill_ops`` (the host's op count that the card run
    sets beside each prefill graph's kernel nodes) runs for every arch at
    full width on meta tensors, and grows with the prompt only where the
    SSD's recurrence across chunks does."""
    import dataclasses
    import importlib.util
    import os
    from repro_torch import configs as tconfigs
    from repro_torch.models import transformer as TT
    from repro_torch.serve import engine
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = dataclasses.replace(tconfigs.get_arch(arch), n_layers=2)
    short = cs.prefill_ops(torch, TT, engine, cfg, 4, 256)
    long = cs.prefill_ops(torch, TT, engine, cfg, 4, 512)
    assert short > 20 * cfg.n_layers
    assert (long > short) == (cfg.ssm is not None)


def test_prefill_fn_and_its_graphs_hold_no_cycle():
    """A graph keeps the prefill it runs, but nothing that leads back to
    its function: dropping the last reference to the function frees it,
    its graphs and (on the card) their pool at once, without waiting for
    the garbage collector.  The graph is built here as the card's first
    call builds it, but not captured."""
    import gc
    import weakref
    from repro_torch.serve.engine import PrefillGraph
    _, tcfg, _, tp = _carried("internlm2-1.8b")
    fn = make_prefill_fn(tcfg, MAX_LEN, impl="kernel")
    inputs = _torch(_seq(tcfg, np.random.default_rng(0), 2, S))
    fn.graphs["key"] = PrefillGraph(tp, inputs, fn.eager)
    refs = [weakref.ref(fn), weakref.ref(fn.graphs["key"])]
    gc.disable()
    try:
        del fn
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()
