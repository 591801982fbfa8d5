"""The reference's static-shape decode step in the port, on the CPU: the
position as a 0-d tensor (``repro.serve.engine``'s
``jnp.asarray(length, jnp.int32)``) gives the int position's step bit for
bit, for all ten archs (hymba's ring past its 16-token window, MLA's
latents, qwen2-vl's (3, B, 1) M-RoPE positions), and the reference's step
within ``tests/test_torch_serve.py``'s tolerance.

The static-program guard is the host's stand-in for "a CUDA graph can
capture it": under a ``TorchDispatchMode`` a tensor-position step
dispatches no op that reads a value on the host (``item``,
``_local_scalar_dense``, ``nonzero``, ``unique`` and the like), and two
positions dispatch the same ops with the same output shapes.  It runs
under ``no_grad``, not ``inference_mode``, whose dispatch hands the mode
some composite ops whole (``one_hot``) and hides the reads inside them.
The capture itself runs on the card (``tests/test_torch_cuda.py``).

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_decode_static.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch, list_archs
from repro.models import transformer as JT
from repro.serve.engine import prefill_with_cache as jprefill
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import transformer as TT
from repro_torch.serve import BatchServer, Request, make_decode_fn
from repro_torch.serve.engine import prefill_with_cache

ARCHS = list_archs()
CACHE_DTYPES = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = dict(atol=2e-3, rtol=2e-3)         # tests/test_torch_serve.py's
S, N = 12, 8          # positions 12..19: hymba's 16-slot ring wraps at 16
# the ops that read a tensor's value on the host: ``item`` (what indexing
# with a 0-d tensor dispatches), its kernel, ``bool()``, ``equal``, and
# the ops whose output shape depends on the values
SYNCS = {"aten.item", "aten._local_scalar_dense", "aten.is_nonzero",
         "aten.equal", "aten.nonzero", "aten.unique_consecutive",
         "aten._unique", "aten._unique2", "aten.unique_dim", "aten.one_hot"}


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


def _part(seq, lo, hi):
    return {k: (v[:, :, lo:hi] if k == "positions" else v[:, lo:hi])
            for k, v in seq.items()}


def _torch(part):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in part.items()}


def _prefilled(arch, cache_dtype, b=2):
    jd, td = CACHE_DTYPES[cache_dtype]
    cfg, tcfg, jp, tp = _carried(arch)
    seq = _seq(cfg, np.random.default_rng(7), b, S + N)
    first = _part(seq, 0, S)
    _, jc = jprefill(jp, cfg, {k: jnp.asarray(v) for k, v in first.items()},
                     max_len=S + N, cache_dtype=jd)
    with torch.no_grad():               # not inference tensors: the guard
        _, tc = prefill_with_cache(tp, tcfg, _torch(first), max_len=S + N,
                                   impl="kernel", cache_dtype=td)
    return cfg, tcfg, jp, tp, seq, jc, tc


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cache_dtype", sorted(CACHE_DTYPES))
def test_tensor_position_is_the_int_step_and_the_reference(arch,
                                                           cache_dtype):
    """8 steps from one prefill: the 0-d int32 tensor position against the
    host int, logits and every cache entry bit for bit; against the
    reference's decode_step, logits each step and the cache after, 2e-3."""
    cfg, tcfg, jp, tp, seq, jc, tc = _prefilled(arch, cache_dtype)
    ti = {k: v.clone() for k, v in tc.items()}
    for i in range(N):
        part = _part(seq, S + i, S + i + 1)
        want, jc = JT.decode_step(
            jp, cfg, jc, {**{k: jnp.asarray(v) for k, v in part.items()},
                          "length": jnp.asarray(S + i, jnp.int32)})
        with torch.inference_mode():
            got, tc = TT.decode_step(tp, tcfg, tc, {
                **_torch(part), "length": torch.tensor(S + i,
                                                       dtype=torch.int32)})
            ref, ti = TT.decode_step(tp, tcfg, ti, {**_torch(part),
                                                    "length": S + i})
        assert torch.equal(got, ref), f"step {i}"
        np.testing.assert_allclose(got.float().numpy(), np.asarray(
            want, np.float32), err_msg=f"step {i}", **TOL)
    assert set(tc) == set(ti) == set(jc)
    for name in tc:
        assert tc[name].dtype == ti[name].dtype, name
        assert torch.equal(tc[name], ti[name]), name
        np.testing.assert_allclose(
            tc[name].float().numpy(), np.asarray(jc[name], np.float32),
            err_msg=name, **TOL)


class _Ops(TorchDispatchMode):
    """Every op dispatched, with the shapes of its outputs."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shapes = tuple(tuple(t.shape) for t in pytree.tree_leaves(out)
                       if isinstance(t, torch.Tensor))
        self.ops.append((str(func.overloadpacket), shapes))
        return out


def _traced_step(tcfg, tp, cache, seq, pos):
    with torch.no_grad(), _Ops() as mode:
        TT.decode_step(tp, tcfg, cache, {
            **_torch(_part(seq, pos, pos + 1)),
            "length": torch.tensor(pos, dtype=torch.int32)})
    return mode.ops


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_position_step_is_one_static_program(arch):
    """Two positions, 12 and 17 (past hymba's ring's wrap at 16): no op
    that reads a value on the host, and the same ops on the same output
    shapes at both."""
    _, tcfg, _, tp, seq, _, tc = _prefilled(arch, "bf16")
    first = _traced_step(tcfg, tp, tc, seq, S)
    later = _traced_step(tcfg, tp, tc, seq, S + 5)
    synced = [op for op, _ in first + later if op in SYNCS]
    assert not synced, synced
    assert len(first) > 100
    assert first == later


def test_guard_sees_a_host_read():
    """The guard's premise: indexing with a 0-d tensor (the int path's
    write with a tensor position), and ``F.one_hot``'s range check on the
    CPU, do read the host."""
    cache, idx = torch.zeros((2, 5, 3)), torch.tensor(2, dtype=torch.int32)
    ids = torch.tensor([1, 2])
    for write in (lambda: cache.__setitem__((slice(None), idx),
                                            torch.ones((2, 3))),
                  lambda: torch.nn.functional.one_hot(ids, 4)):
        with torch.no_grad(), _Ops() as mode:
            write()
        assert any(op in SYNCS for op, _ in mode.ops), mode.ops


def test_make_decode_fn_on_the_host_is_the_eager_step():
    """On a CPU cache ``make_decode_fn`` runs ``decode_step`` itself: no
    graph, the same logits bit for bit, the caller's cache updated."""
    cfg, tcfg, _, tp, seq, _, tc = _prefilled("hymba-1.5b", "bf16")
    decode = make_decode_fn(tcfg)
    ti = {k: v.clone() for k, v in tc.items()}
    for i in range(3):
        inp = {**_torch(_part(seq, S + i, S + i + 1)),
               "length": torch.tensor(S + i, dtype=torch.int32)}
        got, out = decode(tp, tc, inp)
        with torch.inference_mode():
            want, ti = TT.decode_step(tp, tcfg, ti, inp)
        assert out is tc and torch.equal(got, want)
    assert decode.graphs == {} and decode.last is None


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "musicgen-medium"])
def test_batch_server_passes_the_position_as_a_tensor(arch):
    """Each decode call gets a 0-d int32 position on the server's device,
    counting up from the prompt length; the host records no graph."""
    _, tcfg, _, tp = _carried(arch)
    server = BatchServer(tp, tcfg, n_slots=2, max_len=16, device="cpu")
    seen, decode = [], server._decode

    def spy(p, cache, inputs):
        seen.append(inputs["length"])
        return decode(p, cache, inputs)

    server._decode = spy
    rng = np.random.default_rng(1)
    for i in range(2):
        server.submit(Request(request_id=f"r{i}", prompt=rng.integers(
            1, tcfg.vocab_size, 10).astype(np.int32), max_new_tokens=4))
    done = server.run(max_requests=2, idle_timeout_s=0.5)
    assert [len(r.result_tokens) for r in done] == [4, 4]
    assert [int(t) for t in seen] == [10, 11, 12]
    assert all(t.dim() == 0 and t.dtype == torch.int32
               and t.device.type == "cpu" for t in seen)
    assert server.waves[0]["graph_nodes"] is None
    assert server.waves[0]["graph_capture_s"] is None


@pytest.mark.parametrize("arch,raises", [("internlm2-1.8b", True),
                                         ("minicpm3-4b", True),
                                         ("hymba-1.5b", False),
                                         ("mamba2-130m", False)])
def test_batch_server_checks_the_position_on_the_host(arch, raises):
    """A position past ``max_len`` in a cache that is not a ring raises
    on the host before the step (on the card, inside a graph, it would be
    a device assert); rings and pure SSM states have no such bound."""
    _, tcfg, _, tp = _carried(arch)
    server = BatchServer(tp, tcfg, n_slots=1, max_len=12, device="cpu")
    server.submit(Request(request_id="r", prompt=np.arange(
        1, 11, dtype=np.int32), max_new_tokens=5))
    if raises:
        with pytest.raises(ValueError, match="past max_len"):
            server.run(max_requests=1, idle_timeout_s=0.5)
    else:
        done = server.run(max_requests=1, idle_timeout_s=0.5)
        assert len(done[0].result_tokens) == 5


def _stub_graphs(fn, trees):
    """``fn.graphs`` holding a stand-in graph a (key, params tree), as the
    card's calls leave them (the graph keeps the tree it was captured
    with)."""
    from types import SimpleNamespace
    for key, tree in trees:
        fn.graphs[key] = SimpleNamespace(params=tree)


@pytest.mark.parametrize("make", ["decode", "prefill"])
def test_graph_functions_keep_one_params_tree(make):
    """ROADMAP C9, the bookkeeping of the card's path with stand-ins for
    the graphs: a call with tree B drops the graphs of every other tree
    (and ``last``, if it is one of them), so once the caller drops tree A
    nothing holds it; the graphs of B stay, in their order."""
    import gc
    import weakref
    from repro_torch.serve import make_prefill_fn
    tcfg = tconfigs.get_arch("internlm2-1.8b").reduced()
    fn = (make_decode_fn(tcfg) if make == "decode"
          else make_prefill_fn(tcfg, 16, impl="kernel"))
    a, b = {"w": torch.zeros(3)}, {"w": torch.ones(3)}
    gone = weakref.ref(a["w"])
    _stub_graphs(fn, [("a1", a), ("b1", b), ("a2", a), ("b2", b)])
    fn.last = fn.graphs["a2"]
    del a
    gc.disable()
    try:
        fn._keep_params(b)
        assert gone() is None
    finally:
        gc.enable()
    assert list(fn.graphs) == ["b1", "b2"] and fn.last is None
    fn.last = fn.graphs["b2"]
    fn._keep_params(b)
    assert list(fn.graphs) == ["b1", "b2"] and fn.last is fn.graphs["b2"]


def test_decode_fn_keeps_the_most_recently_used_graphs():
    """A decode function keeps at most ``MAX_DECODE_GRAPHS`` graphs (each
    holds its cache): a new key drops the least recently used first, and
    a replayed key becomes the most recently used."""
    from repro_torch.serve.engine import MAX_DECODE_GRAPHS
    decode = make_decode_fn(tconfigs.get_arch("internlm2-1.8b").reduced())
    keys = list(range(MAX_DECODE_GRAPHS))
    for key in keys:
        decode._make_room()
        decode.graphs[key] = object()
    assert decode._graph(0) is not None             # 0 used last now
    decode._make_room()
    decode.graphs["new"] = object()
    assert list(decode.graphs) == [*keys[2:], 0, "new"]
    assert decode._graph(1) is None
