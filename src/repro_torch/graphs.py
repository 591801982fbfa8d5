"""What the port's CUDA graphs share: the one capture stream a device, the
capture itself, the key a graph is kept under, the nodes a captured graph
holds, read back from the graph, and :class:`GraphFn`, a function's
compiled form.

The reference compiles its prefill, its decode step and its train step
with ``jax.jit``; the port captures each of them as a CUDA graph on the
card (``serve.engine.PrefillGraph`` and ``DecodeGraph``,
``train.step.TrainGraph``), all through :func:`_captured` on the stream
:func:`_capture_stream` gives.  The outlier models' jitted functions
(``ml.kmeans``, ``ml.autoencoder``, ``ml.isoforest``) are :class:`GraphFn`
objects: one graph a key, functional and thread-safe, since the cloud
stage's workers call them at once.

Every graph function records spans into the process-wide
``repro_torch.spans.REGISTRY``: ``graphs.warm`` (:func:`_warmed`),
``graphs.capture`` with its children ``graphs.stream_capture``
(``capture_begin`` to ``capture_end``) and ``graphs.instantiate``
(:func:`_captured`), ``graphs.nodes`` (the captured graph's nodes read
back), and at a replay ``graphs.lookup`` (the key and the checks of the
params tree), ``graphs.load`` (the copies into the graph's static inputs)
and ``graphs.replay`` (the replay call alone).
"""
from __future__ import annotations

import ctypes
import gc
import threading
import time
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import build
from repro_torch.spans import REGISTRY


def _kernel_nodes(cu, graph: "torch.cuda.CUDAGraph") -> Tuple[int, list]:
    """(nodes, the kernel nodes' handles) of a graph captured with
    ``keep_graph=True``, read from its ``cudaGraph_t``."""
    return _nodes_of(cu, ctypes.c_void_p(graph.raw_cuda_graph()))


def _nodes_of(cu, handle: ctypes.c_void_p, kinds=None) -> Tuple[int, list]:
    """(nodes, the kernel nodes' handles) of the ``CUgraph`` ``handle``.
    ``kinds``, a dict of node handle to its type, is consulted and filled
    in, so a graph read again and again has each node's type asked once."""
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(0), []
    kinds = {} if kinds is None else kinds
    for node in nodes:
        if node not in kinds:
            if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) != 0:
                raise RuntimeError("cuGraphNodeGetType failed")
            kinds[node] = kind.value
        if kinds[node] == 0:                        # CU_GRAPH_NODE_TYPE_KERNEL
            kernels.append(node)
    return n.value, kernels


def capture_kernel_nodes():
    """A function that returns the kernel nodes (a set of handles) that
    the graph being captured on the current stream holds so far, read
    with ``cuStreamGetCaptureInfo``: a ``spans.NodeTally``'s ``read``.
    Call it, and the function, while the capture runs."""
    cu = ctypes.CDLL("libcuda.so.1")
    status, graph = ctypes.c_int(0), ctypes.c_void_p(0)
    kinds: Dict[int, int] = {}

    def read() -> set:
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if cu.cuStreamGetCaptureInfo_v2(stream, ctypes.byref(status), None,
                                        ctypes.byref(graph), None,
                                        None) != 0 or status.value != 1:
            raise RuntimeError("the current stream is not capturing a graph")
        return set(_nodes_of(cu, graph, kinds)[1])
    return read


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> Tuple[int, int]:
    """(nodes, kernel nodes) of a graph captured with ``keep_graph=True``,
    read with ``libcuda``'s ``cuGraphGetNodes``."""
    n, kernels = _kernel_nodes(ctypes.CDLL("libcuda.so.1"), graph)
    return n, len(kernels)


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of ``cuda.h``."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


def graph_kernel_names(graph: "torch.cuda.CUDAGraph") -> Tuple[int, List[str]]:
    """(nodes, the mangled function name of each kernel node) of a graph
    captured with ``keep_graph=True``: what the graph launches, read from
    the graph itself (``cuGraphKernelNodeGetParams`` and
    ``cuFuncGetName``, or ``cuKernelGetName`` for a node that holds a
    ``CUkernel``)."""
    cu = ctypes.CDLL("libcuda.so.1")
    n, kernels = _kernel_nodes(cu, graph)
    names = []
    for node in kernels:
        p, name = _KernelNodeParams(), ctypes.c_char_p()
        if cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                            ctypes.byref(p)) != 0:
            raise RuntimeError("cuGraphKernelNodeGetParams failed")
        if p.func:
            err = cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(p.func))
        else:
            err = cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(p.kern))
        if err != 0 or name.value is None:
            raise RuntimeError(f"no name for a kernel node (CUDA error "
                               f"{err})")
        names.append(name.value.decode())
    return n, names


_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(dev: torch.device) -> "torch.cuda.Stream":
    """The one side stream on which every graph of ``dev`` (prefill,
    decode and train step) warms up and is captured.  cuBLAS keeps a
    workspace (32 MiB on an H100) for each stream it has run on, for the
    life of the process: a stream a graph would leave one behind with
    every server."""
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[dev]


def _spec(tree) -> tuple:
    """The key of a dict of tensors: its names, shapes and types, as
    jit's cache keys a call's arguments."""
    return tuple((k, tuple(v.shape), v.dtype)
                 for k, v in sorted(tree.items()))


def _warmed(stream: "torch.cuda.Stream", fn):
    """``fn()`` run eagerly on ``stream``, a graph's warm-up before its
    capture there: cuBLAS, the allocator and autograd set up what a
    capture cannot, on the capturing stream, and that call is a real one.
    It starts after the current stream's queued work and the current
    stream waits for it; the tensors it returns are recorded on the
    current stream, where the caller uses them.  Returns what ``fn``
    returned; the span ``graphs.warm`` times it."""
    with REGISTRY.span("graphs.warm"):
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = fn()
        cur.wait_stream(stream)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                t.record_stream(cur)
        return out


def _captured(stream: "torch.cuda.Stream", fn, pool=None, generators=()):
    """``fn()`` captured on ``stream`` into a new graph (in ``pool`` if
    given), kept for :func:`graph_nodes` and instantiated.  Returns (graph,
    what ``fn`` returned, the seconds taken).  An op that cannot be
    captured raises its own error; the device's default generator and
    ``generators``, which the failed capture leaves in its capturing
    state, are given back their seed and offset outside any capture
    (:func:`_restore_generators`), so they draw again.  The capture is
    thread-local: the autograd engine's device thread, which runs a train
    step's backward, queues its kernels on the capturing stream and is
    captured too.  Unreachable objects are collected first (as
    ``torch.cuda.graph`` does): a graph freed while another captures, by
    a collection that the capture's own allocations set off, invalidates
    that capture.

    ``generators`` are the CUDA ``torch.Generator``s that ``fn`` draws
    from: each is registered with the graph, which then reads its seed and
    offset at every replay (and moves the offset on by what the capture
    drew).

    Spans: ``graphs.capture``, and inside it ``graphs.stream_capture``
    and ``graphs.instantiate``."""
    with REGISTRY.span("graphs.capture"):
        t0 = time.perf_counter()
        gc.collect()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in generators:
            graph.register_generator_state(gen)
        with REGISTRY.span("graphs.stream_capture"), \
                torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:    # the error above invalidated it
                    _restore_generators(stream.device, generators)
                raise
            graph.capture_end()
        with REGISTRY.span("graphs.instantiate"):
            graph.instantiate()
        return graph, out, time.perf_counter() - t0


def _restore_generators(dev: torch.device, generators=()) -> None:
    """Gives the default generator of ``dev`` and ``generators`` a new
    state that holds their seed and offset and is not capturing: a capture
    that ends in an error never closes the states it opened, and a state
    left open refuses to draw outside a capture."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    for gen in (torch.cuda.default_generators[index], *generators):
        fresh = torch.Generator(device=dev)
        fresh.manual_seed(gen.initial_seed())
        fresh.set_offset(gen.get_offset())
        gen.graphsafe_set_state(fresh.graphsafe_get_state())


class _GraphCache:
    """The graphs a graph function keeps (``graphs``, the least recently
    used first, at most ``limit``), the graph of its last call (``last``,
    None on the host) and the graphs it dropped to make room
    (``evictions``)."""

    limit: int

    def __init__(self):
        self.graphs: "OrderedDict[tuple, object]" = OrderedDict()
        self.last = None
        self.evictions = 0

    def _graph(self, key):
        g = self.graphs.get(key)
        if g is not None:
            self.graphs.move_to_end(key)
        return g

    def _make_room(self) -> None:
        """Drop the least recently used graphs until one more fits; their
        outputs go back to the pool, for the next capture."""
        while len(self.graphs) >= self.limit:
            self.graphs.popitem(last=False)
            self.evictions += 1


class Captured(NamedTuple):
    """:func:`_counted_capture`'s result: the graph, what the captured
    function returned, the seconds the capture took, the graph's nodes and
    kernel nodes, the launches a replay adds to each counter (read from
    its kernel nodes) and those the wrappers counted at the capture."""
    graph: "torch.cuda.CUDAGraph"
    out: object
    seconds: float
    nodes: int
    kernels: int
    launches: list
    counted: list


def _counted_capture(stream, fn, pool=None, generators=(),
                     what: str = "graph") -> Captured:
    """:func:`_captured`, with the kernel launches it holds accounted for.
    A replay runs no Python, so no kernel wrapper counts its launches: the
    capture takes back what the wrappers counted on this thread (it
    launched nothing), and ``launches`` holds, for each counter with
    ``symbols``, the graph's kernel nodes that run its kernels, read from
    the graph (:func:`graph_kernel_names`); every replay adds them.  The
    two must agree, or this raises."""
    counters = build.COUNTERS
    before = [c.mine() for c in counters]
    try:
        graph, out, seconds = _captured(stream, fn, pool, generators)
    finally:
        counted = [(c, c.mine() - n) for c, n in zip(counters, before)]
        for c, n in counted:
            c.add(-n)
    counted = [(c, n) for c, n in counted if n]
    with REGISTRY.span("graphs.nodes"):
        nodes, names = graph_kernel_names(graph)
    launches = [(c, n) for c, n in build.count_launches(names).items() if n]
    if dict(counted) != dict(launches):
        raise RuntimeError(
            f"the {what}'s kernel nodes run "
            f"{ {c.symbols: n for c, n in launches} } where the wrappers "
            f"counted { {c.symbols: n for c, n in counted} }")
    return Captured(graph, out, seconds, nodes, len(names), launches,
                    counted)


# graphs a GraphFn keeps: each holds its static inputs and outputs
MAX_GRAPHS = 8
# warm-up and capture share the capture stream: one at a time
_CAPTURE_LOCK = threading.Lock()


def _pack(out):
    """The tensors of the tree ``out`` concatenated into one flat buffer a
    dtype, and the layout :func:`_unpack` rebuilds the tree from."""
    leaves, spec = pytree.tree_flatten(out)
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        raise TypeError("a compiled function must return tensors only")
    dtypes = list(dict.fromkeys(t.dtype for t in leaves))
    groups = [[t for t in leaves if t.dtype == d] for d in dtypes]
    flats = [torch.cat([t.reshape(-1) for t in g]) for g in groups]
    sizes = [[t.numel() for t in g] for g in groups]
    seen = [0] * len(dtypes)
    where = []
    for t in leaves:
        g = dtypes.index(t.dtype)
        where.append((g, seen[g], t.shape))
        seen[g] += 1
    return flats, (sizes, where, spec)


def _unpack(flats, layout):
    """The tree :func:`_pack` took apart, as views of ``flats``."""
    sizes, where, spec = layout
    parts = [f.split(s) for f, s in zip(flats, sizes)]
    return pytree.tree_unflatten(
        [parts[g][i].view(shape) for g, i, shape in where], spec)


class _Graph:
    """One key of a :class:`GraphFn`, captured: private copies of the
    call's tensors (the graph's static inputs), the graph, and its outputs
    packed into one flat buffer a dtype in its function's pool.  A seeded
    function's graph holds the generator registered with it and the seed
    it restores before every replay."""

    def __init__(self, leaves):
        self.inputs = [t.detach().clone() for t in leaves]
        groups: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(leaves):
            groups.setdefault(t.dtype, []).append(i)
        self._groups = list(groups.values())
        self.generator = self.seed = None

    def capture(self, stream, run, pool, generator=None, seed=None):
        cap = _counted_capture(stream, lambda: _pack(run(self.inputs)), pool,
                               () if generator is None else (generator,),
                               "compiled function")
        self.graph, (self.flats, self.layout) = cap.graph, cap.out
        self.capture_s, self.nodes, self.kernels = (cap.seconds, cap.nodes,
                                                    cap.kernels)
        self.launches, self.counted = cap.launches, cap.counted
        self.generator, self.seed = generator, seed

    def replay(self, leaves):
        """Copy ``leaves`` in, replay, and return copies of the outputs."""
        with REGISTRY.span("graphs.load"):
            for idx in self._groups:
                torch._foreach_copy_([self.inputs[i] for i in idx],
                                     [leaves[i] for i in idx])
        if self.generator is not None:
            # the draws of the eager call, whose generator is new
            self.generator.manual_seed(self.seed)
        with REGISTRY.span("graphs.replay"):
            self.graph.replay()
        for c, n in self.launches:
            c.add(n)
        return _unpack([f.clone() for f in self.flats], self.layout)


class GraphFn(_GraphCache):
    """``fn`` compiled, as ``jax.jit`` compiles a function:
    ``f(*tensors, **static)``, where the positional arguments are trees of
    tensors and the keyword arguments static values (ints, strings).

    On CPU tensors it is ``fn``, eager (:meth:`eager`).  On the card it
    keeps one captured CUDA graph a key: the trees' structure, the
    tensors' shapes, types and devices, and the static arguments, as
    jit's cache keys a call.  A key's first call runs ``fn`` eagerly on
    the one capture stream (the warm-up: the kernels' libraries load, the
    occupancy queries run and cuBLAS sets up there, since a capture can do
    none of that) and returns that result; then the key is captured from
    private copies of the tensors.  Later calls copy their tensors into
    those copies and replay.  A capture that fails raises: nothing falls
    back to eager on the card.  The function keeps its ``limit`` most
    recently used graphs (``graphs``, least recently used first), all in
    one memory pool (``pool``); ``captures`` and ``capture_s`` count what
    it captured, ``evictions`` the graphs it dropped for room and
    ``replays`` its replays, ``last`` is the graph of its last call (None
    on the host).

    Unlike the serving and train graphs, it is functional and
    thread-safe, as the outlier loop needs:

    * every call returns new tensors: the outputs are copied out of the
      graph's buffers (one copy a dtype) before the call returns, and no
      argument is donated or written to.  Workers that share one state
      without a lock lose updates exactly as the reference's do;
    * one lock covers a call's capture, or its copy-in, replay and
      copy-out, and every call's work waits for the last call's on the
      card, so no replay writes a buffer another call still reads; four
      workers that meet a new key at once capture it once.  Captures of
      all functions take turns on the capture stream.

    With ``seeded``, ``fn(generator, *tensors, **static)`` draws from a
    generator, and the call takes ``seed=`` among its static arguments:
    :meth:`eager` gives ``fn`` a new generator of the tensors' device
    seeded with it, as ``IsolationForest.fit`` does, and on the card the
    function's one generator a device is registered with every graph and
    seeded again before each replay, so that every replay draws what the
    eager call draws, bit for bit.

    A graph holds ``fn`` and nothing of its owner: a model that keeps a
    compiled function of its own is freed with it."""

    def __init__(self, fn, *, limit: int = MAX_GRAPHS, seeded: bool = False):
        super().__init__()
        self.fn = fn
        self.limit = limit
        self.seeded = seeded
        self.pool = None
        self.captures = self.replays = 0
        self.capture_s = 0.0
        self._lock = threading.Lock()
        self._done: Dict[torch.device, "torch.cuda.Event"] = {}
        self._generators: Dict[torch.device, torch.Generator] = {}

    def eager(self, *args, **static):
        """``fn`` op by op on any device, with this function's signature."""
        if not self.seeded:
            return self.fn(*args, **static)
        seed = static.pop("seed")
        dev = pytree.tree_leaves(args)[0].device
        return self.fn(torch.Generator(device=dev).manual_seed(seed), *args,
                       **static)

    def clear(self) -> None:
        """Drop every graph, and with the last one the pool."""
        with self._lock:
            self.graphs.clear()
            self.last = self.pool = None

    def __call__(self, *args, **static):
        leaves, spec = pytree.tree_flatten(args)
        if not leaves or not all(isinstance(t, torch.Tensor)
                                 for t in leaves):
            raise TypeError("a compiled function takes trees of tensors "
                            "as positional arguments, static values by "
                            "keyword")
        dev = leaves[0].device
        if dev.type != "cuda":
            self.last = None
            return self.eager(*args, **static)
        with self._lock:
            cur = torch.cuda.current_stream(dev)
            done = self._done.setdefault(dev, torch.cuda.Event())
            cur.wait_event(done)
            with REGISTRY.span("graphs.lookup"):
                key = (spec, tuple((t.shape, t.dtype, t.device)
                                   for t in leaves),
                       tuple(sorted(static.items())))
                g = self._graph(key)
            if g is not None:
                self.last = g
                out = g.replay(leaves)
                self.replays += 1
            else:
                self.last = None
                out = self._capture(key, dev, args, leaves, spec, static)
                self.last = self.graphs[key]
            done.record(cur)
            return out

    def _capture(self, key, dev, args, leaves, spec, static):
        """The first call of ``key``: the eager warm-up, whose result it
        returns, then the capture."""
        stream = _capture_stream(dev)
        fn, static = self.fn, dict(static)
        with _CAPTURE_LOCK:
            first = _warmed(stream, lambda: self.eager(*args, **static))
            self._make_room()
            if not self.graphs:         # a pool goes with its last graph
                self.pool = torch.cuda.graph_pool_handle()
            g = _Graph(leaves)
            if self.seeded:
                seed = static.pop("seed")
                gen = self._generators.setdefault(
                    dev, torch.Generator(device=dev))
                g.capture(stream, lambda xs: fn(
                    gen, *pytree.tree_unflatten(xs, spec), **static),
                    self.pool, gen, seed)
            else:
                g.capture(stream, lambda xs: fn(
                    *pytree.tree_unflatten(xs, spec), **static), self.pool)
        self.graphs[key] = g
        self.captures += 1
        self.capture_s += g.capture_s
        return first
