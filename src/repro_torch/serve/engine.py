"""Serving substrate in PyTorch: prefill-with-cache, the decode step and the
batched server — the counterpart of ``repro.serve.engine``.

``prefill_with_cache`` runs the full-sequence forward while capturing the
per-layer caches in exactly the layout ``transformer.init_cache``
allocates (KV heaps, MLA latents, SSM states, sliding-window ring
buffers), so the prefill→decode handoff is consistent with incremental
decoding.

:class:`BatchServer` is the paper's "serve a small model with batched
requests" driver: requests queue up, are bucketed into waves of equal
prompt length, prefilled together, and decoded in lockstep, one token for
every request of the wave each step, greedy over the real vocabulary.

Three routing points differ from the reference, all within what it
offers, and together they put the Hopper kernels on the serving path:

* :class:`BatchServer` passes an ``impl`` to its prefill, ``"kernel"`` by
  default (the reference's ``make_prefill_fn`` takes ``impl``, but its
  server fixes ``"dense"``), so attention runs the flash kernel;
* :func:`_block_prefill` passes ``impl`` on to ``ssm_forward`` (the
  reference leaves the SSM on its ``"jnp"`` scan), so ``"kernel"`` runs
  the SSD chunk kernel.  Both scans compute the same function;
* :class:`BatchServer` passes ``"kernel"`` on to its decode step too, so
  each GQA or hybrid layer's attention core runs the decode attention
  kernel (the same casts as the op-by-op step; only its sums run in
  another order).

On a CPU tensor ``"kernel"`` takes the kernels' plain versions.

The reference compiles its two serving programs with ``jax.jit``
(``repro/serve/engine.py:144`` and ``:152``); their counterparts here
capture CUDA graphs on the card.  :func:`make_prefill_fn` runs the prefill
as one graph a (batch, prompt) shape (:class:`PrefillGraph`), with the
flash and SSD kernels inside it.  The decode step is the reference's
static program: the position is a 0-d tensor on the device, so every step
of every wave of a batch shape runs the same ops on the same shapes, and
:func:`make_decode_fn` runs it as one graph a batch shape
(:class:`DecodeGraph`).  On the host both run eagerly.

The server and both functions record spans into the process-wide
``repro_torch.spans.REGISTRY``: ``serve.wave`` (a wave, its prefill's
graph spans included), and a decode step's ``serve.decode``, with its
children ``serve.decode.inputs``, ``serve.decode.call`` (the
decode function: ``graphs.lookup``, ``graphs.load``, ``graphs.replay``),
``serve.decode.tokens`` (the argmax and the wait for the card) and
``serve.decode.deliver``.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.graphs import (_capture_stream, _counted_capture,
                                _GraphCache, _spec, _warmed,
                                capture_kernel_nodes)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.spans import REGISTRY, NodeTally, tallying


# ---------------------------------------------------------------------------
# prefill with cache capture
# ---------------------------------------------------------------------------


def _ring_scatter(kv, window: int):
    """Last-`window` kv entries, ring-layout (slot = pos % window)."""
    b, s, hkv, hd = kv.shape
    if s <= window:
        pad = torch.zeros((b, window - s, hkv, hd), dtype=kv.dtype,
                          device=kv.device)
        return torch.cat([kv, pad], dim=1)
    tail = kv[:, s - window:]                       # positions s-w .. s-1
    slots = torch.arange(s - window, s, device=kv.device) % window
    out = torch.zeros((b, window, hkv, hd), dtype=kv.dtype, device=kv.device)
    out[:, slots] = tail
    return out


def _pad_seq(x, max_len: int):
    s = x.shape[1]
    if s >= max_len:
        return x[:, :max_len]
    pad = torch.zeros((x.shape[0], max_len - s, *x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=1)


def _pad_cache(kv, size: int, window):
    if window is not None and kv.shape[1] > size:
        return _ring_scatter(kv, size)
    return _pad_seq(kv, size)


def _block_prefill(lp, x, cos, sin, cfg: ArchConfig, max_len: int,
                   cache_dtype, *, layer: int, impl, chunk):
    """block_forward + cache capture, by layer ``layer``'s mixer. Returns
    (x, cache_entry): the entries of the cache that the mixer has."""
    kind = cfg.mixer(layer)
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    entry: Dict[str, Any] = {}
    size = max_len if cfg.sliding_window is None else min(
        max_len, cfg.sliding_window)
    if kind == "gqa":
        a, (k, v) = L.gqa_forward(lp["attn"], h, cos, sin, cfg, impl=impl,
                                  window=cfg.sliding_window, chunk=chunk)
        x = T._residual(x, a, cfg)
        entry["k"] = _pad_cache(k.to(cache_dtype), size, cfg.sliding_window)
        entry["v"] = _pad_cache(v.to(cache_dtype), size, cfg.sliding_window)
    elif kind == "mla":
        a, (ckv, krope) = L.mla_forward(lp["attn"], h, cos, sin, cfg,
                                        impl=impl, chunk=chunk)
        x = x + a
        entry["ckv"] = _pad_seq(ckv.to(cache_dtype), max_len)
        entry["krope"] = _pad_seq(krope.to(cache_dtype), max_len)
    elif kind == "hybrid":
        a, (k, v) = L.gqa_forward(lp["mixer"]["attn"], h, cos, sin, cfg,
                                  impl=impl, window=cfg.sliding_window,
                                  chunk=chunk)
        m, (ssm_state, conv_state) = L.ssm_forward(
            lp["mixer"]["ssm"], h, cfg, return_state=True, impl=impl)
        y = 0.5 * (L.rms_norm(a, lp["mixer"]["attn_norm"], cfg.norm_eps)
                   + L.rms_norm(m, lp["mixer"]["ssm_norm_out"],
                                cfg.norm_eps))
        x = x + y
        entry["k"] = _pad_cache(k.to(cache_dtype), size, cfg.sliding_window)
        entry["v"] = _pad_cache(v.to(cache_dtype), size, cfg.sliding_window)
        entry["ssm"] = ssm_state
        entry["conv"] = conv_state
    else:                                            # the Mamba2 mixer
        y, (ssm_state, conv_state) = L.ssm_forward(
            lp["ssm"], h, cfg, return_state=True, impl=impl)
        x = T._residual(x, y, cfg)
        entry["ssm"] = ssm_state
        entry["conv"] = conv_state
    return T._ffn(lp, x, cfg)[0], entry


def prefill_with_cache(params, cfg: ArchConfig, inputs, max_len: int, *,
                       impl="dense", chunk=1024, cache_dtype=torch.bfloat16):
    """Returns (logits (B,S,V...), cache) — cache layout == init_cache,
    with the SSM and conv states in the activations' type (fp32), as in the
    reference: each entry stacks the layers that have it, in order (under
    a per-layer pattern, each at its ``cfg.state_index``).  ``inputs`` as
    :func:`transformer.forward` takes them (embeds and M-RoPE positions
    for qwen2-vl)."""
    x = T._embed_inputs(params, cfg, inputs)
    cos, sin = T._positions_cos_sin(cfg, inputs, x.shape[1],
                                    T._rope_dim(cfg), x.device)
    entries = []
    for i, lp in enumerate(params["blocks"]):
        x, entry = _block_prefill(lp, x, cos, sin, cfg, max_len, cache_dtype,
                                  layer=i, impl=impl, chunk=chunk)
        entries.append(entry)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = T._logits(params, cfg, x)
    names = dict.fromkeys(name for e in entries for name in e)
    cache = {name: torch.stack([e[name] for e in entries if name in e])
             for name in names}
    return logits, cache


class PrefillGraph:
    """One prefill captured as a CUDA graph, for one key of its
    :class:`PrefillFn` (the params, the inputs' names, shapes and types).
    It owns static buffers for the inputs (tokens, or embeds and M-RoPE
    positions); its outputs, the logits and the cache, lie in the memory
    pool that all graphs of its :class:`PrefillFn` share.

    Made by the first call of its key, which then calls :meth:`capture`,
    as :class:`DecodeGraph` is: the prefill runs eagerly on the static
    inputs on a side stream (the warm-up of cuBLAS, the allocator and the
    kernels' libraries, whose build and load cannot be captured, and that
    call's result); the blocks the warm-up freed in the ordinary pool go
    back to the device, since the graph's pool cannot use them and a
    capture may not free them itself; then the prefill is captured, which
    executes nothing.  Later calls of the key replay the graph.

    A replay runs no Python, so no kernel wrapper counts its launches.
    The capture takes back what the wrappers counted (``counted``: it
    launched nothing), and ``launches`` holds, for each counter with
    ``symbols``, the graph's kernel nodes that run its kernels, read from
    the graph (``graphs._counted_capture``); every replay adds them.  The
    two must agree.  A prefill that syncs with the host or does anything
    else a graph cannot hold raises here: nothing falls back to the eager
    prefill on the card."""

    def __init__(self, params, inputs, run):
        self.params = params            # the graph reads them where they lie
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        self._run = run

    def capture(self, stream: "torch.cuda.Stream", pool):
        """The first prefill, eagerly on ``stream``, then the capture
        there.  Returns the first prefill's (logits, cache)."""
        logits, cache = _warmed(
            stream, lambda: self._run(self.params, self.inputs))
        torch.cuda.empty_cache()
        cap = _counted_capture(
            stream, lambda: self._run(self.params, self.inputs), pool,
            what="prefill graph")
        self.graph, (self.logits, self.cache) = cap.graph, cap.out
        self.capture_s, self.nodes, self.kernels = (cap.seconds, cap.nodes,
                                                    cap.kernels)
        self.launches, self.counted = cap.launches, cap.counted
        return logits, cache

    def replay(self, inputs):
        with REGISTRY.span("graphs.load"):
            for k, v in inputs.items():
                if v is not self.inputs[k]:
                    self.inputs[k].copy_(v)
        with REGISTRY.span("graphs.replay"):
            self.graph.replay()
        for c, n in self.launches:
            c.add(n)
        return self.logits, dict(self.cache)


def _prefill_at(cfg: ArchConfig, max_len: int, impl, chunk, cache_dtype,
                last_only: bool):
    """:func:`prefill_with_cache` at fixed settings, ``run(params,
    inputs)``, with only the last position's logits where ``last_only``.
    A graph keeps it: it holds no reference back to the
    :class:`PrefillFn`, so the function, its graphs and their pool go as
    soon as the last reference to the function does."""
    def run(params, inputs):
        logits, cache = prefill_with_cache(
            params, cfg, inputs, max_len, impl=impl, chunk=chunk,
            cache_dtype=cache_dtype)
        if last_only:                   # a copy, so the (B, S, V) one goes
            logits = logits[:, -1:].clone()
        return logits, cache
    return run


# prefill graphs a function keeps: each holds its outputs
MAX_PREFILL_GRAPHS = 4
# decode graphs a function keeps: each holds its cache
MAX_DECODE_GRAPHS = 4


class _ParamsGraphCache(_GraphCache):
    """A :class:`~repro_torch.graphs._GraphCache` whose graphs each hold
    the params tree they were captured with (their ``params``): the
    function keeps the graphs of one tree only.  The reference's jitted
    functions take the params as an argument and hold none, so a caller
    who drops a tree expects its memory back."""

    def _keep_params(self, params) -> None:
        """Drop the graphs of every params tree but ``params``, so that a
        call with a new tree leaves one tree alive, not two."""
        for key in [k for k, g in self.graphs.items()
                    if g.params is not params]:
            del self.graphs[key]
        if self.last is not None and self.last.params is not params:
            self.last = None


class PrefillFn(_ParamsGraphCache):
    """:func:`make_prefill_fn`'s result, ``prefill(params, inputs) ->
    (logits, cache)``.  ``eager(params, inputs)`` is the prefill run op by
    op at this function's settings; ``graphs`` maps each key to its
    :class:`PrefillGraph`, the least recently used first; ``last`` is the
    graph of the last call (None on the host); ``pool`` is the memory pool
    its graphs share; ``captures`` and ``capture_s`` count the graphs it
    captured and the seconds that took, evicted graphs included;
    ``evictions`` the graphs it dropped for room."""

    limit = MAX_PREFILL_GRAPHS

    def __init__(self, cfg: ArchConfig, max_len: int, *, impl, chunk,
                 cache_dtype, last_only):
        super().__init__()
        self.cfg = cfg
        self.eager = _prefill_at(cfg, max_len, impl, chunk, cache_dtype,
                                 last_only)
        self.pool = None
        self.captures = 0
        self.capture_s = 0.0

    @torch.inference_mode()
    def __call__(self, params, inputs):
        dev = next(iter(inputs.values())).device
        if dev.type != "cuda":
            self.last = None
            return self.eager(params, inputs)
        with REGISTRY.span("graphs.lookup"):
            self._keep_params(params)
            # the graph holds ``params``, so their id stays theirs
            key = (id(params), dev, _spec(inputs))
            g = self._graph(key)
        if g is not None:
            self.last = g
            return g.replay(inputs)
        self.last = None
        self._make_room()
        if not self.graphs:             # a pool goes with its last graph
            self.pool = torch.cuda.graph_pool_handle()
        g = PrefillGraph(params, inputs, self.eager)
        first = g.capture(_capture_stream(dev), self.pool)
        self.graphs[key] = self.last = g
        self.captures += 1
        self.capture_s += g.capture_s
        return first


def make_prefill_fn(cfg: ArchConfig, max_len: int, *, impl="dense",
                    chunk=1024, cache_dtype=torch.bfloat16,
                    last_only: bool = False) -> PrefillFn:
    """The counterpart of the reference's jitted prefill,
    ``prefill(params, inputs) -> (logits, cache)``; with ``last_only``,
    the logits of the last position only, (B, 1, V...).

    On CPU inputs it runs :func:`prefill_with_cache` eagerly (the kernels'
    plain versions).  On the card it keeps one captured CUDA graph a key
    (the params, and the inputs' names, shapes and types: tokens (B, S) or
    (B, S, codebooks), or embeds (B, S, D) with positions (3, B, S)), as
    jit's cache does.  A key's first call runs the prefill eagerly and
    returns that result, then captures the graph; later calls replay it.
    A graph holds its outputs, so the function keeps the
    :data:`MAX_PREFILL_GRAPHS` most recently used and drops the rest; a
    graph holds its params too, so a call with another params tree drops
    the graphs of every tree before it.

    A replay's logits and cache alias the graph's static outputs, which
    the next replay of that key overwrites; all graphs of one function
    share one memory pool, so the replay of any other key may overwrite
    them too.  Prefill graphs replay one at a time, and a caller who keeps
    one result across another call must clone it (:class:`BatchServer`
    hands the cache to the decode graph, which copies a new wave's cache
    into its own).  A capture that cannot be made raises."""
    return PrefillFn(cfg, max_len, impl=impl, chunk=chunk,
                     cache_dtype=cache_dtype, last_only=last_only)


class DecodeGraph:
    """One decode step captured as a CUDA graph, for one key: the params,
    the cache's names, shapes and types, and the inputs'.  It owns static
    buffers for the inputs (tokens, or embeds and M-RoPE positions), the
    position, the cache and the logits.

    Made by the first call of its key, which then calls :meth:`capture`:
    the step runs eagerly on the static buffers on a side stream (the
    warm-up of cuBLAS and the allocator on the capturing stream, and that
    call's real step), then it is captured, which executes nothing; a
    second warm-up step would advance the SSM states twice.  The first
    call's cache becomes the static cache; a later call with another cache
    (a new wave from the prefill) copies it in once.  A step that syncs
    with the host, allocates what a graph cannot, or widens a cache entry
    raises here: nothing falls back to eager decoding on the card.

    As :class:`PrefillGraph`'s, its ``launches`` hold the kernel nodes of
    each counted kernel (``decode_attention`` with ``impl="kernel"``),
    which every replay adds to the kernel's counter.  ``span_nodes`` holds
    the kernel nodes captured inside each of the model's regions
    (``spans.region``: ``mixer.attn``, ``mixer.ssm``, ``moe.route``,
    ``moe.experts``, ``moe.shared``), summed over the layers, read from the
    capturing graph at each region's entry and exit.  Where an expert
    layer counts (``layers.counting`` around the first call), the graph
    adds its routed pairs, at every replay, to the counter installed
    then."""

    def __init__(self, params, cfg: ArchConfig, cache, inputs, impl: str):
        dev = next(iter(cache.values())).device
        self.params = params            # the graph reads them where they lie
        self.cfg = cfg
        self.impl = impl
        self.cache = dict(cache)
        self.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                       for k, v in inputs.items()}
        self._load(cache, inputs)

    def capture(self, stream: "torch.cuda.Stream"):
        """The first step, eagerly on ``stream``, then the capture there.
        Returns the first step's logits."""
        cache = dict(self.cache)
        first, _ = _warmed(stream, lambda: T.decode_step(
            self.params, self.cfg, self.cache, self.inputs, impl=self.impl))
        for name, t in cache.items():
            if self.cache[name] is not t:
                raise RuntimeError(
                    f"the decode step widened cache {name!r} from {t.dtype} "
                    f"to {self.cache[name].dtype}: a captured step needs the "
                    f"cache in the types the prefill gives")
        tally = NodeTally(capture_kernel_nodes())
        with tallying(tally):
            cap = _counted_capture(
                stream, lambda: T.decode_step(self.params, self.cfg,
                                              self.cache, self.inputs,
                                              impl=self.impl),
                what="decode graph")
        self.span_nodes = dict(tally.nodes)
        self.graph, (self.logits, _) = cap.graph, cap.out
        self.capture_s, self.nodes, self.kernels = (cap.seconds, cap.nodes,
                                                    cap.kernels)
        self.launches, self.counted = cap.launches, cap.counted
        return first

    def _load(self, cache, inputs) -> None:
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        for name, t in cache.items():
            if t is not self.cache[name]:
                self.cache[name].copy_(t)

    def replay(self, cache, inputs):
        with REGISTRY.span("graphs.load"):
            self._load(cache, inputs)
        with REGISTRY.span("graphs.replay"):
            self.graph.replay()
        for c, n in self.launches:
            c.add(n)
        return self.logits, self.cache


class DecodeFn(_ParamsGraphCache):
    """:func:`make_decode_fn`'s result, ``decode(params, cache, inputs) ->
    (logits, cache)``.  ``graphs`` maps each key to its
    :class:`DecodeGraph`, the least recently used first; ``last`` is the
    graph of the last call (None on the host); ``captures`` and
    ``capture_s`` count the graphs it captured and the seconds that took,
    evicted graphs included; ``evictions`` the graphs it dropped for
    room; ``impl`` the step's ``transformer.decode_step`` impl."""

    limit = MAX_DECODE_GRAPHS

    def __init__(self, cfg: ArchConfig, impl: str = "dense"):
        super().__init__()
        if impl not in T.DECODE_IMPLS:
            raise ValueError(f"impl must be one of {T.DECODE_IMPLS}, got "
                             f"{impl!r}")
        self.cfg = cfg
        self.impl = impl
        self.captures = 0
        self.capture_s = 0.0

    @torch.inference_mode()
    def __call__(self, params, cache, inputs):
        dev = next(iter(cache.values())).device
        if dev.type != "cuda":
            self.last = None
            return T.decode_step(params, self.cfg, cache, inputs,
                                 impl=self.impl)
        inputs = {k: torch.as_tensor(v) for k, v in inputs.items()}
        with REGISTRY.span("graphs.lookup"):
            self._keep_params(params)
            # the graph holds ``params``, so their id stays theirs
            key = (id(params), _spec(cache), _spec(inputs))
            g = self._graph(key)
        if g is None:
            self.last = None
            self._make_room()
            g = DecodeGraph(params, self.cfg, cache, inputs, self.impl)
            first = g.capture(_capture_stream(dev))
            self.graphs[key] = self.last = g
            self.captures += 1
            self.capture_s += g.capture_s
            return first, g.cache
        self.last = g
        return g.replay(cache, inputs)


def make_decode_fn(cfg: ArchConfig, impl: str = "dense") -> DecodeFn:
    """The counterpart of the reference's jitted decode,
    ``decode(params, cache, inputs) -> (logits, cache)``, running
    :func:`transformer.decode_step` at ``impl`` (``"kernel"``: the fused
    decode attention in each GQA or hybrid layer).

    On a CPU cache it runs :func:`transformer.decode_step` eagerly (the
    plain version).  On the card it keeps one captured CUDA graph a key
    (batch shape, cache shapes and types, input shapes), as jit's cache
    does, and replays it: ``inputs["length"]`` is best a 0-d tensor on
    the device, as the reference's server passes it.  It keeps the
    :data:`MAX_DECODE_GRAPHS` most recently used graphs, of the last
    params tree it was called with only.  The returned cache
    is the graph's static cache: pass it back on the next step.  The
    returned logits alias the graph's static output buffer, which the
    next step overwrites: a caller who keeps them across steps must clone
    them.  A capture that cannot be made raises."""
    return DecodeFn(cfg, impl)


# ---------------------------------------------------------------------------
# batched serving
# ---------------------------------------------------------------------------


@dataclass
class Request:
    request_id: str
    prompt: np.ndarray                      # (S,) int32 token ids
    max_new_tokens: int = 32
    temperature: float = 0.0
    result_tokens: List[int] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    t_submit: float = field(default_factory=time.monotonic)
    t_wave: Optional[float] = None          # taken into a wave
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None


class BatchServer:
    """Slot-based batched decoder (waves of equal prompt length decode in
    lockstep), on ``cuda:0`` unless ``device`` names another device.
    Decoding is greedy (the reference's server ignores
    ``Request.temperature`` too).

    ``impl`` picks the prefill's attention and SSD scan and the decode
    step's attention core (``"kernel"`` by default: the Hopper kernels on
    the card; decode has no ``"chunked"`` form and runs ``"dense"`` for
    it).  The prefill goes through
    ``prefill_fn``, a :func:`make_prefill_fn` that returns the last
    position's logits only, and the decode step through
    :func:`make_decode_fn` with the position as a device scalar, as the
    reference's server jits both: on the card, one CUDA graph a (batch,
    prompt) shape for the prefill, with the kernels inside it (the
    :data:`MAX_PREFILL_GRAPHS` most recently used kept), and one a batch
    shape for the decode step.  ``waves`` records, for each wave, its
    start (``time.monotonic``), batch, prompt length, the seconds from
    the prefill call to the first tokens on the host, the seconds of each
    decode step (each ends when its tokens reach the host), and on the
    card, for the prefill (``prefill_*``) and the decode step
    (``graph_*``), the seconds this wave spent capturing graphs (0.0
    where it replayed ones made before) and the last graph's nodes and
    kernel nodes (None on the host), and the decode graph's kernel nodes
    by region (``graph_span_nodes``, :class:`DecodeGraph`).  With an
    expert layer, a wave that ran to its end also records its decode
    steps' (token, held expert) pairs routed (``moe_routed``, counted on
    the device and read once, as the wave ends).  Each request is stamped
    when its
    wave takes it (``Request.t_wave``), so its time to the first token
    splits into its wait in the queue (``t_wave - t_submit``) and its
    wave's prefill (``t_first_token - t_wave``).  The server, its prefill
    and its decode function record their spans into the process-wide
    ``repro_torch.spans.REGISTRY``."""

    def __init__(self, params, cfg: ArchConfig, *, n_slots: int = 4,
                 max_len: int = 512, impl: str = "kernel", device=None):
        if impl not in L.IMPLS:
            raise ValueError(f"impl must be one of {L.IMPLS}, got {impl!r}")
        self.device = T.default_device(device)
        if params["ln_f"].device != self.device:
            raise ValueError(f"params lie on {params['ln_f'].device}, the "
                             f"server runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.impl = impl
        self.prefill_fn = make_prefill_fn(cfg, max_len, impl=impl,
                                          last_only=True)
        # decode has no chunked form: "chunked" decodes op by op
        self.decode_fn = make_decode_fn(
            cfg, "kernel" if impl == "kernel" else "dense")
        self._decode = self.decode_fn
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self.metrics: Dict[str, float] = {"decoded_tokens": 0,
                                          "completed": 0}
        self.waves: List[Dict[str, Any]] = []
        # the expert layers' routed pairs over the decode steps, and what
        # the last wave's end read of them
        self.moe_routed = None if cfg.moe is None else torch.zeros(
            (), dtype=torch.int64, device=self.device)
        self._moe_read = 0

    def submit(self, req: Request) -> Request:
        self._queue.put(req)
        return req

    def run(self, *, max_requests: Optional[int] = None,
            idle_timeout_s: float = 2.0) -> List[Request]:
        """Serve until the queue stays empty for ``idle_timeout_s`` (or
        ``max_requests`` completed). One request per slot wave; waves of up
        to n_slots requests decode in lockstep."""
        completed: List[Request] = []
        pending: List[Request] = []
        while True:
            deadline = time.monotonic() + idle_timeout_s
            while len(pending) < self.n_slots and time.monotonic() < deadline:
                try:
                    pending.append(self._queue.get(timeout=0.05))
                except queue.Empty:
                    if pending:
                        break
            if not pending:
                return completed
            # waves are bucketed by exact prompt length: a shared static
            # prefill shape with left-padding would corrupt RoPE positions
            # and causal masks for the shorter prompts.
            plen = len(pending[0].prompt)
            wave = [r for r in pending if len(r.prompt) == plen][
                :self.n_slots]
            pending = [r for r in pending if r not in wave]
            self._serve_wave(wave)
            completed.extend(wave)
            self.metrics["completed"] += len(wave)
            if max_requests and len(completed) >= max_requests:
                return completed

    def _argmax(self, last) -> np.ndarray:
        return torch.argmax(last[..., :self.cfg.vocab_size], dim=-1).to(
            torch.int32).cpu().numpy()

    def _serve_wave(self, wave: List[Request]) -> None:
        with REGISTRY.span("serve.wave"):
            self._wave(wave)

    def _wave(self, wave: List[Request]) -> None:
        cfg, span = self.cfg, REGISTRY.span
        if cfg.input_mode == "embeddings":
            # as the reference's server: requests carry token prompts
            raise NotImplementedError("vlm serving uses embedding frontend")
        start = time.monotonic()
        for r in wave:
            r.t_wave = start
        s_max = len(wave[0].prompt)                   # bucketed: equal lens
        b = len(wave)
        toks = np.zeros((b, s_max), np.int64)
        for i, r in enumerate(wave):
            toks[i, :] = r.prompt
        if cfg.n_codebooks > 1:
            toks = np.repeat(toks[..., None], cfg.n_codebooks, axis=-1)
        inputs = {"tokens": torch.from_numpy(toks).to(self.device)}
        prefill, decode = self.prefill_fn, self.decode_fn
        spent, decode_spent = prefill.capture_s, decode.capture_s
        t0 = time.monotonic()
        logits, cache = prefill(self.params, inputs)
        last = logits[:, -1] if cfg.n_codebooks == 1 else logits[:, -1, 0]
        next_tok = self._argmax(last)                 # waits for the card
        now = time.monotonic()
        stats = {"start": start, "batch": b, "prompt_len": s_max,
                 "prefill_s": now - t0,
                 "prefill_capture_s": None, "prefill_nodes": None,
                 "prefill_kernels": None,
                 "decode_s": [], "graph_capture_s": None,
                 "graph_nodes": None, "graph_kernels": None}
        g = prefill.last
        if g is not None:
            stats["prefill_capture_s"] = prefill.capture_s - spent
            stats["prefill_nodes"], stats["prefill_kernels"] = (g.nodes,
                                                                g.kernels)
        self.waves.append(stats)
        del logits, last
        for i, r in enumerate(wave):
            r.t_first_token = now
            r.result_tokens.append(int(next_tok[i]))
        length = s_max
        n_steps = max(r.max_new_tokens for r in wave)
        for _ in range(n_steps - 1):
            if length >= self.max_len and cfg.attn_kind != "none" and \
                    cfg.sliding_window is None:
                # torch raises where dynamic_update_slice clamps; under a
                # graph that is a device assert, so check here
                raise ValueError(f"position {length} past max_len "
                                 f"{self.max_len}")
            with span("serve.decode"):
                with span("serve.decode.inputs"):
                    t = next_tok[:, None].astype(np.int64)
                    if cfg.n_codebooks > 1:
                        t = np.repeat(t[..., None], cfg.n_codebooks, axis=-1)
                    t0 = time.monotonic()
                    dinp = {"tokens": torch.from_numpy(t).to(self.device),
                            "length": torch.tensor(length, dtype=torch.int32,
                                                   device=self.device)}
                with span("serve.decode.call"), L.counting(self.moe_routed):
                    logits, cache = self._decode(self.params, cache, dinp)
                with span("serve.decode.tokens"):
                    lg = logits[:, 0] if cfg.n_codebooks == 1 else \
                        logits[:, 0, 0]
                    next_tok = self._argmax(lg)
                stats["decode_s"].append(time.monotonic() - t0)
                self.metrics["decoded_tokens"] += b
                length += 1
                with span("serve.decode.deliver"):
                    for i, r in enumerate(wave):
                        if len(r.result_tokens) < r.max_new_tokens:
                            r.result_tokens.append(int(next_tok[i]))
        g = decode.last
        if g is not None and n_steps > 1:
            stats["graph_capture_s"] = decode.capture_s - decode_spent
            stats["graph_nodes"], stats["graph_kernels"] = g.nodes, g.kernels
            stats["graph_span_nodes"] = dict(g.span_nodes)
        if self.moe_routed is not None:
            read = int(self.moe_routed)
            stats["moe_routed"] = read - self._moe_read
            self._moe_read = read
        now = time.monotonic()
        for r in wave:
            r.t_done = now
            r.done.set()
