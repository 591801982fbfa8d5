"""Train-step factory: loss → grad → (accumulate) → (int8 reduce) → clip →
optimizer, ported from ``repro.train.step``.

* gradient accumulation over microbatches in ``accum_dtype``,
* remat (the model's per-block ``torch.utils.checkpoint``),
* optional int8 gradient compression with error feedback across the ranks
  of a ``torch.distributed`` group (``grad_compression='int8_pod'``, one
  rank a pod; :func:`make_compressed_train_step` splits the batch over
  the group as the reference's ``shard_map`` does over ``'pod'``),
* AdamW / Adafactor per arch config, the reference's formulas,
* the reference's sharding rules (``rules=``, into ``loss_fn``), the
  train state's partition specs (:func:`train_state_pspecs`, the
  reference's stacked tree of tuples) and its meta shapes
  (:func:`train_state_shapes`).

Gradients come from ``torch.autograd.grad`` over leaves detached from the
caller's tensors, so a step never mutates its inputs: it returns new
params and a new state, as the reference's jitted step does.

The reference jits that step (``repro/launch/train.py:57``), its int8
step (``repro/launch/dryrun.py:127``) and its GPipe step (``:245``); their
counterparts here are :func:`make_train_fn`,
:func:`make_compressed_train_fn` and ``pipeline.make_pp_train_fn``, each a
:class:`TrainFn`: one captured CUDA graph a batch shape on the card, which
updates the params and the optimizer state in place, as a jitted step with
donated arguments does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig
from repro_torch.graphs import (_capture_stream, _captured, _spec, _warmed,
                                graph_nodes)
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import (clip_by_global_norm, cosine_schedule,
                               make_optimizer)
from repro_torch.optim.compression import tree_compressed_psum
from repro_torch.optim.optimizers import Optimizer
from repro_torch.spans import REGISTRY


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0
    microbatches: int = 1
    accum_dtype: str = "float32"       # bfloat16 for the >=100B archs
    attn_impl: str = "dense"           # dense | chunked (kernel: no grad)
    attn_chunk: int = 1024
    grad_compression: Optional[str] = None   # None | 'int8_pod'
    moment_dtype: str = "float32"


def _stacked(opt: Optimizer) -> Optimizer:
    """``opt`` over the reference's stacked layout.  Adafactor factors its
    second moment and clips its update's RMS over each whole leaf, and the
    reference's block leaves are (L, ...) stacks; running it per layer
    would factor and clip other tensors.  Its state is kept stacked."""
    def update(grads, state, params, step):
        upd, new = opt.update(convert.stack_blocks(grads), state,
                              convert.stack_blocks(params), step)
        return convert.unstack_blocks(upd, params), new

    return Optimizer(lambda params: opt.init(convert.stack_blocks(params)),
                     update)


def _opt(cfg: ArchConfig, tc: TrainConfig) -> Optimizer:
    lr_fn = cosine_schedule(tc.lr, tc.warmup, tc.total_steps)
    if cfg.optimizer == "adafactor":
        return _stacked(make_optimizer("adafactor", lr_fn))
    return make_optimizer("adamw", lr_fn,
                          moment_dtype=getattr(torch, tc.moment_dtype))


def init_train_state(cfg: ArchConfig, tc: TrainConfig, *,
                     generator: Optional[torch.Generator] = None,
                     seed: int = 0, device=None, dtype=torch.float32):
    """(params, state): random params (:func:`transformer.init_params`)
    and ``{"opt", "step", ["ef"]}`` with the reference's keys, on
    ``device`` (``cuda:0`` unless another is named)."""
    device = T.default_device(device)
    params = T.init_params(cfg, generator=generator, device=device,
                           dtype=dtype, seed=seed)
    return params, init_state(cfg, tc, params)


def init_state(cfg: ArchConfig, tc: TrainConfig, params):
    """The zero train state for ``params`` (the optimizer's zero moments,
    ``step`` 0 and, for int8 compression, zero bf16 error buffers)."""
    device = pytree.tree_leaves(params)[0].device
    state = {"opt": _opt(cfg, tc).init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if tc.grad_compression == "int8_pod":
        state["ef"] = pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                  device=p.device), params)
    return state


def train_state_shapes(cfg: ArchConfig, tc: TrainConfig,
                       dtype=torch.bfloat16):
    """(params, state) as meta tensors, no memory: the counterpart of the
    reference's ``jax.eval_shape`` of ``init_train_state``."""
    return init_train_state(cfg, tc, device="meta", dtype=dtype)


def _factored_spec(spec, ndim, drop_axis):
    parts = list(spec) + [None] * (ndim - len(spec))
    del parts[drop_axis]
    return T.P(*parts)


def _stacked_ndims(tree):
    """Each leaf's ndim in the reference's stacked layout: a list of
    per-layer trees counts one dimension more than its entries."""
    if isinstance(tree, dict):
        return {k: _stacked_ndims(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return convert._map(_stacked_ndims(tree[0]), lambda n: n + 1)
    return tree.ndim


def train_state_pspecs(cfg: ArchConfig, tc: TrainConfig, rules: T.ShardRules,
                       params_tree):
    """(param specs, state specs) in the reference's stacked layout, equal
    to its ``tuple(P)`` leaf for leaf.  ``params_tree`` (port or stacked
    layout, meta tensors welcome) gives Adafactor's factored specs the
    stacked leaves' ranks.  The port's Adafactor state is stacked as
    these specs are; AdamW's ``mu``/``nu`` follow the params' lists, so
    lay the specs over a port state with ``convert.unstack_specs``."""
    pspecs = T.param_pspecs(cfg, rules)
    if cfg.optimizer == "adafactor":
        def per_leaf(ndims, specs):
            if isinstance(ndims, dict):
                return {k: per_leaf(ndims[k], specs[k]) for k in ndims}
            if ndims >= 2:
                return {"vr": _factored_spec(specs, ndims, ndims - 1),
                        "vc": _factored_spec(specs, ndims, ndims - 2)}
            return {"v": specs}
        opt_spec = {"v": per_leaf(_stacked_ndims(params_tree), pspecs)}
    else:
        opt_spec = {"mu": pspecs, "nu": pspecs}
    state_spec = {"opt": opt_spec, "step": T.P()}
    if tc.grad_compression == "int8_pod":
        state_spec["ef"] = pspecs
    return pspecs, state_spec


def batch_pspec(cfg: ArchConfig, rules: T.ShardRules):
    b = rules.batch
    spec = {"tokens": T.P(b, None), "labels": T.P(b, None)}
    if cfg.n_codebooks > 1:
        spec = {"tokens": T.P(b, None, None), "labels": T.P(b, None, None)}
    if cfg.input_mode == "embeddings":
        spec = {"embeds": T.P(b, None, None), "positions": T.P(None, b, None),
                "labels": T.P(b, None)}
    return spec


def _grads(cfg: ArchConfig, tc: TrainConfig, params, batch, rules=None):
    """(grads, metrics) of ``loss_fn`` at ``params`` on ``batch``."""
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = T.loss_fn(pytree.tree_unflatten(leaves, spec), cfg,
                              batch, impl=tc.attn_impl, chunk=tc.attn_chunk,
                              rules=rules)
    with L.dtensor_scope(leaves):      # the backward meets the constants
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return (pytree.tree_unflatten(grads, spec),
            {k: v.detach() for k, v in metrics.items()})


def chunks(v, m: int, dim: int = 0):
    """``torch.chunk(v, m, dim)``.  A ``DTensor`` split on ``dim`` is
    chunked on each rank's own rows (microbatch i takes every rank's
    i-th local chunk), where ``torch.chunk`` would gather the rows
    first; the chunks keep ``v``'s layout."""
    if not L.is_dtensor(v):
        return torch.chunk(v, m, dim=dim)
    from torch.distributed.tensor import Shard
    if Shard(dim) not in v.placements:
        return torch.chunk(v, m, dim=dim)
    shape = list(v.shape)
    shape[dim] //= m
    return tuple(L.from_local(part.contiguous(), v.device_mesh,
                              v.placements, shape)
                 for part in torch.chunk(v.to_local(), m, dim=dim))


def _split(batch, m: int):
    """``m`` microbatches; positions (3,B,S) carry the batch on dim 1."""
    parts = {}
    for k, v in batch.items():
        dim = 1 if k == "positions" else 0
        if v.shape[dim] % m:
            raise ValueError(f"batch {v.shape[dim]} of {k!r} does not "
                             f"split into {m}")
        parts[k] = chunks(v, m, dim=dim)
    return [{k: parts[k][i] for k in batch} for i in range(m)]


def compute_grads(cfg: ArchConfig, tc: TrainConfig, params, batch,
                  rules=None):
    """(grads, metrics), accumulated over ``tc.microbatches`` in
    ``accum_dtype``, averaged and cast to each parameter's type."""
    m = tc.microbatches
    if m == 1:
        return _grads(cfg, tc, params, batch, rules)
    accum = getattr(torch, tc.accum_dtype)
    acc_g = pytree.tree_map(lambda p: torch.zeros_like(p, dtype=accum),
                            params)
    acc_m = None
    for micro in _split(batch, m):
        g, metrics = _grads(cfg, tc, params, micro, rules)
        acc_g = pytree.tree_map(lambda a, x: a + x.to(accum), acc_g, g)
        if acc_m is None:
            acc_m = {k: torch.zeros((), dtype=torch.float32,
                                    device=v.device)
                     for k, v in metrics.items()}
        acc_m = {k: acc_m[k] + metrics[k] / m for k in acc_m}
    g = pytree.tree_map(lambda x, p: (x / m).to(p.dtype), acc_g, params)
    return g, acc_m


def _apply(opt, tc: TrainConfig, params, state, grad_fn, group,
           clip=clip_by_global_norm):
    """The step around ``grad_fn() -> (grads, metrics)``: int8 reduce,
    clip (``clip(grads, max_norm) -> (grads, norm)``), update, add in
    fp32, count the step.  Each gradient tree is referenced here alone,
    so rebinding ``grads`` frees the one before."""
    grads, metrics = grad_fn()
    new_state = dict(state)
    if tc.grad_compression == "int8_pod":
        # one scale a reference leaf: the blocks' scales are taken over
        # each (L, ...) stack, as the reference's are; the per-layer
        # gradients are freed once stacked
        grads = convert.stack_blocks(grads)
        grads, ef = tree_compressed_psum(grads, group,
                                         convert.stack_blocks(state["ef"]))
        grads = pytree.tree_map(lambda g, p: g.to(p.dtype),
                                convert.unstack_blocks(grads, params), params)
        new_state["ef"] = convert.unstack_blocks(ef, params)
    grads, gnorm = clip(grads, tc.grad_clip)
    updates, new_state["opt"] = opt.update(grads, state["opt"], params,
                                           state["step"])
    del grads                          # frees a parameter-sized tree now
    new_params = pytree.tree_map(
        lambda p, u: (p.float() + u.float()).to(p.dtype), params, updates)
    new_state["step"] = state["step"] + 1
    return new_params, new_state, {**metrics, "grad_norm": gnorm}


def make_train_step(cfg: ArchConfig, tc: TrainConfig,
                    rules: Optional[T.ShardRules] = None, group=None):
    """``step(params, state, batch) -> (params, state, metrics)``, the
    model under ``rules``.  With ``grad_compression='int8_pod'`` the
    gradients go through the int8 reduction over ``group`` (None: this
    rank alone, the p = 1 form)."""
    opt = _opt(cfg, tc)

    def train_step(params, state, batch):
        return _apply(opt, tc, params, state,
                      lambda: compute_grads(cfg, tc, params, batch, rules),
                      group)

    return train_step


def _in_place(step, params, state):
    """``run(batch) -> metrics``: ``step(params, state, batch)``, whose
    new params and state are then copied into the leaves of ``params``
    and ``state``.  Those two trees are the only ones that outlive a
    call: the new trees are transients, freed as ``run`` returns."""
    own = pytree.tree_leaves((params, state))

    def run(batch):
        new_params, new_state, metrics = step(params, state, batch)
        torch._foreach_copy_(own, pytree.tree_leaves((new_params,
                                                      new_state)))
        return metrics

    return run


class TrainGraph:
    """One train step captured as a CUDA graph, for one key of its
    :class:`TrainFn` (the batch's names, shapes and types).  It owns a
    static buffer for each batch entry; the params and the optimizer
    state are its function's buffers, which the step reads and then
    overwrites with their new values (:func:`_in_place`); its metrics lie
    in the memory pool that all graphs of its function share.

    Made by the first call of its key, which then calls :meth:`capture`,
    as ``serve.engine.DecodeGraph`` is: the step runs eagerly on the
    static buffers on the one capture stream (the warm-up of cuBLAS, the
    allocator and autograd on that stream, and that call's real step,
    params updated); the blocks the warm-up freed go back to the device,
    since the graph's pool cannot use them (beside the new pool they
    would hold a second step's transients); then the step is captured,
    which executes nothing.  A second warm-up step would advance the
    params twice.  Later calls of the key replay the graph.  A step that
    syncs with the host or does anything else a graph cannot hold raises
    at its capture, after the warm-up's step: nothing falls back to the
    eager step on the card."""

    def __init__(self, batch, run):
        self.batch = {k: v.clone() for k, v in batch.items()}
        self._run = run

    def capture(self, stream: "torch.cuda.Stream", pool):
        """The first step, eagerly on ``stream``, then the capture there.
        Returns the first step's metrics."""
        first = _warmed(stream, lambda: self._run(self.batch))
        torch.cuda.empty_cache()
        self.graph, self.metrics, self.capture_s = _captured(
            stream, lambda: self._run(self.batch), pool)
        with REGISTRY.span("graphs.nodes"):
            self.nodes, self.kernels = graph_nodes(self.graph)
        return first

    def replay(self, batch):
        with REGISTRY.span("graphs.load"):
            for k, v in batch.items():
                if v is not self.batch[k]:
                    self.batch[k].copy_(v)
        with REGISTRY.span("graphs.replay"):
            self.graph.replay()
        return dict(self.metrics)


class TrainFn:
    """A train step compiled, ``step(params, state, batch) -> (params,
    state, metrics)``: :func:`make_train_fn`'s, :func:`make_compressed_
    train_fn`'s and ``pipeline.make_pp_train_fn``'s result.  ``eager`` is
    the step it was made from, which mutates nothing; ``graphs`` maps each
    key to its :class:`TrainGraph`; ``last`` is the graph of the last
    call (None on the host); ``pool`` is the memory pool its graphs
    share; ``captures`` and ``capture_s`` count the graphs it captured
    and the seconds that took; ``params`` and ``state`` are its buffers
    on the card (None before its first call there).  ``refuse``, where
    given, says why this step cannot be captured: a call on the card
    raises it before any launch.  A call is the span ``train.step`` of
    ``repro_torch.spans.REGISTRY``, which holds ``train.load`` (the
    params and state leaves flattened and checked) and the graph's
    spans."""

    def __init__(self, eager, refuse: Optional[str] = None):
        self.eager = eager
        self.refuse = refuse
        self.graphs: Dict[tuple, TrainGraph] = {}
        self.last: Optional[TrainGraph] = None
        self.pool = None
        self.captures = 0
        self.capture_s = 0.0
        self.params = self.state = None
        self._run = None

    def _load(self, params, state) -> None:
        """Make ``(params, state)`` this function's buffers: the first
        tree is adopted as it is, a later one's leaves copied in where
        they are not the buffers themselves."""
        if self._run is None:
            own, spec = pytree.tree_flatten((params, state))
            self.params, self.state = pytree.tree_unflatten(own, spec)
            self._run = _in_place(self.eager, self.params, self.state)
            return
        own, spec = pytree.tree_flatten((self.params, self.state))
        new, new_spec = pytree.tree_flatten((params, state))
        if new_spec != spec:
            raise ValueError("params and state of another structure than "
                             "this function's")
        for o, n in zip(own, new):
            if n is not o:
                if n.shape != o.shape or n.dtype != o.dtype:
                    raise ValueError(f"a leaf of shape {tuple(n.shape)} "
                                     f"{n.dtype} for one of "
                                     f"{tuple(o.shape)} {o.dtype}")
                o.copy_(n)

    def __call__(self, params, state, batch):
        with REGISTRY.span("train.step"):
            return self._step(params, state, batch)

    def _step(self, params, state, batch):
        dev = next(iter(batch.values())).device
        if dev.type != "cuda":
            self.last = None
            return self.eager(params, state, batch)
        if self.refuse:
            raise RuntimeError(self.refuse)
        if any(L.is_dtensor(t) for t in pytree.tree_leaves(
                (params, state, batch))):
            raise TypeError("a train step's CUDA graph takes plain "
                            "tensors: DTensor steps run on meta only (the "
                            "dry-run)")
        with REGISTRY.span("train.load"):
            self._load(params, state)
        with REGISTRY.span("graphs.lookup"):
            key = (dev, _spec(batch))
            g = self.graphs.get(key)
        if g is not None:
            self.last = g
            return self.params, self.state, g.replay(batch)
        self.last = None
        if not self.graphs:             # a pool goes with its last graph
            self.pool = torch.cuda.graph_pool_handle()
        g = TrainGraph(batch, self._run)
        first = g.capture(_capture_stream(dev), self.pool)
        self.graphs[key] = self.last = g
        self.captures += 1
        self.capture_s += g.capture_s
        return self.params, self.state, first


def make_train_fn(cfg: ArchConfig, tc: TrainConfig,
                  rules: Optional[T.ShardRules] = None) -> TrainFn:
    """The counterpart of the reference's jitted train step,
    ``step(params, state, batch) -> (params, state, metrics)``.

    On a CPU batch it is :func:`make_train_step`, eager.  On the card it
    keeps one captured CUDA graph a key (the batch's names, shapes and
    types: tokens and labels, codebooks, or qwen2-vl's embeds with
    positions (3, B, S)), as jit's cache does.  A key's first call runs
    the step eagerly and returns that result, then captures the graph;
    later calls replay it.

    The params and the optimizer state are donated, as with jit's
    ``donate_argnums``: the first call on the card adopts the caller's
    leaves, without a copy, as this function's buffers, and every step
    overwrites them with their new values inside the graph.  Each call
    returns those same trees, and metrics that alias the graph's static
    outputs, which the next call overwrites: read them, or clone them,
    before it.  A call with other leaves (a resumed checkpoint) copies
    them into the buffers; the function keeps no second tree.  A capture
    that cannot be made raises, after the warm-up's step was applied."""
    return TrainFn(make_train_step(cfg, tc, rules))


def make_compressed_train_step(cfg: ArchConfig, tc: TrainConfig, group,
                               rules: Optional[T.ShardRules] = None):
    """int8-compressed data parallelism over the ranks of ``group``, the
    counterpart of the reference's step under ``shard_map`` manual on
    ``'pod'``: params and state are replicated, every rank is given the
    same global batch and takes its own slice of it (positions (3,B,S)
    on dim 1), the gradient reduction is the explicit int8 psum with
    error feedback in ``state['ef']``, and the metrics are averaged over
    the group.  The model runs under ``rules`` with ``'pod'`` taken out
    of the batch axes, as the reference's inner rules are.

    ``DTensor`` parameters and state lie on a mesh one of whose dims has
    ``group`` as its group (the dry-run's ``'pod'``), replicated over it;
    the batch is laid out by the inner rules, so each rank takes its
    slice of its own rows (:func:`chunks`)."""
    if tc.grad_compression != "int8_pod":
        raise ValueError("make_compressed_train_step needs "
                         "grad_compression='int8_pod'")
    opt = _opt(cfg, tc)
    rank = dist.get_rank(group)
    p = dist.get_world_size(group)
    inner = rules and dataclasses.replace(
        rules, batch=tuple(a for a in rules.batch if a != "pod"))

    def pmean(v):
        v = v.clone()                   # "ce" and "loss" share storage
        # a replicated DTensor's local value is reduced in place
        dist.all_reduce(v.to_local() if L.is_dtensor(v) else v, group=group)
        return v / p

    def step_fn(params, state, batch):
        local = _split(batch, p)[rank]
        params, state, metrics = _apply(
            opt, tc, params, state,
            lambda: _grads(cfg, tc, params, local, inner), group)
        return params, state, {k: pmean(v) for k, v in metrics.items()}

    return step_fn


def make_compressed_train_fn(cfg: ArchConfig, tc: TrainConfig, group,
                             rules: Optional[T.ShardRules] = None) -> TrainFn:
    """The counterpart of the reference's jitted int8 step
    (``repro/launch/dryrun.py:127``): :func:`make_compressed_train_step`
    over ``group`` as a :class:`TrainFn`, which works as
    :func:`make_train_fn` does.  On CPU tensors it is the eager step (a
    gloo group).  On the card each batch key is one CUDA graph holding
    the group's collectives (the scales' MAX all-reduce, the metrics'
    mean; with more ranks also the all-to-all and the all-gather of the
    int8 codes): NCCL sets up its communicator at the first collective,
    in a key's eager warm-up.  ``ProcessGroupNCCL`` (torch 2.11) gives a
    collective issued under capture no watchdog work and no flight
    recorder entry, so no event recorded in the capture is ever queried
    and the function needs no setting or explicit wait; a replay runs the
    collectives as kernel nodes.  Free the function's graphs before
    destroying the group.  The params, the optimizer state and the error
    buffers are donated.  ``DTensor`` trees (the dry-run's) run on meta
    only: on the card they raise."""
    return TrainFn(make_compressed_train_step(cfg, tc, group, rules))
