"""Pipeline parallelism (GPipe), ported from ``repro.train.pipeline``.

The layers split contiguously into ``n_stages`` stages and the global
batch into ``microbatches``.  The schedule runs T = M + S − 1 ticks, and
stage s runs microbatch t − s at tick t; on S devices the bubble is
(S − 1)/T.  Stage 0 embeds, the last stage computes the loss, and each
stage recomputes its blocks in the backward pass (``torch.utils.
checkpoint`` per block, as the reference's ``_stage_forward`` does).

Two forms share the schedule and differ in the hop that carries a
microbatch's activations from one stage to the next:

* **Stages in one process** (``group=None``): the hop is a hand-off, so
  one autograd graph spans the stages and its backward is the reverse
  pipeline.  Params and state are the plain step's
  (``init_pp_state(stage=None)`` is ``init_train_state``): ``blocks``
  lists all L layers and stage s runs layers [s·L/S, (s+1)·L/S).
* **One stage a rank** (``group`` of S ranks, rank r running stage r):
  ``params["blocks"]`` lists that stage's layers (``init_pp_state(
  stage=r)``), and the hop is ``dist.send``/``recv`` inside an
  ``autograd.Function`` whose backward is the reverse hop.  Every rank
  holds replicas of ``embed``/``ln_f``/``head`` (the leaves
  :func:`_opt_specs` marks replicated), whose gradients are summed over
  the ranks, as the reference's psum does (``pipeline.py:146-149``): a
  tied ``embed`` (mamba2-130m) takes its gradient from both end stages.

The reference jits its step (``repro/launch/dryrun.py:245``); the
counterpart here is :func:`make_pp_train_fn`, one CUDA graph a batch shape
on the card for the stages in one process (``train.step.TrainFn``).

Against the reference (ROADMAP C5, C6):

* C5, not reproduced: the gradient norm reported and clipped is the
  whole model's, as in the plain step.  The reference's is S times a
  stage-local norm: under ``shard_map(check_vma=False)`` the transpose of
  the loss's psum is a psum again, which scales every gradient by S, and
  its ``clip_by_global_norm`` sees one stage's blocks and the replicated
  leaves.  AdamW divides the scale out, so losses and params agree.
* C6, reproduced: the loss is the cross entropy alone.  The reference's
  ``_stage_forward`` drops each block's aux, so an MoE arch's
  ``lb_loss``/``z_loss`` do not reach the pipeline's loss.
* Adafactor factors and RMS-clips each stacked leaf a process holds:
  the whole (L, …) stack in one process, as the plain step does; one
  stage's (L/S, …) on a rank, as the reference does under ``shard_map``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import step as TS


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_stages: int = 2
    microbatches: int = 4
    stage_axis: str = "pod"


def _stage_forward(blocks, first: int, x, cos, sin, cfg: ArchConfig,
                   rules):
    """This stage's contiguous slice of layers, from layer ``first``, each
    recomputed in the backward; the blocks' aux (MoE router losses) is
    dropped (C6)."""
    for i, lp in enumerate(blocks, first):
        x, _ = checkpoint(T.block_forward, lp, x, cos, sin, cfg, layer=i,
                          impl="dense", chunk=1024, rules=rules,
                          use_reentrant=False, preserve_rng_state=False)
    return x


class _Handoff:
    """The hop between stages in one process.  Every activation sent is
    received at the next tick, so the wire is empty when the loss is
    taken: nothing of a captured step is held outside its graph."""

    def __init__(self):
        self._wire = {}

    def send(self, y, stage: int, m: int) -> None:
        self._wire[stage + 1, m] = y

    def recv(self, stage: int, m: int, shape, dtype):
        return self._wire.pop((stage, m))

    def loss(self, total, n_tokens: int):
        if self._wire:
            raise RuntimeError(f"activations {sorted(self._wire)} were "
                               f"sent and never received")
        return total / n_tokens


def _local(t):
    """A ``DTensor``'s local shard (a view: in-place collectives write
    through), a plain tensor itself."""
    return t.to_local() if L.is_dtensor(t) else t


def _like(local, like):
    """``local`` as a ``DTensor`` laid out as ``like`` = (mesh,
    placements, global shape), or itself when ``like`` is None."""
    return local if like is None else L.from_local(local, *like)


def _empty(shape, dtype, device, like):
    """A receive buffer of ``shape``: one rank's shard of it when the
    hop carries ``DTensor``s laid out as ``like``."""
    if like is not None:
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        shape, _ = compute_local_shape_and_global_offset(shape, like[0],
                                                         like[1])
    return torch.empty(shape, dtype=dtype, device=device)


class _Send(torch.autograd.Function):
    """Forward: send ``y`` to ``peer``; backward: receive its gradient.
    A ``DTensor`` hop sends each rank's shard to its peer's."""

    @staticmethod
    def forward(ctx, y, peer, group, tag):
        ctx.peer, ctx.group, ctx.tag = peer, group, tag
        ctx.shape, ctx.dtype, ctx.device = y.shape, y.dtype, y.device
        ctx.like = ((y.device_mesh, y.placements, tuple(y.shape))
                    if L.is_dtensor(y) else None)
        dist.send(_local(y).contiguous(), peer, group=group, tag=tag)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        g = _empty(ctx.shape, ctx.dtype, ctx.device, ctx.like)
        dist.recv(g, ctx.peer, group=ctx.group, tag=ctx.tag)
        return _like(g, ctx.like), None, None, None


class _Recv(torch.autograd.Function):
    """Forward: receive from ``peer``; backward: send the gradient back.
    ``anchor`` (a scalar that needs a gradient) puts the hop in the
    graph, so the backward pass reaches it."""

    @staticmethod
    def forward(ctx, anchor, peer, group, tag, shape, dtype, like):
        ctx.peer, ctx.group, ctx.tag = peer, group, tag
        x = _empty(shape, dtype, anchor.device, like)
        dist.recv(x, peer, group=group, tag=tag)
        return _like(x, like)

    @staticmethod
    def backward(ctx, g):
        dist.send(_local(g).contiguous(), ctx.peer, group=ctx.group,
                  tag=ctx.tag)
        return None, None, None, None, None, None, None


class _Wire:
    """The hop between stage ranks.  A rank's backward visits its hops
    last microbatch first (autograd runs the most recent node first), on
    every rank alike, so the blocking sends and receives pair up; the
    microbatch is also the tag."""

    def __init__(self, group, device, like=None):
        self.group = group
        self.anchor = torch.zeros((), device=device, requires_grad=True)
        self.sent = []
        self.like = like         # the activations' DTensor layout, if any

    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def send(self, y, stage: int, m: int) -> None:
        self.sent.append(_Send.apply(y, self._peer(stage + 1), self.group,
                                     m))

    def recv(self, stage: int, m: int, shape, dtype):
        return _Recv.apply(self.anchor, self._peer(stage - 1), self.group,
                           m, shape, dtype,
                           self.like and (*self.like, tuple(shape)))

    def loss(self, total, n_tokens: int):
        """The global loss on every rank, differentiating as this rank's
        part of it (the last stage's cross entropy, the other stages'
        sends)."""
        value = total.detach().clone()
        dist.all_reduce(_local(value), group=self.group)
        own = total / n_tokens + sum(self.sent)
        return own + (value / n_tokens - own).detach()


def make_pp_loss_fn(cfg: ArchConfig, pc: PipelineConfig,
                    rules: Optional[T.ShardRules] = None, group=None):
    """``loss(params, batch)``: the mean next-token cross entropy of the
    batch through the GPipe schedule, run by this process's stages (all
    of them when ``group`` is None; rank r's stage r otherwise).  Token
    inputs only, as in the reference."""
    if cfg.input_mode != "tokens":
        raise ValueError("the pipeline takes token inputs")
    S, M = pc.n_stages, pc.microbatches
    per = cfg.n_layers // S
    stages = range(S) if group is None else [dist.get_rank(group)]

    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        if tokens.shape[0] % M:
            raise ValueError(f"batch {tokens.shape[0]} does not split "
                             f"into {M} microbatches")
        tok_m, lab_m = TS.chunks(tokens, M), TS.chunks(labels, M)
        seq = tokens.shape[1]
        shape = (tokens.shape[0] // M, seq, cfg.d_model)
        cos, sin = T._positions_cos_sin(cfg, batch, seq, T._rope_dim(cfg),
                                        tokens.device)
        like = None
        if L.is_dtensor(params["ln_f"]):
            from repro_torch.launch.mesh import placements
            mesh = params["ln_f"].device_mesh
            like = (mesh, placements(T.P(*T._act_spec(rules)), mesh))
        hop = (_Handoff() if group is None
               else _Wire(group, tokens.device, like))
        total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for t in range(M + S - 1):
            for s in stages:
                m = t - s                 # the microbatch at this stage
                if not 0 <= m < M:
                    continue
                x = (T._embed_inputs(params, cfg, {"tokens": tok_m[m]})
                     if s == 0 else
                     hop.recv(s, m, shape, params["ln_f"].dtype))
                blocks = (params["blocks"][s * per:(s + 1) * per]
                          if group is None else params["blocks"])
                y = _stage_forward(blocks, s * per, x, cos, sin, cfg,
                                   rules)
                if s == S - 1:
                    h = L.rms_norm(y, params["ln_f"], cfg.norm_eps)
                    logits = T._logits(params, cfg, h, rules)
                    total = total + T.token_ce(logits, lab_m[m], cfg).sum()
                else:
                    hop.send(y, s, m)
        return hop.loss(total, labels.numel())

    return loss_fn


def _reduce_and_clip(pc: PipelineConfig, group):
    """``clip(grads, max_norm)`` for ``TS._apply``: the replicated
    leaves' gradients summed over the stage ranks, then clipped by the
    whole model's norm (the stage-local blocks' squares summed over the
    ranks) — the plain step's norm, not the reference's (C5)."""
    def clip(grads, max_norm):
        dev = grads["ln_f"].device
        local = torch.zeros((), dtype=torch.float32, device=dev)
        shared = torch.zeros((), dtype=torch.float32, device=dev)
        for g, spec in convert.leaves_with_specs(grads,
                                                 _opt_specs(grads, pc)):
            if spec == T.P() and group is not None:
                dist.all_reduce(_local(g), group=group)
            sq = torch.sum(torch.square(g.float()))
            if spec == T.P():
                shared = shared + sq
            else:
                local = local + sq
        if group is not None:
            dist.all_reduce(_local(local), group=group)
        gnorm = torch.sqrt(local + shared)
        scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        return {k: pytree.tree_map(
            lambda g: (g.float() * scale).to(g.dtype), v)
            for k, v in grads.items()}, gnorm
    return clip


def make_pp_train_step(cfg: ArchConfig, tc: TS.TrainConfig,
                       pc: PipelineConfig,
                       rules: Optional[T.ShardRules] = None, group=None):
    """``step(params, state, batch) -> (params, state, metrics)`` through
    the GPipe schedule: loss → grad → sum of the replicated leaves' grads
    over the stage ranks → clip by the whole model's norm → optimizer.
    The model runs under ``rules`` with the stage axis taken out of the
    batch axes, as the reference's inner rules are.  Metrics: ``loss``
    and ``grad_norm``."""
    if cfg.n_layers % pc.n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into "
                         f"{pc.n_stages} stages")
    if group is not None and dist.get_world_size(group) != pc.n_stages:
        raise ValueError(f"a group of {dist.get_world_size(group)} ranks "
                         f"for {pc.n_stages} stages")
    opt = TS._opt(cfg, tc)
    inner = rules and dataclasses.replace(
        rules, batch=tuple(a for a in rules.batch if a != pc.stage_axis))
    loss_fn = make_pp_loss_fn(cfg, pc, inner, group)
    clip = _reduce_and_clip(pc, group)

    def grads(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        with L.dtensor_scope(leaves):
            loss = loss_fn(pytree.tree_unflatten(leaves, spec), batch)
            loss.backward()
        g = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
        return (pytree.tree_unflatten(g, spec),
                {"loss": loss.detach()})

    def step_fn(params, state, batch):
        return TS._apply(opt, tc, params, state,
                         lambda: grads(params, batch), None, clip)

    return step_fn


def make_pp_train_fn(cfg: ArchConfig, tc: TS.TrainConfig,
                     pc: PipelineConfig,
                     rules: Optional[T.ShardRules] = None,
                     group=None) -> TS.TrainFn:
    """The counterpart of the reference's jitted GPipe step:
    :func:`make_pp_train_step` as a ``train.step.TrainFn``, which works
    as ``make_train_fn`` does.  On CPU tensors it is the eager step (a
    gloo group's too).  On the card, with the stages in one process
    (``group`` None), it keeps one CUDA graph a batch shape, the params
    and the optimizer state donated and updated in place inside it; the
    recomputation of each block in the backward is captured with the rest.
    A group of more than one rank raises on the card before any launch:
    one card holds one NCCL rank, so its hops cannot be captured there
    (ROADMAP A9.5)."""
    step = make_pp_train_step(cfg, tc, pc, rules, group)
    refuse = None
    if group is not None and dist.get_world_size(group) > 1:
        refuse = (f"the GPipe step over {dist.get_world_size(group)} "
                  f"ranks is not captured on the card: one card holds one "
                  f"NCCL rank (ROADMAP A9.5); run it on the host")
    return TS.TrainFn(step, refuse)


def _opt_specs(opt_state, pc: PipelineConfig):
    """Specs of a tree shaped like the params (the optimizer state, the
    gradients): anything under a 'blocks' key is stage-sharded, the rest
    replicated."""
    def rec(tree, under_blocks=False):
        if isinstance(tree, dict):
            return {k: rec(v, under_blocks or k == "blocks")
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [rec(v, under_blocks) for v in tree]
        return T.P(pc.stage_axis) if under_blocks else T.P()
    return rec(opt_state)


def init_pp_state(cfg: ArchConfig, tc: TS.TrainConfig, pc: PipelineConfig,
                  *, stage: Optional[int] = None, seed: int = 0,
                  generator: Optional[torch.Generator] = None, device=None,
                  dtype=torch.float32):
    """(params, state) from a seed, on ``cuda:0`` unless ``device`` names
    another: the whole model (``stage=None``, the one-process form; the
    plain step's init), or stage ``stage``'s layers with the replicated
    leaves (one stage a rank; every rank draws the same model)."""
    if cfg.n_layers % pc.n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into "
                         f"{pc.n_stages} stages")
    params = T.init_params(cfg, generator=generator, device=device,
                           dtype=dtype, seed=seed)
    if stage is not None:
        per = cfg.n_layers // pc.n_stages
        params["blocks"] = params["blocks"][stage * per:(stage + 1) * per]
    state = {"opt": TS._opt(cfg, tc).init(params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=params["ln_f"].device)}
    return params, state
