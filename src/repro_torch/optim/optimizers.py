"""Optimizers over pytrees of tensors, ported from
``repro.optim.optimizers`` formula for formula (not ``torch.optim``).

* AdamW — fp32 or bf16 moments (``moment_dtype``); ``b2`` defaults to
  0.95, bias correction is taken at ``step + 1``, ``eps`` is added after
  ``sqrt(nu / bc2)`` and ``weight_decay · p`` is added to the update.
* Adafactor — factored second moment, no first moment, RMS update
  clipping (Shazeer & Stern 2018).

Each optimizer is an ``(init, update)`` pair over arbitrary pytrees
(:mod:`torch.utils._pytree`): ``update(grads, state, params, step)``
returns ``(updates, new_state)`` and the caller adds the updates to the
params.  ``step`` may be a Python int or a 0-d tensor (the auto-encoder
keeps it on its device, so no step reads back to the host).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree


class Optimizer(NamedTuple):
    init: Callable       # params -> opt_state
    update: Callable     # (grads, opt_state, params, step) -> (updates, new_state)


def _stepf(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    def lr(step):
        step = _stepf(step)
        warm = base_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def clip_by_global_norm(grads, max_norm: float):
    leaves = pytree.tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return pytree.tree_map(lambda g: (g.float() * scale).to(g.dtype),
                           grads), gnorm


def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          moment_dtype=torch.float32) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                      device=p.device)
        return {"mu": pytree.tree_map(zeros, params),
                "nu": pytree.tree_map(zeros, params)}

    def update(grads, state, params, step):
        stepf = _stepf(step)
        lr = lr_fn(step)
        bc1 = 1 - b1 ** (stepf + 1)
        bc2 = 1 - b2 ** (stepf + 1)

        def upd(g, mu, nu, p):
            g32 = g.float()
            mu32 = b1 * mu.float() + (1 - b1) * g32
            nu32 = b2 * nu.float() + (1 - b2) * g32 * g32
            u = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + eps)
            u = u + weight_decay * p.float()
            return ((-lr * u).to(p.dtype), mu32.to(moment_dtype),
                    nu32.to(moment_dtype))

        out = pytree.tree_map(upd, grads, state["mu"], state["nu"], params)
        is_out = lambda x: isinstance(x, tuple) and len(x) == 3 and \
            isinstance(x[0], torch.Tensor)
        pick = lambda i: pytree.tree_map(lambda o: o[i], out,
                                         is_leaf=is_out)
        return pick(0), {"mu": pick(1), "nu": pick(2)}

    return Optimizer(init, update)


def adafactor(lr_fn, eps=1e-30, clip_threshold=1.0, decay_pow=0.8,
              weight_decay=0.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018), beta1=0."""

    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def per_leaf(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
        return {"v": pytree.tree_map(per_leaf, params)}

    def update(grads, state, params, step):
        stepf = _stepf(step)
        lr = lr_fn(step)
        beta2 = 1.0 - (stepf + 1) ** (-decay_pow)

        def upd(g, v, p):
            g32 = g.float()
            g2 = g32 * g32 + eps
            if _factored(p.shape):
                vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(-1)
                vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(-2)
                denom = (vr / torch.clamp(vr.mean(-1, keepdim=True),
                                          min=eps))[..., None] \
                    * vc[..., None, :]
                u = g32 * torch.rsqrt(denom + eps)
                nv = {"vr": vr, "vc": vc}
            else:
                nv_ = beta2 * v["v"] + (1 - beta2) * g2
                u = g32 * torch.rsqrt(nv_ + eps)
                nv = {"v": nv_}
            # update clipping (RMS)
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr * u).to(p.dtype), nv

        flat, spec = pytree.tree_flatten(params)
        gflat = spec.flatten_up_to(grads)
        vflat = spec.flatten_up_to(state["v"])
        out = [upd(g, v, p) for g, v, p in zip(gflat, vflat, flat)]
        updates = pytree.tree_unflatten([o[0] for o in out], spec)
        nv = pytree.tree_unflatten([o[1] for o in out], spec)
        return updates, {"v": nv}

    return Optimizer(init, update)


def make_optimizer(name: str, lr_fn, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr_fn, **kw)
    if name == "adafactor":
        return adafactor(lr_fn, **kw)
    raise ValueError(name)
