"""The plain reference of a training step: the mean next-token cross
entropy, its gradient by autograd over blocks of rows, clipping by the
global norm, and AdamW with a warm-up and cosine learning rate, all in
float32 PyTorch operations, over the loss of a configuration's reference
module (its ``token_loss``), which the caller hands in.  It imports
nothing of the program under test.

AdamW as the configuration's ``train`` entry states it: the moments start
at zero, the bias corrections are taken at ``step + 1``, ``eps`` is added
after ``sqrt(nu / bc2)``, and ``weight_decay · p`` is added to the update
of every weight.  The learning rate at step t (from 0) is ``lr · (t + 1) /
warmup`` while t < warmup, then a cosine from ``lr`` down to ``lr ·
min_ratio`` at ``total_steps``.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def learning_rate(opt, step: int) -> float:
    if step < opt["warmup"]:
        return opt["lr"] * min((step + 1) / max(opt["warmup"], 1), 1.0)
    prog = min(max((step - opt["warmup"])
                   / max(opt["total_steps"] - opt["warmup"], 1), 0.0), 1.0)
    ratio = opt["min_ratio"]
    return opt["lr"] * (ratio + (1 - ratio) * 0.5
                        * (1 + math.cos(math.pi * prog)))


def _leaves(tree, prefix=()):
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [x for k, v in items for x in _leaves(v, prefix + (k,))]


def _tree(tree, values, prefix=()):
    if isinstance(tree, torch.Tensor):
        return values[prefix]
    if isinstance(tree, dict):
        return {k: _tree(v, values, prefix + (k,)) for k, v in tree.items()}
    return [_tree(v, values, prefix + (i,)) for i, v in enumerate(tree)]


def steps(model, params, cfg, batches, opt, rows_at_once: int = 1) -> Dict:
    """AdamW steps of the loss of ``model`` (the configuration's reference
    module) from ``params`` (left as they are), one a batch of
    ``batches`` ({"tokens", "labels"} of (B, S)).  Returns ``losses`` (one
    a step, before its update), ``first_grad`` (the norm of each leaf's
    clipped gradient at the first step, by path) and ``change`` (the norm
    of each leaf's change over all the steps, by path)."""
    start = {p: t for p, t in _leaves(params)}
    work = {p: t.detach().clone().requires_grad_() for p, t in start.items()}
    tree = _tree(params, work)
    mu = {p: torch.zeros_like(t) for p, t in start.items()}
    nu = {p: torch.zeros_like(t) for p, t in start.items()}
    losses: List[float] = []
    first_grad = {}
    for step, batch in enumerate(batches):
        tokens, labels = batch["tokens"], batch["labels"]
        count = tokens.numel()
        total = 0.0
        for r in range(0, tokens.shape[0], rows_at_once):
            part = model.token_loss(tree, cfg, tokens[r:r + rows_at_once],
                                    labels[r:r + rows_at_once]) / count
            part.backward()
            total += float(part.detach())
            del part
        losses.append(total)
        with torch.no_grad():
            grads = {p: (t.grad if t.grad is not None
                         else torch.zeros_like(t)) for p, t in work.items()}
            gnorm = math.sqrt(sum(float((g * g).sum())
                                  for g in grads.values()))
            scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9))
            lr = learning_rate(opt, step)
            b1, b2 = opt["b1"], opt["b2"]
            bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
            for p, t in work.items():
                g = grads[p] * scale
                if step == 0:
                    first_grad[p] = float(g.norm())
                mu[p].mul_(b1).add_(g, alpha=1 - b1)
                nu[p].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mu[p] / bc1) / (torch.sqrt(nu[p] / bc2) + opt["eps"])
                upd.add_(t, alpha=opt["weight_decay"])
                t.sub_(lr * upd)
                t.grad = None
            del grads
    with torch.no_grad():
        change = {p: float((work[p] - start[p]).norm()) for p in start}
    return {"losses": losses, "first_grad": first_grad, "change": change}
