"""Random weights from the seed, made on the run's device in a few large
draws and laid into the port's parameter tree.

The recipe is the one ``repro_torch.models.transformer.init_params``
documents: normal draws × 0.02, output projections × 0.02/√(2L), norms at
1, the embedding's pad rows and the head's pad columns at 0, the SSM's
``A_log = log(1..nh)``, ``D = 1``, ``dt_bias`` the inverse softplus of a
log-uniform draw in [dt_min, dt_max], ``conv_b = 0``.  The values are the
benchmark's own (one generator, seeded by ``--seed``), so the same seed
gives the same weights, and the program and the reference are handed the
same tensors.  Only the tree's layout (names and shapes) is the port's.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

ONES = ("ln1", "ln2", "ln_f", "attn_norm", "ssm_norm_out", "norm", "D")
ZEROS = ("conv_b",)
OUTPUT = ("wo", "w_down", "out_proj")


def leaves(tree, prefix=()) -> List[Tuple[tuple, torch.Tensor]]:
    """(path, tensor) of every leaf of a tree of dicts and lists, in a
    fixed order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, v in items:
        out.extend(leaves(v, prefix + (k,)))
    return out


def _rebuild(tree, made, prefix=()):
    if isinstance(tree, torch.Tensor):
        return made[prefix]
    if isinstance(tree, dict):
        return {k: _rebuild(v, made, prefix + (k,)) for k, v in tree.items()}
    return [_rebuild(v, made, prefix + (i,)) for i, v in enumerate(tree)]


def make(cfg, layout, seed: int, device) -> dict:
    """The weights of configuration ``cfg`` (its file's dict) in the tree
    ``layout`` (meta tensors of the port's parameters), drawn from
    ``seed`` on ``device`` in float32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out_scale = 0.02 / math.sqrt(2.0 * cfg["n_layers"])
    normal = [(p, t) for p, t in leaves(layout)
              if p[-1] not in ONES + ZEROS + ("A_log", "dt_bias")]
    total = sum(t.numel() for _, t in normal)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    made, at = {}, 0
    for path, t in normal:
        leaf = flat[at:at + t.numel()].view(t.shape)
        at += t.numel()
        leaf.mul_(out_scale if path[-1] in OUTPUT else 0.02)
        made[path] = leaf
    v = cfg["vocab_size"]
    if ("embed",) in made:
        made[("embed",)][v:] = 0.0
    if ("head",) in made:
        made[("head",)][:, v:] = 0.0
    dt_leaves = [(p, t) for p, t in leaves(layout) if p[-1] == "dt_bias"]
    if dt_leaves:
        s = cfg["ssm"]
        u = torch.rand(sum(t.numel() for _, t in dt_leaves), generator=gen,
                       device=device, dtype=torch.float32)
        dt = torch.exp(u * (math.log(s["dt_max"]) - math.log(s["dt_min"]))
                       + math.log(s["dt_min"]))
        inv = dt + torch.log(-torch.expm1(-dt))            # inverse softplus
        at = 0
        for path, t in dt_leaves:
            made[path] = inv[at:at + t.numel()].view(t.shape)
            at += t.numel()
    for path, t in leaves(layout):
        if path[-1] in ONES:
            made[path] = torch.ones(t.shape, dtype=torch.float32,
                                    device=device)
        elif path[-1] in ZEROS:
            made[path] = torch.zeros(t.shape, dtype=torch.float32,
                                     device=device)
        elif path[-1] == "A_log":
            made[path] = torch.log(torch.arange(
                1, t.numel() + 1, dtype=torch.float32,
                device=device)).view(t.shape)
    return _rebuild(layout, made)
