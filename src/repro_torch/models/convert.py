"""Carry parameter trees between the reference's layout and the port's.

The reference keeps its layer params stacked on a leading axis
(``params["blocks"]`` is one pytree of (L, ...) arrays, scanned with
``lax.scan``); the port keeps a list of one dict a layer.  The loaders
take the reference's trees as numpy arrays — in a test,
``jax.tree_util.tree_map(np.asarray, T.init_params(...))`` — and import
neither JAX nor the reference themselves.  :func:`stack_blocks`,
:func:`unstack_blocks` and :func:`to_reference` go the other way, for any
tree shaped like the parameters (AdamW's ``mu`` and ``nu``, the error
buffers of the int8 compression, a whole train state): checkpoints are
written in the reference's layout, so either package restores them.
:func:`unstack_specs` does for partition specs what :func:`unstack_blocks`
does for values, and :func:`leaves_with_specs` pairs each leaf with its
spec.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import default_device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes' bf16: via fp32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def load_reference_params(tree, cfg: ArchConfig, device=None):
    """The reference's parameter tree (numpy leaves, blocks stacked on
    axis 0) as the port's parameters (blocks a list of per-layer dicts),
    on ``cuda:0`` unless ``device`` names another."""
    device = default_device(device)
    params = {k: _map(v, lambda a: _tensor(a, device))
              for k, v in tree.items() if k != "blocks"}
    stacked = _map(tree["blocks"], lambda a: _tensor(a, device))
    params["blocks"] = [_map(stacked, lambda t, i=i: t[i].clone())
                        for i in range(cfg.n_layers)]
    return params


def load_reference_cache(tree, device=None):
    """The reference's cache (a dict of arrays stacked on the layer axis)
    as the port's, in the same layout, on ``cuda:0`` unless ``device``
    names another."""
    device = default_device(device)
    return {k: _tensor(v, device) for k, v in tree.items()}


def stack_blocks(tree, device=None):
    """The reference's layout of a port tree: every list of per-layer
    trees becomes one tree of tensors stacked on a new leading axis, on
    ``device`` (each tensor's own when None; meta tensors stack without
    memory).  With ``device="cpu"`` a card's tree comes to the host one
    stacked leaf at a time, so the host holds one copy of it."""
    if isinstance(tree, dict):
        return {k: stack_blocks(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        if isinstance(tree[0], dict):
            return {k: stack_blocks([it[k] for it in tree], device)
                    for k in tree[0]}
        return torch.stack([t.to(device) if device else t for t in tree])
    return tree.to(device) if device else tree


def unstack_blocks(tree, like):
    """The inverse of :func:`stack_blocks`, following ``like``: wherever
    ``like`` (a port tree) holds a list, the stacked tree at that place is
    split on its leading axis into ``len(like)`` entries (views, so a
    restored state takes no second copy)."""
    if isinstance(like, dict):
        return {k: unstack_blocks(tree[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [unstack_blocks(_map(tree, lambda t, i=i: t[i]), v)
                for i, v in enumerate(like)]
    return tree


def unstack_specs(specs, like):
    """A spec tree in the reference's stacked layout (``T.param_pspecs``;
    leaves are tuples) laid over a port tree ``like``: wherever ``like``
    holds a list of per-layer trees, each entry gets the stacked specs
    with their leading (layer) entry dropped."""
    if isinstance(like, dict):
        return {k: unstack_specs(specs[k], v) for k, v in like.items()}
    if isinstance(like, list):
        layer = _map(specs, lambda spec: spec[1:])
        return [unstack_specs(layer, v) for v in like]
    return specs


def leaves_with_specs(tree, specs):
    """(leaf, spec) pairs of a tree and a spec tree laid over it (dicts
    and lists walked alike, spec tuples taken whole), in the tree's
    order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves_with_specs(tree[k], specs[k])
    elif isinstance(tree, list):
        for v, spec in zip(tree, specs):
            yield from leaves_with_specs(v, spec)
    else:
        yield tree, specs


def to_reference(tree):
    """A port tree as the reference's: blocks stacked on axis 0, each
    leaf a numpy array on the host.  numpy has no bf16 of its own, so a
    bf16 leaf comes back widened to fp32, which is exact."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _map(stack_blocks(tree), host)
