"""Carry the reference's parameters and caches into the port.

The reference keeps its layer params stacked on a leading axis
(``params["blocks"]`` is one pytree of (L, ...) arrays, scanned with
``lax.scan``); the port keeps a list of one dict a layer.  These helpers
take the reference's trees as numpy arrays — in a test,
``jax.tree_util.tree_map(np.asarray, T.init_params(...))`` — and import
neither JAX nor the reference themselves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
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
    L.check_supported(cfg)
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
