"""Meshes, sharding rules and placements, ported from
``repro.launch.mesh``.

Functions, never module-level meshes: importing this module creates no
process group and touches no device.

* :func:`make_rules` — the reference's :class:`ShardRules` for any mesh
  with axis names and sizes: a ``DeviceMesh``, or the reference's jax
  meshes (``AbstractMesh`` included) in the parity tests.
* :func:`make_production_mesh` — the 16×16 or 2×16×16 ``DeviceMesh`` of
  the reference's 256- and 512-chip meshes, on a ``"fake"`` process group
  in this one process (its collectives move no data): what the dry-run
  shards meta tensors over.
* :func:`make_debug_mesh` — ``init_device_mesh`` over the ranks of the
  running process group.
* :func:`placements` / :func:`local_shape` — a spec tuple
  (``transformer.P``) as ``Shard``/``Replicate`` placements on a mesh, and
  the shape of one rank's shard (``DTensor``'s split: the first ranks
  take the ceiling).
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import torch.distributed as dist

from repro_torch.models.transformer import ShardRules, default_device


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names``, a shape
    tuple) or a jax mesh (``axis_names``, a shape mapping)."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks), on
    a ``"fake"`` default process group of that size made here when none
    is running; the caller destroys it.  The 'pod' axis is the DCN tier —
    the edge↔cloud boundary of the Pilot-Edge continuum mapping."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    device_type = default_device(device).type
    if not dist.is_initialized():
        # registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(shape))
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_rules(mesh, *, fsdp: bool = False, seq: bool = False,
               moe_groups: bool = True) -> ShardRules:
    """ShardRules matched to a mesh's axis names."""
    sizes = axis_sizes(mesh)
    batch = tuple(a for a in ("pod", "data") if a in sizes)
    groups = 1
    if moe_groups:
        for a in batch:
            groups *= sizes[a]
    # model_size stays 1, as in the reference: it gates kv-projection
    # replication in the param specs, which the reference measured as a
    # net loss; ShardRules(model_size=...) still selects it
    return ShardRules(batch=batch,
                      model="model",
                      fsdp=("data" if fsdp else None),
                      seq=("model" if seq else None),
                      moe_groups=groups,
                      model_size=1)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), device=None):
    """A small mesh over the ranks of the running process group (tests),
    on ``cuda`` unless ``device`` names another type."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(default_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> tuple:
    """The ``DTensor`` placements, one a mesh dimension, of a spec tuple:
    ``Shard(d)`` on each mesh axis that dimension d's entry names,
    ``Replicate()`` elsewhere.  A dimension split over several axes is
    split in mesh order, as jax splits ``("pod", "data")``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for a in _axes(entry):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in "
                                 f"the mesh's {names}")
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            out[i] = Shard(dim)
    return tuple(out)


def local_shape(shape, spec, mesh) -> tuple:
    """The largest shard a rank holds of a ``shape`` laid out by ``spec``
    on ``mesh`` (a ``DeviceMesh`` or jax mesh): each dimension divided by
    the product of its axes' sizes, rounded up."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in _axes(entry):
            out[dim] = -(-out[dim] // sizes[a])
    return tuple(out)
