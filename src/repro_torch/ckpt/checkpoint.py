"""Checkpoints with atomic commit, ported from ``repro.ckpt.checkpoint``
with its on-disk format, so either package restores the other's files.

* ``save(directory, step, tree)`` — each leaf is written as one
  ``leaf_<i>.npy`` inside a temp directory, then the directory is
  atomically renamed to ``step_<n>`` (a torn write can never be mistaken
  for a checkpoint).  ``manifest.json`` records each leaf's key, file,
  shape and dtype.  Leaves are numbered in the reference's order (dict
  keys sorted, list entries in order) and keyed by their path, so a tree
  in the reference's layout (:func:`repro_torch.models.convert.
  stack_blocks`) gives the reference's files byte for byte.
* bf16 leaves: the reference writes ml_dtypes' bfloat16 with ``np.save``,
  whose header says ``'<V2'``; here the same header and the same two-byte
  bit patterns are written and read without ml_dtypes, and the manifest
  says ``"bfloat16"`` as the reference's does.
* ``restore(directory, step, like=..., device=...)`` — loads leaves by
  key into the structure of ``like`` (tensors, meta tensors included;
  other leaves keep the file's type), cast to like's types, on ``device`` (the
  card unless another is named): a checkpoint written on one device
  restores onto whatever device is alive now.  With ``mesh`` (a
  ``DeviceMesh``) and ``pspecs`` (spec tuples in like's structure), each
  leaf becomes a ``DTensor`` with its spec's placements on that mesh —
  resharding onto whatever mesh is alive now.
* ``CheckpointManager`` — keep-last-N rotation + async save (the train
  driver checkpoints without stalling the step loop).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.transformer import default_device

_STEP_RE = re.compile(r"^step_(\d+)$")
_BF16_DESCR = "<V2"          # what np.save writes for ml_dtypes.bfloat16


def _flatten_with_paths(tree, prefix=()):
    """(key, leaf) pairs in the reference's order: dict keys sorted, as
    JAX flattens dicts; list entries by index."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):                 # leaves in sorted order,
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}      # keys in like's order
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(like)


def _write_leaf(path: str, leaf) -> tuple:
    """Write one leaf as ``.npy``; returns (shape, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy()
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(f, {
                    "descr": _BF16_DESCR, "fortran_order": False,
                    "shape": tuple(bits.shape)})
                f.write(bits.tobytes())
            return list(bits.shape), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    np.save(path, arr, allow_pickle=False)
    return list(arr.shape), str(arr.dtype)


def _read_leaf(path: str, dtype_name: str) -> torch.Tensor:
    arr = np.load(path, allow_pickle=False)
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(directory: str, step: int, tree: Any) -> str:
    """Atomic checkpoint write. Returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=directory)
    try:
        manifest = {"step": step, "leaves": []}
        for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
            fname = f"leaf_{i}.npy"
            shape, dtype = _write_leaf(os.path.join(tmp, fname), leaf)
            manifest["leaves"].append(
                {"key": key, "file": fname, "shape": shape,
                 "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):          # overwrite = replace atomically
            shutil.rmtree(final)
        os.rename(tmp, final)              # the atomic commit
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def _specs_like(like, pspecs):
    """The spec of each leaf of ``like``, in :func:`_flatten_with_paths`'
    order (spec tuples are leaves here, not trees)."""
    if isinstance(like, dict):
        return [sp for k in sorted(like)
                for sp in _specs_like(like[k], pspecs[k])]
    if isinstance(like, (list, tuple)):
        return [sp for v, p in zip(like, pspecs)
                for sp in _specs_like(v, p)]
    return [pspecs]


def restore(directory: str, step: Optional[int] = None, *, like: Any,
            device=None, mesh=None, pspecs: Any = None) -> Any:
    """Restore into the structure of ``like``, each leaf cast to like's
    dtype and placed on ``device`` (``cuda:0`` unless another is named),
    or, with ``mesh`` and ``pspecs``, distributed as a ``DTensor`` by its
    spec on ``mesh`` (its device type)."""
    if mesh is not None and pspecs is not None:
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.launch.mesh import placements
        device = default_device(mesh.device_type)
        specs = iter(_specs_like(like, pspecs))

        def place(t):
            return distribute_tensor(t.to(device), mesh,
                                     placements(next(specs), mesh))
    else:
        device = default_device(device)

        def place(t):
            return t.to(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    restored = []
    for key, leaf_like in _flatten_with_paths(like):
        entry = by_key.get(key)
        if entry is None:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        t = _read_leaf(os.path.join(path, entry["file"]), entry["dtype"])
        want = (leaf_like.dtype if isinstance(leaf_like, torch.Tensor)
                else t.dtype)
        restored.append(place(t.to(dtype=want)))
    return _unflatten(like, restored)


class CheckpointManager:
    """keep-last-N rotation + optional async writes."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any) -> None:
        host_tree = _snapshot(tree)
        if self.async_save:
            self.wait()
            t = threading.Thread(target=self._save_and_gc,
                                 args=(step, host_tree), daemon=True)
            t.start()
            self._pending = t
        else:
            self._save_and_gc(step, host_tree)

    def _save_and_gc(self, step: int, tree: Any) -> None:
        save(self.directory, step, tree)
        steps = sorted(int(m.group(1)) for d in os.listdir(self.directory)
                       if (m := _STEP_RE.match(d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore_latest(self, like: Any, device=None, mesh=None,
                       pspecs=None):
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore(self.directory, step, like=like,
                             device=device, mesh=mesh, pspecs=pspecs)


def _snapshot(tree):
    """Every leaf on the host now: a card's tensors are copied, host
    tensors and arrays are taken as they are (the reference's
    ``np.asarray``), so the caller must not write into those in place
    before the save is done."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_snapshot(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return np.asarray(tree)
