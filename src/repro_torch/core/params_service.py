"""Parameter service — the paper's Redis analog (§II-B step 2.2).

"Further, it provides a Redis-based parameter server for sharing model
weights across the continuum." Model updates in the paper's experiments are
"managed via the parameter service".

Implementation: a versioned, thread-safe pytree store.

* ``publish(name, tree)`` — store a new version (monotonic version numbers);
  values are host-side numpy copies so publishers can keep mutating device
  arrays.
* ``fetch(name)`` / ``fetch_if_newer(name, have_version)`` — consumers poll
  for updates (the paper's model-update pattern: the inference task refreshes
  its model when the trainer publishes).
* ``subscribe(name, callback)`` — push notification within-process.
* ``place(name, device)`` — copy the current version onto a device as
  tensors: the continuum broadcast of the weights.

Versioning gives the same monotonic-read consistency Redis-with-version-keys
gives the paper; there is no cross-version tear because publish swaps the
whole tree atomically under the lock.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree


@dataclass
class _Entry:
    version: int
    tree: Any
    published_at: float
    nbytes: int


def _to_host(tree):
    # np.array(copy=True): published versions must be snapshots, immune to
    # later in-place mutation by the publisher; tensors leave their device
    return pytree.tree_map(
        lambda x: np.array(x.detach().cpu() if isinstance(x, torch.Tensor)
                           else x, copy=True), tree)


def _tree_bytes(tree) -> int:
    return sum(x.nbytes for x in pytree.tree_leaves(tree)
               if hasattr(x, "nbytes"))


class ParameterService:
    def __init__(self, metrics=None):
        self._lock = threading.Lock()
        self._store: Dict[str, _Entry] = {}
        self._subs: Dict[str, List[Callable[[int, Any], None]]] = {}
        self.metrics = metrics

    def publish(self, name: str, tree: Any) -> int:
        host_tree = _to_host(tree)
        nbytes = _tree_bytes(host_tree)
        with self._lock:
            version = (self._store[name].version + 1
                       if name in self._store else 1)
            self._store[name] = _Entry(version, host_tree,
                                       time.monotonic(), nbytes)
            subs = list(self._subs.get(name, ()))
        if self.metrics is not None:
            self.metrics.incr(f"params.{name}.publishes")
            self.metrics.incr(f"params.{name}.bytes", nbytes)
        for cb in subs:
            cb(version, host_tree)
        return version

    def fetch(self, name: str) -> Tuple[int, Any]:
        with self._lock:
            if name not in self._store:
                raise KeyError(name)
            e = self._store[name]
            return e.version, e.tree

    def fetch_if_newer(self, name: str,
                       have_version: int) -> Optional[Tuple[int, Any]]:
        with self._lock:
            e = self._store.get(name)
            if e is None or e.version <= have_version:
                return None
            return e.version, e.tree

    def version(self, name: str) -> int:
        with self._lock:
            e = self._store.get(name)
            return e.version if e else 0

    def subscribe(self, name: str,
                  callback: Callable[[int, Any], None]) -> None:
        with self._lock:
            self._subs.setdefault(name, []).append(callback)

    def place(self, name: str, device) -> Tuple[int, Any]:
        """Fetch + copy every leaf to ``device`` as a tensor — the
        cross-continuum weight broadcast."""
        version, tree = self.fetch(name)
        placed = pytree.tree_map(
            lambda x: torch.as_tensor(x).to(device), tree)
        return version, placed

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._store)
