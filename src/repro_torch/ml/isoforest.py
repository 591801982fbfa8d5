"""Isolation forest in PyTorch — the paper's mid-complexity workload
(§III.2), ported from ``repro.ml.isoforest``.

"Isolation forests [17] are an ensemble technique where each task partitions
the dataset randomly into trees. An outlier is defined by the number of steps
required to isolate a data point ... We use the PyOD [18] implementation and
a default of 100 ensemble tasks."

PyOD wraps sklearn's IsolationForest: 100 trees, subsample ψ=256,
max_depth=⌈log₂ψ⌉=8.  As in the reference, trees are heap-layout arrays
(feature/threshold/leaf-size per node) built level by level with segment
min/max, no data-dependent recursion.  Where the reference ``vmap``s one
tree's build over 100 trees, this module builds all trees at once: every
array has a leading tree dimension and the segment ids of tree ``t`` are
offset by ``t · (width + 1)``, so a level is a handful of launches whatever
the number of trees.  Scoring descends all trees in lockstep.

Kept from the reference on purpose: the subsample is drawn *with
replacement* (not sklearn's); an empty node's segment min/max are ±inf, so
its threshold is ``inf + u·(−inf − inf)`` = NaN; a level routes its points
with ``is_leaf`` and ``threshold`` *after* its own writes; ``_c`` runs in
fp32.  Random streams are ``torch.Generator``s seeded by ``seed`` on the
forest's device (the reference's ``jax.random`` streams cannot be
matched), so parity with the reference is exact on a forest it built
(:func:`load_reference_state`) and statistical on this module's own fit.

The reference jits ``_fit`` and ``_score``; their compiled counterparts
are :data:`fit_fn` and :data:`score_fn` (:class:`repro_torch.graphs.GraphFn`:
one CUDA graph a key on the card, the eager functions on the CPU), which
:class:`IsolationForest` calls, or (``graph=False``) the eager functions.
``fit`` seeds a new generator on every call, so every message's forest
draws the same streams: :data:`fit_fn` is seeded, and on the card its
generator is seeded again before each replay, so that every replay builds
the eager fit's forest bit for bit.

Anomaly score (Liu et al. 2008): s(x) = 2^(−E[h(x)]/c(ψ)), where h(x) is
path length + c(leaf_size) continuation, c(n) = 2H(n−1) − 2(n−1)/n.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.graphs import GraphFn
from repro_torch.ml.kmeans import resolve_device
# either package's published {"forest", "psi"} (numpy) as tensors
from repro_torch.ml.kmeans import tree_to_device as load_reference_state

EULER_GAMMA = 0.5772156649015329


def _c(n):
    """Average unsuccessful-search path length in a BST of n nodes."""
    n = torch.as_tensor(n).to(torch.float32)
    h = torch.log(torch.clamp(n - 1.0, min=1.0)) + EULER_GAMMA
    return torch.where(n > 1.0, 2.0 * h - 2.0 * (n - 1.0) / n,
                       torch.zeros((), dtype=torch.float32,
                                   device=n.device))


def _segment(values, seg, n_seg, init, reduce):
    """Per-(tree, segment) reduction of ``values`` (T, P) over segment ids
    ``seg`` (T, P) in [0, n_seg): one flat ``scatter_reduce`` with the ids
    of tree t offset by t · n_seg; an empty segment keeps ``init``."""
    t = values.shape[0]
    flat = seg + torch.arange(t, device=seg.device)[:, None] * n_seg
    out = torch.full((t * n_seg,), init, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(0, flat.reshape(-1), values.reshape(-1), reduce,
                        include_self=True)
    return out.view(t, n_seg)


def _build_forest(gen: torch.Generator, sub, max_depth: int):
    """All isolation trees at once over subsamples ``sub`` (T, psi, F) —
    heap arrays (T, 2^(max_depth+1)-1): feature, threshold, is_leaf,
    size."""
    t, psi, f = sub.shape
    dev = sub.device
    n_nodes = 2 ** (max_depth + 1) - 1
    first_leaf = 2 ** max_depth - 1          # nodes at the bottom level

    feature = torch.zeros((t, n_nodes), dtype=torch.int32, device=dev)
    threshold = torch.zeros((t, n_nodes), dtype=torch.float32, device=dev)
    is_leaf = torch.zeros((t, n_nodes), dtype=torch.bool, device=dev)
    size = torch.zeros((t, n_nodes), dtype=torch.float32, device=dev)
    size[:, 0] = psi
    assign = torch.zeros((t, psi), dtype=torch.int64, device=dev)

    for d in range(max_depth):
        start, width = 2 ** d - 1, 2 ** d
        local = assign - start
        valid = (local >= 0) & (local < width)
        seg = torch.where(valid, local, width)          # invalid -> dump
        feat = torch.randint(0, f, (t, width), generator=gen, device=dev)
        # each point's value of ITS node's split feature
        my_feat = feat.gather(1, local.clamp(0, width - 1))
        val = sub.gather(2, my_feat[..., None])[..., 0]
        inf = torch.full_like(val, float("inf"))
        lo = _segment(torch.where(valid, val, inf), seg, width + 1,
                      float("inf"), "amin")[:, :width]
        hi = _segment(torch.where(valid, val, -inf), seg, width + 1,
                      float("-inf"), "amax")[:, :width]
        counts = _segment(valid.float(), seg, width + 1, 0.0,
                          "sum")[:, :width]
        u = torch.rand((t, width), generator=gen, device=dev)
        thr = lo + u * (hi - lo)
        # a node is splittable if >1 point and the chosen feature varies
        splittable = (counts > 1.0) & (hi > lo)
        feature[:, start:start + width] = feat.to(torch.int32)
        threshold[:, start:start + width] = thr
        is_leaf[:, start:start + width] = ~splittable
        # route points: left = 2i+1, right = 2i+2; points at leaves stay
        my_leaf = is_leaf.gather(1, assign) | (assign < start)
        go_left = val <= threshold.gather(1, assign)
        child = torch.where(go_left, 2 * assign + 1, 2 * assign + 2)
        assign = torch.where(my_leaf | ~valid, assign, child)
        # record child sizes
        start2, width2 = 2 ** (d + 1) - 1, 2 * width
        local2 = assign - start2
        valid2 = (local2 >= 0) & (local2 < width2)
        seg2 = torch.where(valid2, local2, width2)
        size[:, start2:start2 + width2] = _segment(
            valid2.float(), seg2, width2 + 1, 0.0, "sum")[:, :width2]
    # bottom-level nodes are leaves by construction
    is_leaf[:, first_leaf:] = True
    return {"feature": feature, "threshold": threshold,
            "is_leaf": is_leaf, "size": size}


def _walk(forest, x, max_depth: int):
    """Every point's leaf and depth in every tree: ``(node, depth)``, each
    (T, N)."""
    feature = forest["feature"].long()
    threshold, is_leaf = forest["threshold"], forest["is_leaf"]
    t, n = feature.shape[0], x.shape[0]
    xs = x.expand(t, *x.shape)
    node = torch.zeros((t, n), dtype=torch.int64, device=x.device)
    depth = torch.zeros((t, n), dtype=torch.float32, device=x.device)
    done = torch.zeros((t, n), dtype=torch.bool, device=x.device)
    for _ in range(max_depth):
        feat = feature.gather(1, node)
        thr = threshold.gather(1, node)
        leaf = is_leaf.gather(1, node)
        newly_done = leaf & ~done
        go_left = xs.gather(2, feat[..., None])[..., 0] <= thr
        child = torch.where(go_left, 2 * node + 1, 2 * node + 2)
        node = torch.where(leaf | done, node, child)
        depth = torch.where(done | newly_done, depth, depth + 1)
        done = done | newly_done
    return node, depth


def _path_length(forest, x, max_depth: int):
    """Expected path length of points x (N,F) through every tree: (T, N)."""
    node, depth = _walk(forest, x, max_depth)
    return depth + _c(forest["size"].gather(1, node))


def _score(forest, x, psi, max_depth: int):
    eh = _path_length(forest, x, max_depth).mean(0)
    return torch.pow(2.0, -eh / torch.clamp(_c(psi), min=1e-6))


def _fit(gen: torch.Generator, pts, n_trees: int, psi: int,
         max_depth: int):
    n = pts.shape[0]
    idx = torch.randint(0, n, (n_trees, psi), generator=gen,
                        device=pts.device)            # with replacement
    return _build_forest(gen, pts[idx], max_depth)


# the compiled counterparts of the reference's jitted functions:
# fit_fn(pts, seed=, n_trees=, psi=, max_depth=) and
# score_fn(forest, x, psi, max_depth=)
fit_fn = GraphFn(_fit, seeded=True)
score_fn = GraphFn(_score)


@dataclass
class IsolationForest:
    n_trees: int = 100
    psi: int = 256                 # subsample size (sklearn default)
    seed: int = 0
    device: Optional[torch.device] = None
    graph: bool = True             # the compiled functions (False: eager)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def max_depth(self) -> int:
        return int(np.ceil(np.log2(self.psi)))

    def _points(self, points) -> torch.Tensor:
        return torch.as_tensor(points, dtype=torch.float32,
                               device=self.device)

    def _compiled(self, fn: GraphFn):
        return fn if self.graph else fn.eager

    @torch.no_grad()
    def fit(self, points):
        pts = self._points(points)
        psi = min(self.psi, pts.shape[0])
        forest = self._compiled(fit_fn)(pts, seed=self.seed,
                                        n_trees=self.n_trees, psi=psi,
                                        max_depth=self.max_depth)
        return {"forest": forest,
                "psi": torch.tensor(psi, dtype=torch.float32,
                                    device=self.device)}

    @torch.no_grad()
    def outlier_scores(self, state, points) -> torch.Tensor:
        return self._compiled(score_fn)(state["forest"],
                                        self._points(points), state["psi"],
                                        max_depth=self.max_depth)

    def make_processor(self, param_service=None, model_name: str = "iforest",
                       train: bool = True):
        """FaaS handler: refit on each message (the paper's streaming
        model-update pattern — 100 ensemble tasks per message)."""
        holder = {"state": None, "version": 0}

        def process_cloud(context, data=None):
            pts = np.asarray(data, np.float64)
            if holder["state"] is None and param_service is not None \
                    and model_name in param_service.names():
                v, tree = param_service.fetch(model_name)
                holder["state"] = load_reference_state(tree, self.device)
                holder["version"] = v
            if train or holder["state"] is None:
                holder["state"] = self.fit(pts)
                if param_service is not None:
                    holder["version"] = param_service.publish(
                        model_name, holder["state"])
            scores = self.outlier_scores(holder["state"], pts).cpu().numpy()
            return {"n_outliers": int((scores > 0.6).sum()),
                    "mean_score": float(scores.mean())}

        return process_cloud
