"""Streaming (mini-batch) k-means in PyTorch — the paper's lightest
workload (25 clusters, §III.2), ported from ``repro.ml.kmeans``.

The paper's pattern: "the model is updated based on the incoming data;
model updates are managed via the parameter service".  Exactly that:

* ``assign(points)`` — nearest-centroid ids + distances (inference /
  outlier score);
* ``update(points)`` / ``assign_update(points)`` — one mini-batch k-means
  step (Sculley 2010) with per-seen-count learning rates, fused with the
  assignment: one pass over the points yields ids, distances and the
  per-centroid sums/counts the update needs;
* ``outlier_scores(points)`` — distance to the assigned centroid.

Implementation axis (``impl``), mapped from the reference's:

* ``"kernel"`` (default) — the hand-written Hopper kernel through
  :mod:`repro_torch.kernels.ops` (the reference's ``"pallas"``).  On a
  CUDA device it launches the kernel; on the CPU it takes the kernel's
  plain version.  So the normal entry point (:meth:`make_processor`)
  reaches the kernel on the card.
* ``"fused"`` — distance expansion + ``index_add_`` membership
  statistics (the reference's ``"fused"``).
* ``"twopass"`` — assign, then an (N,K) one-hot matmul (the reference's
  ``"jnp"`` baseline).

Precision axis (``precision``): ``fp32`` | ``bf16`` | ``int8``.  The plain
paths simulate the reduced-precision kernel exactly: bf16 rounds points
and centroids to bfloat16, int8 fake-quantizes both with the shared
per-feature scales of :mod:`repro_torch.kernels.quant`.

Every entry point computes on ``device``, which defaults to the CUDA card:
``KMeans()`` raises on a host without one, and never carries on on the
CPU unless the caller passes ``device="cpu"``.

State is a plain dict ``{"centroids", "counts"}`` of tensors on
``device``; the parameter service publishes it as numpy, exactly as the
reference's, and :func:`load_reference_state` carries a reference state
across.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import ops as kops
from repro_torch.kernels import quant

IMPLS = ("kernel", "fused", "twopass")
PRECISIONS = ("fp32", "bf16", "int8")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    card, and raises where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: repro_torch runs on the card "
                "by default; pass device='cpu' to run on the host")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def tree_to_device(tree, device):
    """A numpy tree — what a ``ParameterService.fetch`` of either package
    returns — as tensors on ``device``, dtypes kept."""
    dev = torch.device(device)
    return pytree.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def load_reference_state(tree, device) -> dict:
    """A k-means state of the reference package — ``{"centroids",
    "counts"}`` as numpy, what ``repro``'s ``ParameterService.fetch``
    returns — as this package's fp32 tensors on ``device``."""
    dev = torch.device(device)
    return {name: torch.as_tensor(np.asarray(tree[name]),
                                  dtype=torch.float32, device=dev)
            for name in ("centroids", "counts")}


def _precision_view(centroids, points, precision: str):
    """The fp32 values a reduced-precision kernel actually computes on."""
    if precision == "fp32":
        return centroids, points
    if precision == "bf16":
        return (centroids.to(torch.bfloat16).float(),
                points.to(torch.bfloat16).float())
    if precision == "int8":
        scales = quant.symmetric_scales(points, centroids)
        return (quant.fake_quantize(centroids, scales),
                quant.fake_quantize(points, scales))
    raise ValueError(f"precision must be one of {PRECISIONS}, "
                     f"got {precision!r}")


def _expansion_assign(centroids, points):
    # ||x-c||^2 = ||x||^2 - 2 x.c + ||c||^2 (the kernels' matmul form)
    x2 = (points * points).sum(dim=1, keepdim=True)
    c2 = (centroids * centroids).sum(dim=1)
    d2 = torch.clamp_min(x2 - 2.0 * (points @ centroids.T) + c2[None, :],
                         0.0)
    ids = torch.argmin(d2, dim=1)
    dmin = torch.sqrt(torch.gather(d2, 1, ids[:, None])[:, 0])
    return ids, dmin


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def _assign(centroids, points, impl: str = "kernel",
            precision: str = "fp32"):
    _check_impl(impl)
    if impl == "kernel":
        return kops.kmeans_assign(points, centroids, precision=precision)
    centroids, points = _precision_view(centroids, points, precision)
    return _expansion_assign(centroids, points)


def _assign_update(centroids, counts, points, impl: str = "kernel",
                   precision: str = "fp32"):
    """Fused mini-batch k-means step: one pass over ``points`` returns
    ``(new_centroids, new_counts, ids, dmin)``."""
    _check_impl(impl)
    k = centroids.shape[0]
    if impl == "kernel":
        ids, dmin, sums, batch_counts = kops.kmeans_assign_update(
            points, centroids, precision=precision)
    else:
        # sums accumulate the *precision view* of the points: a quantized
        # kernel only ever holds quantized data, so the plain path updates
        # centroids from the same values the kernel sums
        cv, pv = _precision_view(centroids, points, precision)
        ids, dmin = _expansion_assign(cv, pv)
        if impl == "twopass":
            onehot = torch.nn.functional.one_hot(ids, k).float()   # (N,K)
            batch_counts = onehot.sum(dim=0)                        # (K,)
            sums = onehot.T @ pv                                    # (K,F)
        else:
            sums = torch.zeros_like(cv).index_add_(0, ids, pv)
            batch_counts = torch.bincount(ids, minlength=k).float()
    new_counts = counts + batch_counts
    lr = torch.where(batch_counts > 0,
                     batch_counts / torch.clamp_min(new_counts, 1.0),
                     0.0)[:, None]
    means = sums / torch.clamp_min(batch_counts, 1.0)[:, None]
    new_centroids = centroids * (1.0 - lr) + means * lr
    return new_centroids, new_counts, ids, dmin


@dataclass
class KMeans:
    n_clusters: int = 25
    n_features: int = 32
    seed: int = 0
    impl: str = "kernel"            # kernel | fused | twopass
    precision: str = "fp32"         # fp32 | bf16 | int8
    device: Optional[torch.device] = None

    def __post_init__(self):
        _check_impl(self.impl)
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, "
                             f"got {self.precision!r}")
        self.device = resolve_device(self.device)

    def _points(self, points) -> torch.Tensor:
        # messages arrive as float64 numpy: the kernels compute on fp32
        return torch.as_tensor(points, dtype=torch.float32,
                               device=self.device)

    def init(self, sample: Optional[np.ndarray] = None):
        if sample is not None and len(sample) >= self.n_clusters:
            idx = np.random.default_rng(self.seed).choice(
                len(sample), self.n_clusters, replace=False)
            cent = torch.as_tensor(np.asarray(sample)[idx],
                                   dtype=torch.float32, device=self.device)
        else:
            gen = torch.Generator().manual_seed(self.seed)
            cent = (torch.randn((self.n_clusters, self.n_features),
                                generator=gen) * 5.0).to(self.device)
        return {"centroids": cent,
                "counts": torch.zeros(self.n_clusters, dtype=torch.float32,
                                      device=self.device)}

    def assign(self, state, points) -> Tuple[torch.Tensor, torch.Tensor]:
        return _assign(state["centroids"], self._points(points),
                       impl=self.impl, precision=self.precision)

    def update(self, state, points):
        cent, counts, _, _ = _assign_update(
            state["centroids"], state["counts"], self._points(points),
            impl=self.impl, precision=self.precision)
        return {"centroids": cent, "counts": counts}

    def assign_update(self, state, points):
        """One fused pass: (new_state, ids, dmin) — the streaming hot
        path ``make_processor`` runs per message."""
        cent, counts, ids, dmin = _assign_update(
            state["centroids"], state["counts"], self._points(points),
            impl=self.impl, precision=self.precision)
        return {"centroids": cent, "counts": counts}, ids, dmin

    def outlier_scores(self, state, points) -> torch.Tensor:
        _, d = self.assign(state, points)
        return d

    def inertia(self, state, points) -> float:
        _, d = self.assign(state, points)
        return float((d * d).sum())

    def make_processor(self, param_service=None, model_name: str = "kmeans",
                       train: bool = True):
        """FaaS ``process_cloud`` handler: score + (optionally) update +
        publish to the parameter service — the paper's model-update loop.
        Training messages take the fused path: one assign+update pass
        yields the outlier scores and the centroid step together."""
        holder = {"state": None, "version": 0}

        def process_cloud(context, data=None):
            pts = np.asarray(data, np.float64)
            if holder["state"] is None:
                if param_service is not None and model_name in \
                        param_service.names():
                    v, tree = param_service.fetch(model_name)
                    holder["state"] = load_reference_state(tree,
                                                           self.device)
                    holder["version"] = v
                else:
                    holder["state"] = self.init(pts)
            elif param_service is not None:
                newer = param_service.fetch_if_newer(
                    model_name, holder["version"])
                if newer is not None:
                    holder["version"] = newer[0]
                    holder["state"] = load_reference_state(newer[1],
                                                           self.device)
            if train:
                holder["state"], _, scores = self.assign_update(
                    holder["state"], pts)
                if param_service is not None:
                    holder["version"] = param_service.publish(
                        model_name, holder["state"])
            else:
                scores = self.outlier_scores(holder["state"], pts)
            s = scores.cpu().numpy()
            thresh = s.mean() + 3.0 * s.std()
            return {"n_outliers": int((s > thresh).sum()),
                    "mean_score": float(s.mean())}

        return process_cloud


def assignment_agreement(precision: str, *, n_points: int = 2_500,
                         n_features: int = 32, n_clusters: int = 25,
                         seed: int = 0, n_warmup: int = 10) -> float:
    """Fraction of points a reduced-precision variant assigns to the same
    centroid as the fp32 reference, on a fixed MiniAppGenerator probe,
    after ``n_warmup`` streaming updates so the centroids are
    near-converged.  Runs the plain ``fused`` path on the CPU, so it is
    deterministic and needs no card; cached."""
    key = (precision, n_points, n_features, n_clusters, seed, n_warmup)
    hit = _AGREEMENT_CACHE.get(key)
    if hit is not None:
        return hit
    from repro_torch.ml.datagen import MiniAppGenerator
    gen = MiniAppGenerator(n_points=n_points, n_features=n_features,
                           n_clusters=n_clusters, seed=seed)
    pts = gen.sample()
    model = KMeans(n_clusters=n_clusters, n_features=n_features, seed=seed,
                   impl="fused", device="cpu")
    state = model.init(pts)
    for _ in range(n_warmup):
        state = model.update(state, gen.sample())
    probe = torch.as_tensor(pts, dtype=torch.float32)
    ref_ids, _ = _assign(state["centroids"], probe, impl="fused",
                         precision="fp32")
    ids, _ = _assign(state["centroids"], probe, impl="fused",
                     precision=precision)
    agree = float((ids == ref_ids).float().mean())
    _AGREEMENT_CACHE[key] = agree
    return agree


_AGREEMENT_CACHE: dict = {}
