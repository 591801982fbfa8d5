"""Mini-App synthetic data generator (paper §III: "Synthetic data is
generated using the Mini-App data generator [11]").

Messages are blocks of ``n_points × n_features`` float64 points — the paper
uses 25–10,000 points × 32 features, 8 B/value serialized, i.e. 7 KB–2.6 MB
per message. Data is drawn from a Gaussian-mixture of ``n_clusters`` centers
(the k-means workload's 25 clusters) with a configurable fraction of uniform
outliers, so the three outlier detectors have actual outliers to find.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# the paper's message-size sweep
PAPER_POINTS = (25, 250, 2_500, 10_000)
N_FEATURES = 32
BYTES_PER_VALUE = 8


def message_nbytes(n_points: int, n_features: int = N_FEATURES) -> int:
    """Serialized payload size, paper accounting (8 B/value)."""
    return n_points * n_features * BYTES_PER_VALUE


@dataclass
class MiniAppGenerator:
    n_points: int = 2_500
    n_features: int = N_FEATURES
    n_clusters: int = 25
    outlier_frac: float = 0.02
    cluster_std: float = 1.0
    spread: float = 10.0          # cluster-center box half-width
    seed: int = 0
    _rng: np.random.Generator = field(init=False, repr=False)
    centers: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.centers = self._rng.uniform(
            -self.spread, self.spread,
            size=(self.n_clusters, self.n_features))

    def sample(self, n_points: Optional[int] = None) -> np.ndarray:
        """One message: (n_points, n_features) float64, ~outlier_frac
        uniform-box outliers mixed in."""
        n = n_points if n_points is not None else self.n_points
        which = self._rng.integers(0, self.n_clusters, size=n)
        pts = (self.centers[which]
               + self._rng.normal(0.0, self.cluster_std,
                                  size=(n, self.n_features)))
        n_out = int(round(self.outlier_frac * n))
        if n_out:
            idx = self._rng.choice(n, size=n_out, replace=False)
            pts[idx] = self._rng.uniform(-4 * self.spread, 4 * self.spread,
                                         size=(n_out, self.n_features))
        return pts

    def sample_with_labels(self, n_points: Optional[int] = None):
        """(points, is_outlier) for detector-quality checks."""
        n = n_points if n_points is not None else self.n_points
        pts = self.sample(n)
        # recompute outlier mask by distance to nearest center. Inliers sit
        # at ~std*sqrt(F) from their center (chi distribution), so 3x that
        # radius cleanly separates the uniform-box outliers.
        d = np.linalg.norm(pts[:, None, :] - self.centers[None], axis=-1)
        is_out = d.min(axis=1) > 3.0 * self.cluster_std * np.sqrt(
            self.n_features)
        return pts, is_out

    def make_producer(self, n_points: Optional[int] = None):
        """FaaS ``produce_edge`` handler bound to this generator."""
        def produce_edge(context):
            return self.sample(n_points)
        return produce_edge
