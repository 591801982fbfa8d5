"""Plain-PyTorch oracles for the k-means kernels, ported from
``repro.kernels.ref`` (the oracles of the other kernels wait for their
slices)."""
from __future__ import annotations

import torch

from repro_torch.kernels import quant


def kmeans_assign_ref(points: torch.Tensor, centroids: torch.Tensor):
    """points (N,F), centroids (K,F) -> (ids (N,) int32, min-dist (N,)).
    Distances via the expansion ||x||²−2x·cᵀ+||c||²."""
    x = points.float()
    c = centroids.float()
    x2 = (x * x).sum(dim=1, keepdim=True)
    c2 = (c * c).sum(dim=1)
    d2 = torch.clamp_min(x2 - 2.0 * (x @ c.T) + c2[None, :], 0.0)
    ids = torch.argmin(d2, dim=1)
    dmin = torch.sqrt(torch.take_along_dim(d2, ids[:, None], dim=1)[:, 0])
    return ids.to(torch.int32), dmin


def kmeans_assign_update_ref(points: torch.Tensor, centroids: torch.Tensor):
    """Two-pass oracle for the fused assign+update kernel: assignment via
    :func:`kmeans_assign_ref`, then an explicit (K,N) one-hot matmul for
    the per-centroid sums/counts.  Returns (ids, dmin, sums (K,F) f32,
    counts (K,) f32)."""
    ids, dmin = kmeans_assign_ref(points, centroids)
    k = centroids.shape[0]
    onehot = torch.nn.functional.one_hot(ids.long(), k).float()   # (N, K)
    sums = onehot.T @ points.float()                               # (K, F)
    counts = onehot.sum(dim=0)                                     # (K,)
    return ids, dmin, sums, counts


def kmeans_assign_update_int8_ref(points: torch.Tensor,
                                  centroids: torch.Tensor):
    """int8 oracle: fake-quantize points/centroids with the shared
    per-feature scales, then run the exact fp32 two-pass oracle on the
    rounded values — precisely what the int8 kernel computes (sums are
    dequantized-point sums)."""
    xf = points.float()
    cf = centroids.float()
    scales = quant.symmetric_scales(xf, cf)
    return kmeans_assign_update_ref(quant.fake_quantize(xf, scales),
                                    quant.fake_quantize(cf, scales))
