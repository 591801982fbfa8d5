"""Public entry points of the kernels (``from repro_torch.kernels import
ops as kops``), the counterpart of ``repro.kernels.ops``.

Where the reference picks interpret mode from the default backend, the
port dispatches on the device of the tensors it is given: a CPU tensor
takes the kernel's plain version, a CUDA tensor launches the Hopper kernel
or raises (:mod:`repro_torch.kernels.kmeans`).  Only the k-means entries
exist so far; flash attention and the SSD scan wait for their slices.
"""
from __future__ import annotations

from repro_torch.kernels.kmeans import kmeans_assign as _kmeans_assign
from repro_torch.kernels.kmeans import kmeans_assign_update as _kmeans_fused


def kmeans_assign(points, centroids, *, precision: str = "fp32"):
    """Assignment only: (ids (N,) int32, dmin (N,) f32)."""
    return _kmeans_assign(points, centroids, precision=precision)


def kmeans_assign_update(points, centroids, *, precision: str = "fp32"):
    """Fused assign+update: (ids, dmin, sums (K,F), counts (K,))."""
    return _kmeans_fused(points, centroids, precision=precision)
