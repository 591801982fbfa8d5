"""Public entry points of the kernels (``from repro_torch.kernels import
ops as kops``), the counterpart of ``repro.kernels.ops``.

Where the reference picks interpret mode from the default backend, the
port dispatches on the device of the tensors it is given: a CPU tensor
takes the kernel's plain version, a CUDA tensor launches the Hopper kernel
on an sm_90 card or raises (:mod:`repro_torch.kernels.kmeans`,
:mod:`~repro_torch.kernels.flash_attention`, :mod:`~repro_torch.kernels.ssd`).
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.kmeans import DEFAULT_BLOCK_N
from repro_torch.kernels.kmeans import kmeans_assign as _kmeans_assign
from repro_torch.kernels.kmeans import kmeans_assign_update as _kmeans_fused
from repro_torch.kernels.ssd import ssd_chunk_scan as _ssd


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q (B,Sq,H,D); k/v (B,Sk,Hkv,D) -> (B,Sq,H,D)."""
    return _flash(q, k, v, causal=causal, window=window)


def kmeans_assign(points, centroids, *, precision: str = "fp32",
                  block_n: int = DEFAULT_BLOCK_N):
    """Assignment only: (ids (N,) int32, dmin (N,) f32)."""
    return _kmeans_assign(points, centroids, precision=precision,
                          block_n=block_n)


def kmeans_assign_update(points, centroids, *, precision: str = "fp32",
                         block_n: int = DEFAULT_BLOCK_N):
    """Fused assign+update: (ids, dmin, sums (K,F), counts (K,))."""
    return _kmeans_fused(points, centroids, precision=precision,
                         block_n=block_n)


def ssd_chunk_scan(xh, dt, A, B_, C_, D, *, chunk: int = 256):
    """Mamba2 SSD: (y (B,S,nh,hd), final state (B,nh,hd,ds))."""
    return _ssd(xh, dt, A, B_, C_, D, chunk=chunk)
