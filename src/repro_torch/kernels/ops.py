"""Public entry points of the kernels (``from repro_torch.kernels import
ops as kops``), the counterpart of ``repro.kernels.ops``.

Where the reference picks interpret mode from the default backend, the
port dispatches on the device of the tensors it is given: a CPU tensor
takes the kernel's plain version, a CUDA tensor launches the Hopper kernel
on an sm_90 card or raises (:mod:`repro_torch.kernels.kmeans`,
:mod:`~repro_torch.kernels.flash_attention`, :mod:`~repro_torch.kernels.ssd`,
:mod:`~repro_torch.kernels.decode_attention`,
:mod:`~repro_torch.kernels.ssm_decode`).
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import \
    decode_attention as _decode_attention
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.kmeans import DEFAULT_BLOCK_N
from repro_torch.kernels.kmeans import kmeans_assign as _kmeans_assign
from repro_torch.kernels.kmeans import kmeans_assign_update as _kmeans_fused
from repro_torch.kernels.ssd import ssd_chunk_scan as _ssd
from repro_torch.kernels.ssm_decode import ssm_decode as _ssm_decode


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None):
    """q (B,Sq,H,D); k/v (B,Sk,Hkv,D) -> (B,Sq,H,D); scores times
    ``scale`` (None: 1/√D)."""
    return _flash(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention(q, k, v, k_cache, v_cache, length, cos, sin, *,
                     ring: bool, scale=None):
    """One decode step's attention core: q (B,H,D), k/v (B,Hkv,D) unroped,
    caches (B,S,Hkv,D) written at the position's slot in place ->
    (B,1,H·D); scores times ``scale`` (None: 1/√D)."""
    return _decode_attention(q, k, v, k_cache, v_cache, length, cos, sin,
                             ring=ring, scale=scale)


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


def ssm_decode(xbc, dt_raw, conv_state, ssm_state, conv_w, conv_b, dt_bias,
               A_log, D, *, n_groups: int):
    """One Mamba2 decode step's recurrence: xbc (B,conv_dim) pre-conv and
    dt_raw (B,nh); the conv window (B,d_conv-1,conv_dim) and the fp32 state
    (B,nh,hd,ds) updated in place -> y (B,1,nh·hd)."""
    return _ssm_decode(xbc, dt_raw, conv_state, ssm_state, conv_w, conv_b,
                       dt_bias, A_log, D, n_groups=n_groups)
