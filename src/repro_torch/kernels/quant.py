"""Symmetric per-feature int8 quantization for the k-means kernels.

The quantized k-means variant stores points *and* centroids as int8 with
one shared fp32 scale per feature: storage and memory traffic shrink 4×,
the kernel dequantizes as it loads, and every accumulation (distance
expansion, per-centroid sums) stays fp32.  A shared per-*feature* scale
is the right axis for k-means: points and centroids live in the same
feature space, and per-feature scales do not factor out of the
contraction of an int8×int8 product (Σ_f s_f² q_x q_c has no common
factor), so the distance product runs on dequantized values while the
int8 arrays only pay the smaller memory bill.

Shared by the Hopper kernel's wrapper, the plain paths in
:mod:`repro_torch.ml.kmeans` and the :mod:`repro_torch.kernels.ref`
oracles — one rounding definition, so parity tests are exact.  It matches
``repro.kernels.quant`` bit for bit: both divide in fp32 and round half to
even (``torch.round`` and ``jnp.round``).
"""
from __future__ import annotations

import torch

INT8_MAX = 127.0


def symmetric_scales(points: torch.Tensor,
                     centroids: torch.Tensor) -> torch.Tensor:
    """Per-feature symmetric scales shared by points and centroids:
    ``s_f = max(max|x_f|, max|c_f|) / 127`` (never zero, so dequantize is
    always well-defined).  Returns an ``(F,)`` fp32 tensor."""
    amax = torch.maximum(points.float().abs().amax(dim=0),
                         centroids.float().abs().amax(dim=0))
    return amax.clamp_min(1e-12) / INT8_MAX


def quantize(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even symmetric int8 quantization, ``(N, F) -> int8``."""
    q = torch.round(x.float() / scales[None, :])
    return q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8)


def dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``int8 -> fp32`` (the values the kernels actually compute on)."""
    return q.float() * scales[None, :]


def fake_quantize(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Quantize → dequantize in one step: the fp32 values an int8 kernel
    sees, so 'int8 kernel vs int8 reference' comparisons are exact."""
    return dequantize(quantize(x, scales), scales)
