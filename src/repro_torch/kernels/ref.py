"""Plain-PyTorch oracles for every kernel, ported from
``repro.kernels.ref``: flash attention, k-means and the SSD scan."""
from __future__ import annotations

import torch

from repro_torch.kernels import quant


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window=None):
    """O(S²) softmax attention. q (B,Sq,H,D); k/v (B,Sk,Hkv,D); GQA via
    kv-head broadcast. float32 softmax accumulation."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / torch.sqrt(torch.tensor(float(d)))
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    scores = scores.masked_fill(~mask[None, None], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)              # fully-masked rows
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


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


def ssd_ref(xh, dt, A, B_, C_, D):
    """Sequential (exact) SSD recurrence — the slow oracle.

    xh (B,S,nh,hd); dt (B,S,nh) post-softplus; A (nh,) negative;
    B_/C_ (B,S,g,ds); D (nh,). Returns y (B,S,nh,hd), final_state
    (B,nh,hd,ds).
    """
    b, s, nh, hd = xh.shape
    g, ds = B_.shape[2], B_.shape[3]
    rep = nh // g
    BH = B_.repeat_interleave(rep, dim=2).float()          # (B,S,nh,ds)
    CH = C_.repeat_interleave(rep, dim=2).float()
    xf = xh.float()
    dtf = dt.float()
    state = torch.zeros((b, nh, hd, ds), dtype=torch.float32,
                        device=xh.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t] * A[None, :])             # (B,nh)
        upd = torch.einsum("bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t],
                           BH[:, t])
        state = dA[:, :, None, None] * state + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, CH[:, t]))
    y = torch.stack(ys, dim=1)
    y = y + xf * D[None, None, :, None]
    return y.to(xh.dtype), state
