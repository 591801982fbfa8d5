"""int8 gradient compression with error feedback for the data-parallel
reduction across pods, ported from ``repro.optim.compression``.

    q = round(g / s),  s = max|g| / 127        (per tensor, max over the group)
    all-to-all(int8) → dequantize, sum, average → requantize → all-gather(int8)

The reference reduces over the ``'pod'`` axis of a ``shard_map``; here the
group is a ``torch.distributed`` process group, one rank a pod.  Error
feedback (Karimireddy et al. 2019) keeps each rank's quantization residual
and adds it back to the next step's gradient.  With no group (or a group
of one) nothing leaves the rank: the result is the dequantized gradient,
the reference's ``p == 1`` shortcut.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils import _pytree as pytree


def _scale(x) -> torch.Tensor:
    return torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0


def _quantize(x, scale) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def int8_compress(g):
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    g32 = g.float()
    scale = _scale(g32)
    return _quantize(g32, scale), scale


def int8_decompress(q, scale):
    return q.float() * scale


def _group_max(x, group):
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def compressed_psum(g, group=None, error=None):
    """int8 all-reduce-mean over ``group`` with error feedback.

    The wire carries int8 both ways: each rank sends chunk i of its
    quantized gradient to rank i, which dequantizes, sums and averages its
    chunk, requantizes it under a second shared scale and all-gathers the
    chunks.  Returns ``(g_avg_f32, new_error)``; ``new_error`` is this
    rank's residual ``g + error − dequantize(q)`` in fp32."""
    g32 = g.float()
    if error is not None:
        g32 = g32 + error.float()
    p = 1 if group is None else dist.get_world_size(group)
    shape, n = g32.shape, g32.numel()
    flat = F.pad(g32.reshape(-1), (0, (-n) % p))

    scale = _group_max(_scale(g32), group)
    q = _quantize(flat, scale)
    deq = q[:n].float().reshape(shape) * scale
    new_error = g32 - deq
    if p == 1:
        return deq, new_error

    chunks = q.reshape(p, -1)
    recv = torch.empty_like(chunks)
    dist.all_to_all_single(recv, chunks, group=group)
    # recv[j]: rank j's contribution to MY chunk — dequantize and average
    local_sum = torch.sum(recv.float(), dim=0) * scale / p
    scale2 = _group_max(_scale(local_sum), group)
    q2 = _quantize(local_sum, scale2)
    gathered = [torch.empty_like(q2) for _ in range(p)]
    dist.all_gather(gathered, q2, group=group)
    out = torch.cat(gathered)[:n].float() * scale2
    return out.reshape(shape), new_error


def _dtensor_psum(g, group, error):
    """:func:`compressed_psum` of a ``DTensor`` gradient over the mesh dim
    whose group is ``group`` (the reference's ``shard_map`` manual on
    ``'pod'``): the gradient, replicated over that dim (each pod's own),
    has its pending sums on the other dims reduced to the error buffer's
    layout (the parameter's), and each rank's local shard goes through
    the int8 reduction over ``group``.  The results are laid out as the
    parameter."""
    from repro_torch.models.layers import from_local
    mesh = g.device_mesh
    if not any(mesh.get_group(i) == group for i in range(mesh.ndim)):
        raise ValueError("the int8 reduction's group is no dim of the "
                         "gradients' mesh")
    g = g.redistribute(mesh, error.placements)
    out, err = compressed_psum(g.to_local(), group, error.to_local())
    return (from_local(out, mesh, error.placements, g.shape),
            from_local(err, mesh, error.placements, g.shape))


def tree_compressed_psum(grads, group=None, errors=None):
    """:func:`compressed_psum` leaf by leaf over a gradient tree.  Returns
    ``(g_avg, new_errors)``, the errors bf16 as in the reference (zeros
    when ``errors`` is None).  ``DTensor`` leaves (with their errors) are
    reduced over the mesh dim of ``group`` (:func:`_dtensor_psum`)."""
    from repro_torch.models.layers import is_dtensor
    leaves, spec = pytree.tree_flatten(grads)
    if errors is None:
        errs = [torch.zeros(g.shape, dtype=torch.bfloat16, device=g.device)
                for g in leaves]
    else:
        errs = spec.flatten_up_to(errors)
    avg, new_errs = [], []
    for g, e in zip(leaves, errs):
        a, err = (_dtensor_psum if is_dtensor(g) else compressed_psum)(
            g, group, e)
        avg.append(a)
        # cast as it comes: one fp32 residual alive at a time
        new_errs.append(err.to(torch.bfloat16))
    return (pytree.tree_unflatten(avg, spec),
            pytree.tree_unflatten(new_errs, spec))
