"""A decode step's attention core in one launch: the Hopper kernel, its
wrapper and its plain PyTorch version.

It replaces no Pallas kernel: the reference's decode attention
(``repro/models/layers.py`` ``gqa_decode`` and ``attention_decode``) is
plain jnp that XLA fuses, where the port's op-by-op step
(``layers.gqa_decode``) runs ~37 kernels a layer and copies the whole cache
twice.  The CUDA source is ``csrc/decode_attention.cu``; its header note
says what bounds the kernel on an H100 (the valid cache's bytes) and what
its design does about it.

:func:`decode_attention` takes the unroped q (B, H, D) and k, v (B, Hkv, D)
straight from the weight products, the (B, S, Hkv, D) caches, the position
``length`` and the RoPE tables, and does in one call what
:func:`ring_slot`, two ``apply_rope``, two ``write_slot`` and
``attention_decode`` do in turn: the rope of q and k, the new k and v
written at the slot (``length % S`` in a ring buffer, else ``length``), and
attention over the valid keys (``min(length + 1, S)``, else ``length + 1``)
with the same casts (fp32 scores over the widened cache, the softmax
rounded to the cache's type before p·v, the output rounded to it).  It
returns (B, 1, H·D) in the type ``gqa_decode`` multiplies by ``wo``:
fp32, or bf16 where the inputs and the cache are both bf16.  By the
device the tensors lie on:

* CPU — the plain version (:func:`plain`), the same arithmetic in PyTorch
  ops over the valid keys only;
* CUDA — the kernel, on an sm_90 card only; anything else raises;
* any other device, or a ``DTensor`` — raises.

There is no fallback: a CUDA tensor never takes the plain version.

:data:`LAUNCHES` counts the kernel's launches (not the plain version's
calls), so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
import sys

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import MAX_SMEM_BYTES, LaunchCounter

LAUNCHES = {"decode_attention": LaunchCounter(("decode_attention_kernel",))}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# query heads a kv group: the kernel's widest template instance
MAX_REP = 16


def _is_dtensor(t) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def out_dtype(q_dtype, cache_dtype) -> torch.dtype:
    """The output's type: the cache's rounding, held in the type the
    output projection takes (``gqa_decode``'s promotion)."""
    return torch.promote_types(cache_dtype, q_dtype)


def _check(q, k, v, k_cache, v_cache, length, cos, sin, scale=None) -> None:
    tensors = (q, k, v, k_cache, v_cache, length, cos, sin)
    if any(_is_dtensor(t) for t in tensors):
        raise TypeError("decode attention takes plain tensors, not DTensors: "
                        "a sharded cache decodes with impl='dense'")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q (B,H,D), k/v (B,Hkv,D) and caches (B,S,Hkv,D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(k_cache.shape)}")
    b, h, d = q.shape
    hkv = k_cache.shape[2]
    if (k.shape != (b, hkv, d) or v.shape != k.shape
            or k_cache.shape != (b, k_cache.shape[1], hkv, d)
            or v_cache.shape != k_cache.shape):
        raise ValueError(f"k {tuple(k.shape)}, v {tuple(v.shape)} and caches "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if h % hkv or not h // hkv <= MAX_REP:
        raise ValueError(f"{h} query heads over {hkv} kv heads: a group "
                         f"takes 1 to {MAX_REP} query heads")
    if d % 16 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one type of fp32 or bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k_cache.dtype not in _DTYPE_CODE or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"the caches must share one type of fp32 or bf16, got "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if (cos is None) != (sin is None):
        raise ValueError("cos and sin go together")
    if scale is not None and not scale > 0:
        raise ValueError(f"scale must be positive, got {scale}")
    if cos is not None and (cos.shape[-1] != d // 2 or cos.numel() not in
                            (d // 2, b * d // 2) or sin.shape != cos.shape):
        raise ValueError(f"cos/sin {tuple(cos.shape)} must hold 1 or {b} rows "
                         f"of {d // 2}")
    devs = {t.device for t in tensors if torch.is_tensor(t)}
    if len(devs) != 1:
        raise ValueError(f"the inputs lie on {sorted(map(str, devs))}")


def ring_slot(length, size: int, ring: bool):
    """(write_idx, valid_len) of position ``length`` in a cache of
    ``size`` slots: ``length % size`` and ``min(length + 1, size)`` in a
    ring buffer, else ``length`` and ``length + 1``.  On the device for a
    tensor ``length``, in Python for an int.  The kernel derives the same
    pair from the position on the device."""
    if ring:
        if torch.is_tensor(length):
            return length % size, torch.clamp_max(length + 1, size)
        return length % size, min(length + 1, size)
    return length, length + 1


def _rope(x, cos, sin):
    """``layers.apply_rope`` on (B, heads, D) x with (1 or B, D/2) tables:
    rotate-half in fp32, the result in x's type."""
    cos = cos.reshape(-1, 1, cos.shape[-1]).float()
    sin = sin.reshape(-1, 1, sin.shape[-1]).float()
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def plain(q, k, v, k_cache, v_cache, length, cos, sin, *, ring: bool,
          scale=None):
    """The kernel's arithmetic in PyTorch ops, over the valid keys only
    (the position is read on the host): the rope, the slot written in
    place, fp32 scores over the widened cache divided by √D (or times
    ``scale``), the softmax
    in fp32 rounded to the cache's type, p·v summed in fp32 and rounded to
    the cache's type.  Returns (B, 1, H·D) in :func:`out_dtype`."""
    b, h, d = q.shape
    size, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    widx, valid = ring_slot(int(length), size, ring)
    if not 0 <= widx < size:
        raise IndexError(f"position {int(length)} past the cache's {size} "
                         f"slots")
    if cos is not None:
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)
    k_cache[:, widx] = k.to(k_cache.dtype)
    v_cache[:, widx] = v.to(v_cache.dtype)
    qg = q.float().reshape(b, hkv, rep, d)
    scores = torch.einsum("bgrd,bkgd->bgrk", qg, k_cache[:, :valid].float())
    scores = scores / math.sqrt(d) if scale is None else scores * scale
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bgrk,bkgd->bgrd", p.float(),
                     v_cache[:, :valid].float()).to(v_cache.dtype)
    return o.reshape(b, 1, h * d).to(out_dtype(q.dtype, v_cache.dtype))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_smem.argtypes = [i, i, i, i, i, i, i,
                                          ctypes.POINTER(i)]
    lib.decode_attention_smem.restype = ctypes.c_size_t
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    lib.decode_attention_fwd.argtypes = [i, i, p, p, p, p, p, p, i, p, p, i,
                                         i, i, i, i, i, i, ctypes.c_float, p,
                                         p]
    lib.decode_attention_fwd.restype = i
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return _bind(build.library("decode_attention"))


@functools.cache
def _plan(cache_code: int, q_code: int, b: int, s: int, hkv: int, rep: int,
          d: int):
    """(shared memory a block, cluster size) of a launch at these shapes."""
    cluster = ctypes.c_int(0)
    smem = _library().decode_attention_smem(cache_code, q_code, b, s, hkv,
                                            rep, d, ctypes.byref(cluster))
    return smem, cluster.value


def launch(q, k, v, k_cache, v_cache, length, cos, sin, *, ring: bool,
           scale=None):
    """Launch the kernel on CUDA inputs (counted in :data:`LAUNCHES`);
    returns what :func:`plain` returns, and updates the caches in place.
    ``length`` is a 0-d int32 or int64 tensor on the card (an int is
    copied there); ``scale`` None passes 0, for which the kernel takes
    1/√D itself."""
    _check(q, k, v, k_cache, v_cache, length, cos, sin, scale)
    return _launch(q, k, v, k_cache, v_cache, length, cos, sin, ring=ring,
                   scale=scale)


def _launch(q, k, v, k_cache, v_cache, length, cos, sin, *, ring: bool,
            scale=None):
    """:func:`launch` on inputs :func:`_check` has passed."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"launch needs CUDA tensors, got {dev}")
    build.require_hopper(dev, "decode-attention")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("the caches must be contiguous: the kernel writes "
                         "the new slot in place")
    if not torch.is_tensor(length):
        length = torch.tensor(int(length), device=dev)
    if length.dtype not in (torch.int32, torch.int64) or length.numel() != 1:
        raise TypeError(f"length must be one int32 or int64, got "
                        f"{length.dtype} {tuple(length.shape)}")
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.numel() >= 2 ** 31:
        raise ValueError(f"cache {tuple(k_cache.shape)} exceeds the kernel's "
                         f"32-bit counts")
    codes = (_DTYPE_CODE[k_cache.dtype], _DTYPE_CODE[q.dtype])
    smem, _ = _plan(*codes, b, s, hkv, h // hkv, d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"the scores of {h // hkv} query heads over {s} "
                         f"slots need {smem} B of shared memory a block in "
                         f"the largest cluster; an sm_90 block has at most "
                         f"{MAX_SMEM_BYTES} B")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if cos is not None:
        cos, sin = (t.float().reshape(-1, d // 2).contiguous()
                    for t in (cos, sin))
    if any(t.data_ptr() % 16 for t in (q, k, v, k_cache, v_cache, cos, sin)
           if t is not None):
        raise ValueError("the kernel copies its inputs in 16-byte pieces: "
                         "every input must start on a 16-byte boundary")
    out = torch.empty((b, 1, h * d), dtype=out_dtype(q.dtype, k_cache.dtype),
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().decode_attention_fwd(
            *codes, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), length.data_ptr(),
            int(length.dtype == torch.int64),
            None if cos is None else cos.data_ptr(),
            None if sin is None else sin.data_ptr(),
            0 if cos is None else cos.shape[0], int(ring), b, s, hkv,
            h // hkv, d, 0.0 if scale is None else float(scale),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"decode-attention kernel launch failed: CUDA error {err} "
            f"({_library().decode_attention_error_string(err).decode()})")
    LAUNCHES["decode_attention"].incr()
    return out


def decode_attention(q, k, v, k_cache, v_cache, length, cos, sin, *,
                     ring: bool, scale=None):
    """q (B,H,D), k/v (B,Hkv,D) unroped; caches (B,S,Hkv,D), written at
    the slot in place; ``length`` the position (an int or a 0-d tensor);
    cos/sin (1 or B, …, D/2) or None; scores times ``scale`` (None: 1/√D)
    -> (B,1,H·D)."""
    _check(q, k, v, k_cache, v_cache, length, cos, sin, scale)
    dev = q.device.type
    if dev == "cpu":
        return plain(q, k, v, k_cache, v_cache, length, cos, sin, ring=ring,
                     scale=scale)
    if dev == "cuda":
        return _launch(q, k, v, k_cache, v_cache, length, cos, sin,
                       ring=ring, scale=scale)
    raise ValueError(f"decode attention runs on CPU (plain version) or CUDA "
                     f"tensors, got {q.device}")
