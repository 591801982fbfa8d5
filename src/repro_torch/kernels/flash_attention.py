"""Forward flash attention (GQA, causal, sliding window): the Hopper
kernel, its wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel of ``repro/kernels/flash_attention.py``
(``_flash_kernel`` behind ``pl.pallas_call`` at :120, entry point
``flash_attention`` at :96).  The CUDA source is
``csrc/flash_attention.cu``, with one design per input type: fp32 on the
FMA pipes (register micro-tiles fed by a cp.async ring), bf16 on the tensor
cores (wgmma fed by a TMA ring, p carried as a bf16 hi/lo pair so the p·v
product keeps the reference's fp32 p).  Its header note says what bounds
the kernel on an H100 (4·D flops per unmasked (query, key) pair, an
operations bound at the serving path's shapes) and what each design does
about it.

:func:`flash_attention` takes q (B,Sq,H,D) and k/v (B,Sk,Hkv,D) in the
reference's layout, fp32 or bf16, H a multiple of Hkv and D a multiple of
16 up to 256, and does one of three things, by the device the tensors lie
on:

* CPU — the plain version (:func:`plain`), the same online softmax over key
  blocks in PyTorch ops; the tests hold it against the JAX reference;
* CUDA — the kernel, on an sm_90 card only; anything else raises;
* any other device — raises.

There is no fallback: a CUDA tensor never takes the plain version.  A row
whose keys are all masked gives 0, as in the reference.

:data:`LAUNCHES` counts the kernel's launches (not the plain version's
calls), so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import MAX_SMEM_BYTES, LaunchCounter

# a launch runs one of these kernels of csrc/flash_attention.cu
LAUNCHES = {"flash_attention": LaunchCounter(("flash_f32", "flash_bf16"))}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# keys per step of the plain version's online softmax
PLAIN_BLOCK_K = 512


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q (B,Sq,H,D) and k/v (B,Sk,Hkv,D) must be 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"{h} query heads do not group over {k.shape[2]} "
                         f"kv heads")
    if d % 16 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one type of fp32 or bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True, window: Optional[int] = None,
          block_k: int = PLAIN_BLOCK_K,
          pv_type: torch.dtype = torch.float32,
          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: an fp32 online softmax over
    key blocks of ``block_k``, GQA by grouping the query heads (no repeated
    k/v), the reference's masks and its fully-masked-row guards; the
    scores times ``scale`` (None: 1/√D).  The softmax and v meet in
    ``pv_type``: fp32 for the kernel, v's type for the model's chunked
    attention, as the reference's does."""
    b, sq, h, d = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    rep = h // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, sq, hkv, rep, d)
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, rep, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, rep, sq), device=q.device)
    acc = torch.zeros((b, hkv, rep, sq, dv), device=q.device)
    for k0 in range(0, sk, block_k):
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k].to(pv_type)
        kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)[None, :]
        keep = torch.ones((sq, kb.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            keep = keep & (kpos <= qpos)
        if window is not None:
            keep = keep & (kpos > qpos - window)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb) * scale
        s = s.masked_fill(~keep, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(s == float("-inf"), 0.0, p)
        corr = torch.exp(torch.where(m == float("-inf"), 0.0, m) - m_safe)
        corr = torch.where(m == float("-inf"), 0.0, corr)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p.to(pv_type), vb).float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_smem_bytes.argtypes = [i, i]
    lib.flash_smem_bytes.restype = ctypes.c_size_t
    lib.flash_error_string.argtypes = [i]
    lib.flash_error_string.restype = ctypes.c_char_p
    lib.flash_attention_fwd.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, i,
                                        ctypes.c_float, p]
    lib.flash_attention_fwd.restype = i
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return _bind(build.library("flash_attention"))


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: Optional[int] = None,
           scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel on CUDA inputs (counted in :data:`LAUNCHES`);
    returns what :func:`plain` returns.  ``scale`` None passes 0, for
    which the kernel takes 1/√D itself."""
    _check(q, k, v, window)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"launch needs CUDA tensors, got {dev}")
    build.require_hopper(dev, "flash-attention")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if max(q.numel(), k.numel()) >= 2 ** 31 or sq >= 2 ** 31 // 64:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)} exceed "
                         f"the kernel's 32-bit counts")
    lib = _library()
    smem = lib.flash_smem_bytes(_DTYPE_CODE[q.dtype], d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"head_dim {d} needs {smem} B of shared memory per "
                         f"block; an sm_90 block has at most "
                         f"{MAX_SMEM_BYTES} B")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, sq, sk, h, hkv, d, int(causal),
            0 if window is None else int(window),
            0.0 if scale is None else float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA error "
                           f"{err} ({lib.flash_error_string(err).decode()})")
    LAUNCHES["flash_attention"].incr()
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Sq,H,D); k/v (B,Sk,Hkv,D) -> (B,Sq,H,D) in q's type; scores
    times ``scale`` (None: 1/√D)."""
    _check(q, k, v, window)
    if scale is not None and not scale > 0:
        raise ValueError(f"scale must be positive, got {scale}")
    dev = q.device.type
    if dev == "cpu":
        return plain(q, k, v, causal=causal, window=window, scale=scale)
    if dev == "cuda":
        return launch(q, k, v, causal=causal, window=window, scale=scale)
    raise ValueError(f"flash attention runs on CPU (plain version) or CUDA "
                     f"tensors, got {q.device}")
