"""Mamba2 SSD scan: the Hopper kernel for the part inside each chunk, its
wrapper, its plain PyTorch version, and the recurrence across chunks.

Replaces the Pallas TPU kernel of ``repro/kernels/ssd.py`` (``_ssd_kernel``
behind ``pl.pallas_call`` at :92, entry point ``ssd_chunk_scan`` at :70).
The CUDA source is ``csrc/ssd.cu``; its header note says what bounds the
kernel on an H100 (ds·q(q+1) flops a chunk of each B/C group for ``C·Bᵀ``,
hd·q(q+1) a chunk of each head for the product with x, plus 2q·ds·hd for
its state: an operations bound at hymba-1.5b's widths) and what the design
does about it: work items of 64 output rows, register micro-tiles fed by a
cp.async ring, and the chunk state added during the y pass.

For each (batch, head, chunk) the kernel — or, on a CPU tensor, its plain
version :func:`chunk_plain` — computes ``cum = cumsum(dt·A)``, the chunk's
own output ``y = (C·Bᵀ ∘ L)·X + D·X`` with ``L[i,j] = exp(cum_i − cum_j)·dt_j``
for i ≥ j, and the chunk state ``Bᵀ·(exp(total − cum)·dt·X)``.  The
recurrence across chunks and the ``y_inter`` product stay in PyTorch, as
the reference keeps them outside its kernel (``ssd.py:120-137``): a Python
loop over the S/chunk chunks and one ``torch.einsum``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel on
an sm_90 card or raises; there is no fallback.  :data:`LAUNCHES` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import MAX_SMEM_BYTES, LaunchCounter

# a launch runs this kernel of csrc/ssd.cu
LAUNCHES = {"ssd_chunk_scan": LaunchCounter(("ssd_chunk_kernel",))}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 256
MAX_WIDTH = 256


def _check(xh, dt, A, B_, C_, D, chunk: int) -> None:
    if xh.dim() != 4 or dt.dim() != 3 or B_.dim() != 4 or C_.dim() != 4:
        raise ValueError(f"xh (B,S,nh,hd), dt (B,S,nh) and B/C (B,S,g,ds) "
                         f"expected, got {tuple(xh.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(B_.shape)}, "
                         f"{tuple(C_.shape)}")
    b, s, nh, hd = xh.shape
    g, ds = B_.shape[2], B_.shape[3]
    if dt.shape != (b, s, nh) or B_.shape != C_.shape or B_.shape[:2] != (b, s):
        raise ValueError("dt, B and C do not fit xh")
    if A.shape != (nh,) or D.shape != (nh,):
        raise ValueError(f"A {tuple(A.shape)} and D {tuple(D.shape)} must be "
                         f"({nh},)")
    if g < 1 or nh % g:
        raise ValueError(f"{nh} heads do not group over {g} B/C groups")
    if not 0 < chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"chunk {chunk} must divide S = {s} and be at most "
                         f"{MAX_CHUNK}")
    if not 0 < hd <= MAX_WIDTH or not 0 < ds <= MAX_WIDTH or ds % 4:
        raise ValueError(f"head_dim {hd} must be at most {MAX_WIDTH} and "
                         f"d_state {ds} a multiple of 4 up to {MAX_WIDTH}")
    if xh.dtype not in _DTYPE_CODE or B_.dtype != xh.dtype \
            or C_.dtype != xh.dtype:
        raise TypeError(f"xh, B and C must share one type of fp32 or bf16, "
                        f"got {xh.dtype}, {B_.dtype}, {C_.dtype}")
    devs = {t.device for t in (xh, dt, A, B_, C_, D)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")


def chunk_plain(xh, dt, A, B_, C_, D, chunk: int):
    """The kernel's function in PyTorch ops: ``(y, st, cum)`` with y
    (B,S,nh,hd) in xh's type (without ``y_inter``), st (B,nh,nc,ds,hd) and
    cum (B,nh,nc,chunk) fp32."""
    b, s, nh, hd = xh.shape
    g, ds = B_.shape[2], B_.shape[3]
    nc, rep = s // chunk, nh // g
    xc = xh.float().reshape(b, nc, chunk, nh, hd)
    dtc = dt.float().reshape(b, nc, chunk, nh)
    Bc = B_.float().reshape(b, nc, chunk, g, ds)
    Cc = C_.float().reshape(b, nc, chunk, g, ds)
    cum = torch.cumsum(dtc * A.float(), dim=2)                # (b,nc,q,nh)
    total = cum[:, :, -1, :]                                  # (b,nc,nh)
    ch = cum.permute(0, 1, 3, 2)                              # (b,nc,nh,q)
    keep = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=xh.device).tril()
    # mask before the exp: above the diagonal cum_i − cum_j > 0 can pass
    # fp32's exp range, and masking inf after it gives 0 · inf = NaN in
    # the backward (the reference's ssd_chunked does; ROADMAP C2)
    L = torch.exp(torch.where(keep, ch[..., :, None] - ch[..., None, :],
                              float("-inf"))) \
        * dtc.permute(0, 1, 3, 2)[..., None, :]
    G = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)            # (b,nc,g,q,q)
    M = G.repeat_interleave(rep, dim=2) * L                   # (b,nc,nh,q,q)
    y = torch.einsum("bchij,bcjhp->bcihp", M, xc)
    y = y + xc * D.float()[:, None]
    w = torch.exp(total[:, :, None, :] - cum) * dtc           # (b,nc,q,nh)
    BH = Bc.repeat_interleave(rep, dim=3)                     # (b,nc,q,nh,ds)
    st = torch.einsum("bcjhn,bcjhp->bhcnp", BH * w[..., None], xc)
    return (y.reshape(b, s, nh, hd).to(xh.dtype), st,
            cum.permute(0, 3, 1, 2).contiguous())


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_smem_bytes.argtypes = [i, i, i]
    lib.ssd_smem_bytes.restype = ctypes.c_size_t
    lib.ssd_error_string.argtypes = [i]
    lib.ssd_error_string.restype = ctypes.c_char_p
    lib.ssd_chunk_fwd.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                  p, p, p, p]
    lib.ssd_chunk_fwd.restype = i
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return _bind(build.library("ssd"))


def chunk_launch(xh, dt, A, B_, C_, D, chunk: int):
    """Launch the kernel on CUDA inputs (counted in :data:`LAUNCHES`);
    returns what :func:`chunk_plain` returns."""
    _check(xh, dt, A, B_, C_, D, chunk)
    dev = xh.device
    if dev.type != "cuda":
        raise ValueError(f"chunk_launch needs CUDA tensors, got {dev}")
    build.require_hopper(dev, "SSD")
    b, s, nh, hd = xh.shape
    g, ds = B_.shape[2], B_.shape[3]
    nc = s // chunk
    if max(xh.numel(), B_.numel(), b * nh * nc * ds * hd) >= 2 ** 31:
        raise ValueError(f"shapes {tuple(xh.shape)}, {tuple(B_.shape)} exceed "
                         f"the kernel's 32-bit counts")
    lib = _library()
    smem = lib.ssd_smem_bytes(_DTYPE_CODE[xh.dtype], hd, ds)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"head_dim {hd}, d_state {ds} need {smem} B of "
                         f"shared memory per block; an sm_90 block has at "
                         f"most {MAX_SMEM_BYTES} B")
    xh, B_, C_ = xh.contiguous(), B_.contiguous(), C_.contiguous()
    dt = dt.float().contiguous()
    A, D = A.float().contiguous(), D.float().contiguous()
    y = torch.empty_like(xh)
    st = torch.empty((b, nh, nc, ds, hd), dtype=torch.float32, device=dev)
    cum = torch.empty((b, nh, nc, chunk), dtype=torch.float32, device=dev)
    if xh.numel() == 0:
        return y, st, cum
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_chunk_fwd(
            _DTYPE_CODE[xh.dtype], xh.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B_.data_ptr(), C_.data_ptr(), D.data_ptr(), b, s, nh, hd, g, ds,
            chunk, y.data_ptr(), st.data_ptr(), cum.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"SSD kernel launch failed: CUDA error {err} "
                           f"({lib.ssd_error_string(err).decode()})")
    LAUNCHES["ssd_chunk_scan"].incr()
    return y, st, cum


def inter_chunk(y, st, cum, C_, chunk: int):
    """The recurrence across chunks and ``y_inter``, as the reference runs
    them outside its kernel.  Returns (y (B,S,nh,hd) in y's type, final
    state (B,nh,hd,ds) fp32)."""
    b, s, nh, hd = y.shape
    g, ds = C_.shape[2], C_.shape[3]
    nc, rep = s // chunk, nh // g
    total = cum[..., chunk - 1]                               # (b,nh,nc)
    state = torch.zeros((b, nh, ds, hd), dtype=torch.float32, device=y.device)
    prev = []
    for c in range(nc):
        prev.append(state)                                    # before chunk c
        state = torch.exp(total[:, :, c])[..., None, None] * state \
            + st[:, :, c]
    prev_states = torch.stack(prev, dim=2)                    # (b,nh,nc,ds,hd)
    Cc = C_.float().reshape(b, nc, chunk, g, ds)
    y_inter = torch.einsum("bcign,bgrcnp->bcigrp", Cc,
                           prev_states.reshape(b, g, rep, nc, ds, hd))
    decay = torch.exp(cum).reshape(b, g, rep, nc, chunk).permute(0, 3, 4, 1, 2)
    y_inter = (y_inter * decay[..., None]).reshape(b, s, nh, hd)
    return y + y_inter.to(y.dtype), state.transpose(-1, -2)


def ssd_chunk_scan(xh, dt, A, B_, C_, D, *, chunk: int = 256):
    """Full SSD pass: the chunk kernel (or its plain version on a CPU
    tensor) and the inter-chunk recurrence.  xh (B,S,nh,hd); dt (B,S,nh)
    post-softplus; A (nh,) negative; B_/C_ (B,S,g,ds); D (nh,).  Returns
    (y (B,S,nh,hd), final_state (B,nh,hd,ds)).  A bf16 y is rounded twice,
    after the chunk's own part and again after ``y_inter`` is added, as the
    reference's Pallas entry point ``ssd_chunk_scan`` rounds it (the
    model's ``layers.ssd_chunked`` rounds once)."""
    _check(xh, dt, A, B_, C_, D, chunk)
    dev = xh.device.type
    if dev == "cpu":
        parts = chunk_plain(xh, dt, A, B_, C_, D, chunk)
    elif dev == "cuda":
        parts = chunk_launch(xh, dt, A, B_, C_, D, chunk)
    else:
        raise ValueError(f"the SSD scan runs on CPU (plain version) or CUDA "
                         f"tensors, got {xh.device}")
    return inter_chunk(*parts, C_, chunk)
