"""A Mamba2 decode step's recurrence in one launch: the Hopper kernel, its
wrapper and its plain PyTorch version.

It replaces no Pallas kernel: the reference's SSM decode
(``repro/models/layers.py`` ``ssm_decode``) is plain jnp that XLA fuses,
where the port's op-by-op step (``layers.ssm_decode``, then
``transformer._store``) runs ~20 kernels a layer and passes over the whole
fp32 state five times.  The CUDA source is ``csrc/ssm_decode.cu``; its
header note says what bounds the kernel on an H100 (the state's bytes, read
once and written once) and what its design does about it.

:func:`ssm_decode` takes the pre-conv ``xbc`` (B, conv_dim) and ``dt_raw``
(B, nh) straight from the in-projection, the layer's conv window
(B, d_conv − 1, conv_dim) and fp32 state (B, nh, hd, ds), and the mixer's
conv weight and bias, ``dt_bias``, ``A_log`` and ``D``.  In one call it
does what ``layers.ssm_decode`` does between the in-projection and the
gating: the conv window's step and SiLU, the window shifted in place, dt
and dA, the state updated in place, and y = C·h + D·x in fp32, rounded once
to ``xbc``'s type.  It returns y (B, 1, nh·hd).  The window's type is the
arithmetic's (the op-by-op step's promotion of the window and ``xbc``): a
window narrower than ``xbc`` raises, so the caller widens the cache entry
first, as ``transformer._store`` would.  By the device the tensors lie on:

* CPU — the plain version (:func:`plain`), the op-by-op step's PyTorch ops,
  its results written in place;
* CUDA — the kernel, on an sm_90 card only; anything else raises;
* any other device, or a ``DTensor`` — raises.

There is no fallback: a CUDA tensor never takes the plain version.

:data:`LAUNCHES` counts the kernel's launches (not the plain version's
calls), so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.build import LaunchCounter

LAUNCHES = {"ssm_decode": LaunchCounter(("ssm_decode_kernel",))}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's template instances: one a value the port's configurations use
D_STATES = (16, 128)
HEAD_DIMS = (16, 64)
MAX_D_CONV = 8


def _is_dtensor(t) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _check(xbc, dt_raw, conv_state, ssm_state, conv_w, conv_b, dt_bias,
           A_log, D, n_groups) -> None:
    tensors = (xbc, dt_raw, conv_state, ssm_state, conv_w, conv_b, dt_bias,
               A_log, D)
    if any(_is_dtensor(t) for t in tensors):
        raise TypeError("the SSM decode kernel takes plain tensors, not "
                        "DTensors: a sharded cache decodes with impl='dense'")
    if ssm_state.dim() != 4 or conv_state.dim() != 3:
        raise ValueError(f"ssm_state (B,nh,hd,ds) and conv_state "
                         f"(B,d_conv-1,conv_dim), got "
                         f"{tuple(ssm_state.shape)}, "
                         f"{tuple(conv_state.shape)}")
    b, nh, hd, ds = ssm_state.shape
    if ds not in D_STATES or hd not in HEAD_DIMS:
        raise ValueError(f"d_state {ds} and head_dim {hd}: the kernel takes "
                         f"d_state in {D_STATES} and head_dim in {HEAD_DIMS}")
    if n_groups < 1 or nh % n_groups:
        raise ValueError(f"{nh} heads do not split into {n_groups} groups")
    # the shapes csrc/ssm_decode.cu's plan() refuses, on every device: a
    # cluster of up to 16 blocks a group (a power of two up to its heads),
    # a block's heads' x, dt, dA and D and the group's B and C in 48 KiB
    rep = nh // n_groups
    c = 1 << min(4, rep.bit_length() - 1)
    if -(-rep // c) * (hd + 3) + 2 * ds > 48 * 1024 // 4:
        raise ValueError(f"{rep} heads a group do not fit a block's shared "
                         f"memory")
    k1, conv_dim = conv_state.shape[1], nh * hd + 2 * n_groups * ds
    if (conv_state.shape != (b, k1, conv_dim)
            or not 1 <= k1 < MAX_D_CONV):
        raise ValueError(f"conv_state {tuple(conv_state.shape)} does not fit "
                         f"ssm_state {tuple(ssm_state.shape)} and {n_groups} "
                         f"groups: (B, d_conv-1 < {MAX_D_CONV}, {conv_dim})")
    if xbc.shape != (b, conv_dim) or dt_raw.shape != (b, nh):
        raise ValueError(f"xbc {tuple(xbc.shape)} and dt_raw "
                         f"{tuple(dt_raw.shape)} must be ({b}, {conv_dim}) "
                         f"and ({b}, {nh})")
    if conv_w.shape != (k1 + 1, conv_dim) or conv_b.shape != (conv_dim,):
        raise ValueError(f"conv_w {tuple(conv_w.shape)} and conv_b "
                         f"{tuple(conv_b.shape)} must be ({k1 + 1}, "
                         f"{conv_dim}) and ({conv_dim},)")
    if any(t.shape != (nh,) for t in (dt_bias, A_log, D)):
        raise ValueError(f"dt_bias, A_log and D must be ({nh},)")
    if ssm_state.dtype != torch.float32 or any(
            t.dtype != torch.float32 for t in (dt_bias, A_log, D)):
        raise TypeError("the state, dt_bias, A_log and D are fp32")
    if xbc.dtype not in _DTYPE_CODE or conv_state.dtype not in _DTYPE_CODE:
        raise TypeError(f"xbc and the conv window are fp32 or bf16, got "
                        f"{xbc.dtype}, {conv_state.dtype}")
    if torch.promote_types(conv_state.dtype, xbc.dtype) != conv_state.dtype:
        raise TypeError(f"a {conv_state.dtype} conv window is narrower than "
                        f"{xbc.dtype} xbc: widen the cache entry first")
    if any(t.dtype != xbc.dtype for t in (dt_raw, conv_w, conv_b)):
        raise TypeError(f"dt_raw, conv_w and conv_b must be {xbc.dtype}, as "
                        f"xbc is")
    if not (ssm_state.is_contiguous() and conv_state.is_contiguous()):
        raise ValueError("the state and the conv window must be contiguous: "
                         "the kernel updates them in place")
    if xbc.stride(-1) != 1 or dt_raw.stride(-1) != 1:
        raise ValueError("xbc's and dt_raw's rows must be contiguous")
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"the inputs lie on {sorted(map(str, devs))}")


def step(xbc, dt_raw, conv_state, ssm_state, conv_w, conv_b, dt_bias,
         A_log, D, *, n_groups: int):
    """The Mamba2 decode step's recurrence op by op, on new tensors: the
    arithmetic of ``layers.ssm_decode`` between the in-projection and the
    gating, and the one the kernel does.  Returns (y (B,1,nh·hd) in
    ``xbc``'s type, the new fp32 state, the shifted window in the
    promotion of the window's type and ``xbc``'s).  Takes plain tensors or
    ``DTensor``s and checks nothing."""
    b, nh, hd, ds = ssm_state.shape
    d_in = nh * hd
    dtype = torch.promote_types(conv_state.dtype, xbc.dtype)
    window = torch.cat([conv_state.to(dtype), xbc[:, None, :].to(dtype)], 1)
    out = torch.einsum("bkc,kc->bc", window, conv_w.to(dtype)) + conv_b
    xbc_t = out * torch.sigmoid(out)                       # layers.silu
    xh, B_, C_ = torch.split(xbc_t, [d_in, n_groups * ds, n_groups * ds],
                             dim=-1)
    xh = xh.reshape(b, nh, hd)
    rep = nh // n_groups
    B_ = B_.reshape(b, n_groups, ds).repeat_interleave(rep, dim=1)
    C_ = C_.reshape(b, n_groups, ds).repeat_interleave(rep, dim=1)
    dt = F.softplus(dt_raw.float() + dt_bias)
    dA = torch.exp(dt * -torch.exp(A_log))                 # (B,nh)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt, xh.float(), B_.float())
    new_state = dA[:, :, None, None] * ssm_state + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, C_.float())
    y = y + xh.float() * D[None, :, None]
    return y.reshape(b, 1, d_in).to(xbc.dtype), new_state, window[:, 1:]


def plain(xbc, dt_raw, conv_state, ssm_state, conv_w, conv_b, dt_bias,
          A_log, D, *, n_groups: int):
    """The kernel's plain version: :func:`step`, with the new state and the
    shifted window written over ``ssm_state`` and ``conv_state``.  Returns
    y (B, 1, nh·hd) in ``xbc``'s type."""
    y, new_state, new_conv = step(xbc, dt_raw, conv_state, ssm_state,
                                  conv_w, conv_b, dt_bias, A_log, D,
                                  n_groups=n_groups)
    ssm_state.copy_(new_state)
    conv_state.copy_(new_conv)
    return y


def tolerance(want):
    """How far the kernel's result may lie from :func:`plain`'s ``want``,
    element by element: the d_state sum and the conv's terms in another
    order; where ``want`` is bf16 a conv output may also round the other
    way (2^-8 of it), and y is rounded once more."""
    w = want.float().abs()
    if want.dtype == torch.bfloat16:
        return 2.0 ** -6 * w + 2.0 ** -7 * w.max()
    return 1e-5 * w + 1e-5 * w.max()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, l_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.ssm_decode_error_string.argtypes = [i]
    lib.ssm_decode_error_string.restype = ctypes.c_char_p
    lib.ssm_decode_fwd.argtypes = [i, i, i, p, l_, p, l_, p, p, p, p, p, p,
                                   p, p, i, i, i, i, p]
    lib.ssm_decode_fwd.restype = i
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return _bind(build.library("ssm_decode"))


def launch(xbc, dt_raw, conv_state, ssm_state, conv_w, conv_b, dt_bias,
           A_log, D, *, n_groups: int):
    """Launch the kernel on CUDA inputs (counted in :data:`LAUNCHES`);
    returns what :func:`plain` returns, and updates the state and the
    window in place."""
    _check(xbc, dt_raw, conv_state, ssm_state, conv_w, conv_b, dt_bias,
           A_log, D, n_groups)
    return _launch(xbc, dt_raw, conv_state, ssm_state, conv_w, conv_b,
                   dt_bias, A_log, D, n_groups=n_groups)


def _launch(xbc, dt_raw, conv_state, ssm_state, conv_w, conv_b, dt_bias,
            A_log, D, *, n_groups: int):
    """:func:`launch` on inputs :func:`_check` has passed."""
    dev = xbc.device
    if dev.type != "cuda":
        raise ValueError(f"launch needs CUDA tensors, got {dev}")
    build.require_hopper(dev, "SSM decode")
    b, nh, hd, ds = ssm_state.shape
    out_dtype, dtype = xbc.dtype, conv_state.dtype
    # the op-by-op step's promotion: the arithmetic in the window's type
    xbc, dt_raw, conv_w, conv_b = (t.to(dtype) for t in
                                   (xbc, dt_raw, conv_w, conv_b))
    conv_w, conv_b = conv_w.contiguous(), conv_b.contiguous()
    if ssm_state.data_ptr() % 16:
        raise ValueError("the kernel moves the state in 16-byte pieces: it "
                         "must start on a 16-byte boundary")
    out = torch.empty((b, nh * hd), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().ssm_decode_fwd(
            _DTYPE_CODE[dtype], ds, hd, xbc.data_ptr(), xbc.stride(0),
            dt_raw.data_ptr(), dt_raw.stride(0), conv_state.data_ptr(),
            ssm_state.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
            dt_bias.data_ptr(), A_log.data_ptr(), D.data_ptr(),
            out.data_ptr(), b, nh, n_groups, conv_state.shape[1] + 1, stream)
    if err != 0:
        raise RuntimeError(
            f"SSM decode kernel launch failed: CUDA error {err} "
            f"({_library().ssm_decode_error_string(err).decode()})")
    LAUNCHES["ssm_decode"].incr()
    return out.reshape(b, 1, nh * hd).to(out_dtype)


def ssm_decode(xbc, dt_raw, conv_state, ssm_state, conv_w, conv_b, dt_bias,
               A_log, D, *, n_groups: int):
    """xbc (B,conv_dim) pre-conv and dt_raw (B,nh) from the in-projection;
    conv_state (B,d_conv-1,conv_dim) and ssm_state (B,nh,hd,ds) fp32, both
    updated in place -> y (B,1,nh·hd) in xbc's type."""
    _check(xbc, dt_raw, conv_state, ssm_state, conv_w, conv_b, dt_bias,
           A_log, D, n_groups)
    dev = xbc.device.type
    if dev == "cpu":
        return plain(xbc, dt_raw, conv_state, ssm_state, conv_w, conv_b,
                     dt_bias, A_log, D, n_groups=n_groups)
    if dev == "cuda":
        return _launch(xbc, dt_raw, conv_state, ssm_state, conv_w, conv_b,
                       dt_bias, A_log, D, n_groups=n_groups)
    raise ValueError(f"the SSM decode runs on CPU (plain version) or CUDA "
                     f"tensors, got {xbc.device}")
