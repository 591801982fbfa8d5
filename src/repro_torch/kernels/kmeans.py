"""k-means assignment and fused assign+update: the Hopper kernel, its
wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel of ``repro/kernels/kmeans.py``
(``_make_kernel`` behind ``pl.pallas_call`` at :196), in both of its forms:

* :func:`kmeans_assign` — ids + distances (``_make_kernel(fused=False)``);
* :func:`kmeans_assign_update` — the fused form that also returns the
  per-centroid sums and counts a mini-batch k-means step needs, with no
  second pass over the points (``_make_kernel(fused=True)``).

The CUDA source is ``csrc/kmeans.cu``; its header note says what bounds
the kernel on an H100 (device-memory bytes N·F·{4,2,1} + 8N for
fp32/bf16/int8 points; 2·N·K·F flops) and what the design does about it.

Each wrapper takes fp32 points (N,F) and centroids (K,F) and does one of
three things, by the device the tensors lie on:

* CPU — the plain version (:func:`plain`), the same arithmetic in PyTorch
  ops; the tests hold it against the JAX reference;
* CUDA — the kernel, on an sm_90 card only; anything else raises;
* any other device — raises.

There is no fallback: a CUDA tensor never takes the plain version.

Precision (``fp32`` | ``bf16`` | ``int8``) is the reference's axis.  The
wrapper prepares what the kernel reads (:func:`prepare`): bf16 points, or
int8 points with the shared per-feature scales of
:mod:`repro_torch.kernels.quant`; the centroids as the fp32 values of that
precision (bf16-rounded or dequantized) and their ``‖c‖²`` — exactly the
values the reference's wrapper feeds its kernel.  Every accumulation is
fp32.

:data:`LAUNCHES` counts the kernel launches of each entry point (not the
plain version's calls), so a run can show that its main path went through
the kernel.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import build, quant

PRECISIONS = ("fp32", "bf16", "int8")
_DTYPE_CODE = {"fp32": 0, "bf16": 1, "int8": 2}
# dynamic shared memory a block may take on sm_90 (227 KB)
MAX_SMEM_BYTES = 232_448


class LaunchCounter:
    """A thread-safe count of kernel launches."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def incr(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


LAUNCHES = {"kmeans_assign": LaunchCounter(),
            "kmeans_assign_update": LaunchCounter()}


@dataclass(frozen=True)
class Prepared:
    """The kernel's inputs: points in their storage type (fp32, bf16 or
    int8), the centroids' fp32 values at that precision, ``‖c‖²`` (K,),
    and the int8 scales (F,) or ``None``."""
    points: torch.Tensor
    centroids: torch.Tensor
    c2: torch.Tensor
    scales: Optional[torch.Tensor]
    precision: str


def _check(points: torch.Tensor, centroids: torch.Tensor,
           precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    if points.dim() != 2 or centroids.dim() != 2:
        raise ValueError(f"points (N,F) and centroids (K,F) must be 2-D, "
                         f"got {tuple(points.shape)} and "
                         f"{tuple(centroids.shape)}")
    if points.shape[1] != centroids.shape[1]:
        raise ValueError(f"feature widths differ: points "
                         f"{tuple(points.shape)}, centroids "
                         f"{tuple(centroids.shape)}")
    if centroids.shape[0] < 1:
        raise ValueError("need at least one centroid")
    if points.device != centroids.device:
        raise ValueError(f"points on {points.device}, centroids on "
                         f"{centroids.device}")
    if not (points.is_floating_point() and centroids.is_floating_point()):
        raise TypeError(f"points and centroids must be floating point, got "
                        f"{points.dtype} and {centroids.dtype}")


def prepare(points: torch.Tensor, centroids: torch.Tensor,
            precision: str = "fp32") -> Prepared:
    """What the kernel reads, made with PyTorch ops on the inputs' device
    (the counterpart of the reference wrapper's ``_call`` prologue)."""
    _check(points, centroids, precision)
    ptsf = points.float().contiguous()
    centf = centroids.float()
    scales = None
    if precision == "int8":
        scales = quant.symmetric_scales(ptsf, centf)
        pts = quant.quantize(ptsf, scales)
        # c2 from the *rounded* centroid values the kernel computes with
        centv = quant.fake_quantize(centf, scales)
    elif precision == "bf16":
        pts = ptsf.to(torch.bfloat16)
        centv = centf.to(torch.bfloat16).float()
    else:
        pts = ptsf
        centv = centf
    centv = centv.contiguous()
    c2 = (centv * centv).sum(dim=1)
    return Prepared(pts.contiguous(), centv, c2, scales, precision)


def point_values(prep: Prepared) -> torch.Tensor:
    """The fp32 point values the kernel computes on."""
    if prep.scales is not None:
        return quant.dequantize(prep.points, prep.scales)
    return prep.points.float()


def plain(prep: Prepared, fused: bool):
    """The plain PyTorch version of the kernel on prepared inputs:
    ``(ids, dmin)``, plus ``(sums, counts)`` when ``fused``."""
    x = point_values(prep)
    c = prep.centroids
    x2 = (x * x).sum(dim=1, keepdim=True)
    d2 = torch.clamp_min(x2 - 2.0 * (x @ c.T) + prep.c2[None, :], 0.0)
    ids = torch.argmin(d2, dim=1)
    dmin = torch.sqrt(torch.gather(d2, 1, ids[:, None])[:, 0])
    if not fused:
        return ids.to(torch.int32), dmin
    k, f = c.shape
    sums = torch.zeros((k, f), dtype=torch.float32,
                       device=x.device).index_add_(0, ids, x)
    counts = torch.bincount(ids, minlength=k).float()
    return ids.to(torch.int32), dmin, sums, counts


def _require_hopper(device: torch.device) -> None:
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the k-means kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} has capability {cap}")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kmeans_smem_bytes.argtypes = [i, i]
    lib.kmeans_smem_bytes.restype = ctypes.c_size_t
    lib.kmeans_block_rows.argtypes = []
    lib.kmeans_block_rows.restype = i
    lib.kmeans_error_string.argtypes = [i]
    lib.kmeans_error_string.restype = ctypes.c_char_p
    lib.kmeans_assign.argtypes = [i, p, p, p, p, i, i, i, p, p, p]
    lib.kmeans_assign.restype = i
    lib.kmeans_assign_update.argtypes = [i, p, p, p, p, i, i, i,
                                         p, p, p, p, p, p, p]
    lib.kmeans_assign_update.restype = i
    return lib


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _bind(build.library("kmeans"))
        return _lib


def launch(prep: Prepared, fused: bool):
    """Launch the kernel on prepared CUDA inputs (counted in
    :data:`LAUNCHES`).  Returns what :func:`plain` returns."""
    pts = prep.points
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"launch needs CUDA tensors, got {dev}")
    _require_hopper(dev)
    n, f = pts.shape
    k = prep.centroids.shape[0]
    if n >= 2 ** 31 or k * f >= 2 ** 31:
        raise ValueError(f"shape ({n}, {f}, {k}) exceeds the kernel's "
                         f"32-bit row and element counts")
    lib = _library()
    smem = lib.kmeans_smem_bytes(f, k)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"K·F = {k}·{f} needs {smem} B of shared memory per block; "
            f"an sm_90 block has at most {MAX_SMEM_BYTES} B")
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    dmin = torch.empty(n, dtype=torch.float32, device=dev)
    if fused:
        sums = torch.zeros((k, f), dtype=torch.float32, device=dev)
        counts = torch.zeros(k, dtype=torch.float32, device=dev)
    if n == 0:                      # no rows: nothing to launch over
        return (ids, dmin, sums, counts) if fused else (ids, dmin)
    scales = None if prep.scales is None else prep.scales.data_ptr()
    args = (_DTYPE_CODE[prep.precision], pts.data_ptr(),
            prep.centroids.data_ptr(), prep.c2.data_ptr(), scales, n, f, k,
            ids.data_ptr(), dmin.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fused:
            nblocks = -(-n // lib.kmeans_block_rows())
            psums = torch.empty((nblocks, k, f), dtype=torch.float32,
                                device=dev)
            pcounts = torch.empty((nblocks, k), dtype=torch.float32,
                                  device=dev)
            err = lib.kmeans_assign_update(
                *args, psums.data_ptr(), pcounts.data_ptr(),
                sums.data_ptr(), counts.data_ptr(), stream)
        else:
            err = lib.kmeans_assign(*args, stream)
    if err != 0:
        raise RuntimeError(f"k-means kernel launch failed: CUDA error {err} "
                           f"({lib.kmeans_error_string(err).decode()})")
    LAUNCHES["kmeans_assign_update" if fused else "kmeans_assign"].incr()
    return (ids, dmin, sums, counts) if fused else (ids, dmin)


def _dispatch(points, centroids, precision: str, fused: bool):
    dev = points.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"the k-means kernels run on CPU (plain version) "
                         f"or CUDA tensors, got {points.device}")
    prep = prepare(points, centroids, precision)
    return plain(prep, fused) if dev == "cpu" else launch(prep, fused)


def kmeans_assign(points: torch.Tensor, centroids: torch.Tensor, *,
                  precision: str = "fp32"):
    """points (N,F), centroids (K,F) -> (ids (N,) int32, dmin (N,) f32)."""
    return _dispatch(points, centroids, precision, fused=False)


def kmeans_assign_update(points: torch.Tensor, centroids: torch.Tensor, *,
                         precision: str = "fp32"):
    """The fused hot path: ``(ids (N,), dmin (N,), sums (K,F) f32,
    counts (K,) f32)`` — the assignment *and* the per-centroid membership
    sums/counts a mini-batch k-means step needs, in one pass."""
    return _dispatch(points, centroids, precision, fused=True)
