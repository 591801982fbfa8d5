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
fp32/bf16/int8 points; 2·N·K·F flops) and what the design does about it:
persistent 128-row tiles staged by a cp.async ring, rows in registers
against centroids read as warp broadcasts, and the fused sums added per
warp into shared accumulators, then over blocks in a fixed order by a
second launch.  The fused outputs are the same bits on every launch on
one card; the last bits of ``sums`` depend on the grid, which follows the
card's SM count (:func:`geometry`).

Shapes: the centroids, padded to multiples of 32 in K and F, an
accumulator copy of the same size (fused form) and a staging slot of
128 rows must fit in a block's 227 KB of shared memory.  That takes every
K ≤ 128 with F ≤ 128, and fp32 points up to K = 800 at F = 32 or K = 160
at F = 128 in the fused form (1,632 and 320 assign-only); wider shapes
raise a ``ValueError`` naming shared memory.  (The kernel's first version,
with 256-row tiles and no accumulator copies, took the fused form up to
about K = 1,495 at F = 32 and K = 191 at F = 128.)

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
import functools
import threading
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import build, quant
from repro_torch.kernels.build import MAX_SMEM_BYTES, LaunchCounter

PRECISIONS = ("fp32", "bf16", "int8")
_DTYPE_CODE = {"fp32": 0, "bf16": 1, "int8": 2}
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


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kmeans_smem_bytes.argtypes = [i, i, i, i]
    lib.kmeans_smem_bytes.restype = ctypes.c_size_t
    lib.kmeans_tile_rows.argtypes = []
    lib.kmeans_tile_rows.restype = i
    lib.kmeans_block_threads.argtypes = []
    lib.kmeans_block_threads.restype = i
    lib.kmeans_max_grid.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.kmeans_max_grid.restype = i
    lib.kmeans_error_string.argtypes = [i]
    lib.kmeans_error_string.restype = ctypes.c_char_p
    lib.kmeans_assign.argtypes = [i, p, p, p, p, i, i, i, i, p, p, p]
    lib.kmeans_assign.restype = i
    lib.kmeans_assign_update.argtypes = [i, p, p, p, p, i, i, i, i,
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


def _raise(lib: ctypes.CDLL, err: int, what: str) -> None:
    raise RuntimeError(f"k-means kernel {what} failed: CUDA error {err} "
                       f"({lib.kmeans_error_string(err).decode()})")


@functools.cache
def _tile():
    """(rows a tile, warps a block), constants of the built kernel."""
    lib = _library()
    return lib.kmeans_tile_rows(), lib.kmeans_block_threads() // 32


@functools.lru_cache(maxsize=None)
def _max_grid(device_index: int, code: int, fused: bool, f: int,
              k: int) -> int:
    """SMs × resident blocks of one form at (f, k) on one card; raises the
    shared-memory ``ValueError`` where a block's layout does not fit."""
    lib = _library()
    smem = lib.kmeans_smem_bytes(code, int(fused), f, k)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"K·F = {k}·{f} needs {smem} B of shared memory per block; "
            f"an sm_90 block has at most {MAX_SMEM_BYTES} B")
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.kmeans_max_grid(code, int(fused), f, k, ctypes.byref(out))
    if err != 0:
        _raise(lib, err, "occupancy query")
    return out.value


def geometry(prep: Prepared, fused: bool):
    """``(grid, tile_rows, warps)`` of a launch on prepared CUDA inputs:
    blocks, rows a tile and warps a block.  Block b takes tiles b,
    b + grid, ...; the fused sums' longest chain of fp32 additions is at
    most ``ceil(tiles / grid) · tile_rows + warps + grid``."""
    n, f = prep.points.shape
    k = prep.centroids.shape[0]
    rows, warps = _tile()
    cap = _max_grid(prep.points.device.index or 0,
                    _DTYPE_CODE[prep.precision], fused, f, k)
    return min(-(-n // rows), cap), rows, warps


def launch(prep: Prepared, fused: bool):
    """Launch the kernel on prepared CUDA inputs (counted in
    :data:`LAUNCHES`).  Returns what :func:`plain` returns."""
    pts = prep.points
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"launch needs CUDA tensors, got {dev}")
    build.require_hopper(dev, "k-means")
    n, f = pts.shape
    k = prep.centroids.shape[0]
    if n >= 2 ** 31 or k * f >= 2 ** 31:
        raise ValueError(f"shape ({n}, {f}, {k}) exceeds the kernel's "
                         f"32-bit row and element counts")
    lib = _library()
    grid, _, _ = geometry(prep, fused)   # raises where K·F does not fit
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    dmin = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:                      # no rows: nothing to launch over
        if not fused:
            return ids, dmin
        return (ids, dmin, torch.zeros((k, f), dtype=torch.float32,
                                       device=dev),
                torch.zeros(k, dtype=torch.float32, device=dev))
    scales = None if prep.scales is None else prep.scales.data_ptr()
    args = (_DTYPE_CODE[prep.precision], pts.data_ptr(),
            prep.centroids.data_ptr(), prep.c2.data_ptr(), scales, n, f, k,
            grid, ids.data_ptr(), dmin.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fused:
            # the block partials (grid, k, f) and (grid, k) in one scratch
            # buffer; the sums (k, f) and counts (k) the second launch writes
            # in another
            scratch = torch.empty(grid * (k * f + k), dtype=torch.float32,
                                  device=dev)
            psums, pcounts = torch.split(scratch, [grid * k * f, grid * k])
            out = torch.empty(k * f + k, dtype=torch.float32, device=dev)
            sums, counts = out[:k * f].view(k, f), out[k * f:]
            err = lib.kmeans_assign_update(
                *args, psums.data_ptr(), pcounts.data_ptr(),
                sums.data_ptr(), counts.data_ptr(), stream)
        else:
            err = lib.kmeans_assign(*args, stream)
    if err != 0:
        _raise(lib, err, "launch")
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
