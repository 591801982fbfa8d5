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
persistent tiles staged by a cp.async ring, rows in registers against
centroids read as warp broadcasts, and the fused sums added per warp into
shared accumulators, then over blocks in a fixed order by a second launch.
The fused outputs are the same bits on every launch on one card; the last
bits of ``sums`` depend on the grid, which follows the card's SM count and
the tile (:func:`geometry`).  ``ids`` and ``dmin`` are the same bits in
every tile.

The tile (``block_n``: 64, 128 or 256 rows, 128 by default) is the
reference's ``block_n`` axis: the library holds an instance of the kernel
for each (:data:`TILES`) and takes the tile as an argument, a block has
``block_n / 2`` threads, and :func:`autotune_block_n` picks one by timing
them.  The CPU's plain version ignores it, as the reference's interpret
path gives the same results at every ``block_n``.

Shapes: the centroids, padded to multiples of 32 in K and F, an
accumulator copy of the same size (fused form) and a staging slot of one
tile must fit in a block's 227 KB of shared memory (:func:`smem_bytes`,
the library's own plan).
Every K ≤ 128 with F ≤ 128 fits the 64- and 128-row tiles; the 256-row
tile's fused form takes K ≤ 96 at F = 128 for fp32 points and K ≤ 160 for
bf16 and int8.  For fp32 points the fused form takes up to K = 800 at
F = 32 or K = 160 at F = 128 with 128-row tiles (1,632 and 320
assign-only), K = 832 / 192 with 64-row tiles (1,696 / 384) and K = 736 /
96 with 256-row tiles (1,504 / 192); wider shapes raise a ``ValueError``
naming shared memory.  (The kernel's first version, with 256-row tiles and
no accumulator copies, took the fused form up to about K = 1,495 at F = 32
and K = 191 at F = 128.)

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
# rows a tile: the instances csrc/kmeans.cu holds
TILES = (64, 128, 256)
DEFAULT_BLOCK_N = 128
AUTOTUNE_CANDIDATES = TILES
# (probe rows, f, k, precision, device name) -> block_n
_autotune_cache: dict = {}


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
    lib.kmeans_smem_bytes.argtypes = [i, i, i, i, i]
    lib.kmeans_smem_bytes.restype = ctypes.c_size_t
    lib.kmeans_block_threads.argtypes = [i]
    lib.kmeans_block_threads.restype = i
    lib.kmeans_max_grid.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
    lib.kmeans_max_grid.restype = i
    lib.kmeans_error_string.argtypes = [i]
    lib.kmeans_error_string.restype = ctypes.c_char_p
    lib.kmeans_assign.argtypes = [i, i, p, p, p, p, i, i, i, i, p, p, p]
    lib.kmeans_assign.restype = i
    lib.kmeans_assign_update.argtypes = [i, i, p, p, p, p, i, i, i, i,
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


def _check_block_n(block_n: int) -> None:
    if block_n not in TILES:
        raise ValueError(f"block_n must be one of {TILES} (the kernel's "
                         f"tile sizes), got {block_n!r}")


def smem_bytes(precision: str, fused: bool, f: int, k: int,
               block_n: int = DEFAULT_BLOCK_N) -> int:
    """Dynamic shared memory one block of the given form and tile takes at
    (f, k), from the library's own plan (the largest layout that fits,
    else the smallest).  Above :data:`MAX_SMEM_BYTES` the shape does not
    fit the tile.  Builds the library on first use."""
    _check_block_n(block_n)
    return _library().kmeans_smem_bytes(_DTYPE_CODE[precision], int(fused),
                                        f, k, block_n)


def _raise(lib: ctypes.CDLL, err: int, what: str) -> None:
    raise RuntimeError(f"k-means kernel {what} failed: CUDA error {err} "
                       f"({lib.kmeans_error_string(err).decode()})")


@functools.lru_cache(maxsize=None)
def _max_grid(device_index: int, precision: str, fused: bool, f: int,
              k: int, block_n: int) -> int:
    """SMs × resident blocks of one form and tile at (f, k) on one card;
    raises the shared-memory ``ValueError`` where a block's layout does
    not fit."""
    smem = smem_bytes(precision, fused, f, k, block_n)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"K·F = {k}·{f} needs {smem} B of shared memory per block at "
            f"block_n {block_n}; an sm_90 block has at most "
            f"{MAX_SMEM_BYTES} B")
    lib = _library()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.kmeans_max_grid(_DTYPE_CODE[precision], int(fused), f, k,
                                  block_n, ctypes.byref(out))
    if err != 0:
        _raise(lib, err, "occupancy query")
    return out.value


def geometry(prep: Prepared, fused: bool, block_n: int = DEFAULT_BLOCK_N):
    """``(grid, tile_rows, warps)`` of a launch on prepared CUDA inputs:
    blocks, rows a tile and warps a block.  Block b takes tiles b,
    b + grid, ...; the fused sums' longest chain of fp32 additions is at
    most ``ceil(tiles / grid) · tile_rows + warps + grid``.  Raises the
    shared-memory ``ValueError`` where the shape does not fit the tile."""
    n, f = prep.points.shape
    k = prep.centroids.shape[0]
    warps = _library().kmeans_block_threads(block_n) // 32
    cap = _max_grid(prep.points.device.index or 0, prep.precision, fused,
                    f, k, block_n)
    return min(-(-n // block_n), cap), block_n, warps


def launch(prep: Prepared, fused: bool, block_n: int = DEFAULT_BLOCK_N):
    """Launch the kernel with ``block_n``-row tiles on prepared CUDA inputs
    (counted in :data:`LAUNCHES`).  Returns what :func:`plain` returns."""
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
    grid, _, _ = geometry(prep, fused, block_n)   # raises where K·F does not fit
    lib = _library()
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    dmin = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:                      # no rows: nothing to launch over
        if not fused:
            return ids, dmin
        return (ids, dmin, torch.zeros((k, f), dtype=torch.float32,
                                       device=dev),
                torch.zeros(k, dtype=torch.float32, device=dev))
    scales = None if prep.scales is None else prep.scales.data_ptr()
    args = (_DTYPE_CODE[prep.precision], block_n, pts.data_ptr(),
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


def _dispatch(points, centroids, precision: str, fused: bool, block_n: int):
    dev = points.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"the k-means kernels run on CPU (plain version) "
                         f"or CUDA tensors, got {points.device}")
    _check_block_n(block_n)
    prep = prepare(points, centroids, precision)
    if dev == "cpu":
        return plain(prep, fused)
    return launch(prep, fused, block_n)


def kmeans_assign(points: torch.Tensor, centroids: torch.Tensor, *,
                  precision: str = "fp32",
                  block_n: int = DEFAULT_BLOCK_N):
    """points (N,F), centroids (K,F) -> (ids (N,) int32, dmin (N,) f32)."""
    return _dispatch(points, centroids, precision, False, block_n)


def kmeans_assign_update(points: torch.Tensor, centroids: torch.Tensor, *,
                         precision: str = "fp32",
                         block_n: int = DEFAULT_BLOCK_N):
    """The fused hot path: ``(ids (N,), dmin (N,), sums (K,F) f32,
    counts (K,) f32)`` — the assignment *and* the per-centroid membership
    sums/counts a mini-batch k-means step needs, in one pass."""
    return _dispatch(points, centroids, precision, True, block_n)


def _fits(precision: str, f: int, k: int, block_n: int,
          device: torch.device) -> bool:
    """Whether the fused form at (f, k) runs with ``block_n``-row tiles on
    ``device``: within a block's shared memory on the card, always on the
    CPU (the plain version)."""
    return device.type != "cuda" or \
        smem_bytes(precision, True, f, k, block_n) <= MAX_SMEM_BYTES


def autotune_block_n(n: int, f: int, k: int, *, precision: str = "fp32",
                     candidates=AUTOTUNE_CANDIDATES, probe_n: int = 4096,
                     repeats: int = 2, timer=None, device=None) -> int:
    """The fastest ``block_n`` for a (n, f, k) shape: the reference's
    fixed-order sweep over ``candidates`` (``repro/kernels/kmeans.py:232``),
    each timed ``repeats`` times on a ``min(n, probe_n)``-row ``linspace``
    probe after a warm-up call, the minimum kept; the first candidate wins
    a tie.  Cached per (probe rows, f, k, precision, device name).

    On the card a candidate whose shared-memory layout cannot hold (f, k)
    (:func:`_fits`) is skipped in its place in the order, a ``ValueError``
    where none fits, and the timings synchronize before and after each
    call.  On the CPU the plain version, which ignores the tile and has no
    shared memory, is what is timed.  ``device`` defaults to the card."""
    import time

    dev = torch.device(device if device is not None else "cuda")
    pn = min(n, probe_n)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    key = (pn, f, k, precision, name)
    hit = _autotune_cache.get(key)
    if hit is not None:
        return hit
    fitting = [c for c in candidates if _fits(precision, f, k, c, dev)]
    if not fitting:
        raise ValueError(f"no block_n of {tuple(candidates)} holds K·F = "
                         f"{k}·{f} at {precision} in an sm_90 block's "
                         f"{MAX_SMEM_BYTES} B of shared memory")
    timer = timer or time.perf_counter

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    pts = torch.linspace(-5.0, 5.0, pn * f, device=dev).reshape(pn, f)
    cent = torch.linspace(-5.0, 5.0, k * f, device=dev).reshape(k, f)
    best, best_t = None, None
    for c in fitting:
        kmeans_assign_update(pts, cent, precision=precision, block_n=c)
        times = []
        for _ in range(max(repeats, 1)):
            sync()
            t0 = timer()
            kmeans_assign_update(pts, cent, precision=precision, block_n=c)
            sync()
            times.append(timer() - t0)
        if best_t is None or min(times) < best_t:
            best, best_t = c, min(times)
    _autotune_cache[key] = best
    return best
