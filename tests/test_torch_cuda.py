"""The port's CUDA kernels on an sm_90 card, against their plain versions
on the same inputs.  Imports torch only, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The auto-encoder and the isolation forest, which have no kernel of their
own, are held against the same processors on the host.  Every test skips
on a host without a Hopper card; ``chip_smoke.py`` drives the same
comparisons at the main path's full sizes."""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import ParameterService
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import kmeans as tk
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels import ssm_decode as tsd
from repro_torch.ml import (AutoEncoder, IsolationForest, KMeans,
                            MiniAppGenerator)
from repro_torch.ml import isoforest as tif
from repro_torch.models import transformer as TT
from repro_torch.serve import BatchServer, Request

from zoo_heads import ARCHS as ZOO_HEAD_ARCHS
from zoo_heads import head_config as zoo_head_config

PRECISIONS = ("fp32", "bf16", "int8")
CASES = [(257, 7, 3), (2500, 32, 25), (513, 128, 128)]
# dmin: the expansion's cancellation floor at d ≈ 0 (tests/test_ml.py:75-79)
DMIN_TOL = dict(atol=0.05, rtol=1e-3)


@pytest.fixture
def sm90_device():
    """A Hopper card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _blob(case, device, seed=3):
    n, f, k = case
    rng = np.random.default_rng(seed + n)
    pts = (rng.standard_normal((n, f)) * 5).astype(np.float32)
    x = torch.from_numpy(pts).to(device)
    return x, x[:k].clone()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_kernel_matches_plain(sm90_device, case, precision):
    n, f, k = case
    x, c = _blob(case, sm90_device)
    before = tk.LAUNCHES["kmeans_assign_update"].count
    ids, dmin, sums, counts = ops.kmeans_assign_update(x, c,
                                                       precision=precision)
    assert tk.LAUNCHES["kmeans_assign_update"].count == before + 1
    prep = tk.prepare(x, c, precision)
    p_ids, p_dmin, _, _ = tk.plain(prep, fused=True)
    a_ids, a_dmin = ops.kmeans_assign(x, c, precision=precision)
    torch.cuda.synchronize()
    assert torch.equal(a_ids, ids) and torch.equal(a_dmin, dmin)
    np.testing.assert_array_equal(ids.cpu().numpy(), p_ids.cpu().numpy())
    np.testing.assert_array_equal(
        counts.cpu().numpy(),
        np.bincount(ids.cpu().numpy(), minlength=k).astype(np.float32))
    np.testing.assert_allclose(dmin.cpu().numpy(), p_dmin.cpu().numpy(),
                               **DMIN_TOL)
    xv = tk.point_values(prep).double()
    want = torch.zeros((k, f), dtype=torch.float64,
                       device=sm90_device).index_add_(0, ids.long(), xv)
    np.testing.assert_allclose(sums.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-4)


def test_cuda_fused_outputs_bit_identical_across_launches(sm90_device):
    x, c = _blob((100_000, 32, 25), sm90_device)
    runs = [ops.kmeans_assign_update(x, c) for _ in range(3)]
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


def test_cuda_processor_matches_host(sm90_device):
    """The streaming processor on the card (kernel) and on the host
    (plain version), same messages in order."""
    gen = MiniAppGenerator(n_points=2500, seed=5)
    msgs = [gen.sample() for _ in range(6)]
    card = KMeans(device=sm90_device).make_processor()
    host = KMeans(device="cpu").make_processor()
    for msg in msgs:
        a, b = card(None, data=msg), host(None, data=msg)
        assert a["n_outliers"] == b["n_outliers"]
        assert a["mean_score"] == pytest.approx(b["mean_score"], rel=1e-4)


def test_cuda_wrapper_rejects_oversized_widths(sm90_device):
    x = torch.zeros((16, 512), device=sm90_device)
    with pytest.raises(ValueError, match="shared memory"):
        ops.kmeans_assign(x, x[:128])


# the edges of the kernel's tiles: one row, one row past a tile, F and K
# across the 32-padding, a start address off the 16-byte grid (x[1:] of
# rows of 7 fp32 features), and no rows
KMEANS_EDGES = ["n1", "tile_plus_one", "f33_k33", "misaligned", "n0"]


def _edge_inputs(edge, device):
    rng = np.random.default_rng(11)
    n, f, k = {"n1": (1, 32, 25), "tile_plus_one": (None, 32, 25),
               "f33_k33": (1000, 33, 33), "misaligned": (1001, 7, 3),
               "n0": (0, 32, 25)}[edge]
    if edge == "tile_plus_one":
        x0, _ = _blob((8, 32, 25), device)
        n = tk.geometry(tk.prepare(x0, x0[:1]), True)[1] + 1
    x = torch.from_numpy((rng.standard_normal((n, f)) * 5).astype(
        np.float32)).to(device)
    c = torch.from_numpy((rng.standard_normal((k, f)) * 5).astype(
        np.float32)).to(device)
    if edge == "misaligned":
        x = x[1:]
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    return x, c


@pytest.mark.parametrize("edge", KMEANS_EDGES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_kmeans_edges(sm90_device, edge, precision):
    x, c = _edge_inputs(edge, sm90_device)
    n, f = x.shape
    k = c.shape[0]
    ids, dmin, sums, counts = ops.kmeans_assign_update(x, c,
                                                       precision=precision)
    a_ids, a_dmin = ops.kmeans_assign(x, c, precision=precision)
    prep = tk.prepare(x, c, precision)
    p_ids, p_dmin, p_sums, p_counts = tk.plain(prep, fused=True)
    torch.cuda.synchronize()
    assert ids.shape == (n,) and sums.shape == (k, f) and counts.shape == (k,)
    assert torch.equal(a_ids, ids) and torch.equal(a_dmin, dmin)
    np.testing.assert_array_equal(ids.cpu().numpy(), p_ids.cpu().numpy())
    np.testing.assert_array_equal(counts.cpu().numpy(),
                                  p_counts.cpu().numpy())
    np.testing.assert_allclose(dmin.cpu().numpy(), p_dmin.cpu().numpy(),
                               **DMIN_TOL)
    np.testing.assert_allclose(sums.cpu().numpy(), p_sums.cpu().numpy(),
                               rtol=1e-5, atol=1e-4)


def test_cuda_kmeans_bit_identical_at_1m(sm90_device):
    """No atomics: three fused launches at the headline shape give the
    same bits."""
    x, c = _blob((1_000_000, 32, 25), sm90_device)
    runs = [ops.kmeans_assign_update(x, c) for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


# layouts of less and more shared memory in turn, the first call at each
# shape after a larger one: (32, 25) at 46,336 B in fp32 fused, (7, 3) at
# 20,736 B, (128, 128) above the 48 KB a launch may take unasked
ALTERNATING = [(2000, 32, 25), (2000, 7, 3), (2000, 32, 25), (513, 128, 128),
               (2000, 7, 3), (513, 128, 128)]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_kmeans_shapes_alternate(sm90_device, fused, precision):
    """A call at one shape must not shrink the shared memory a later
    launch at another shape may take, whatever the order the occupancy
    query first sees the shapes in."""
    tk._max_grid.cache_clear()
    for case in ALTERNATING:
        x, c = _blob(case, sm90_device)
        prep = tk.prepare(x, c, precision)
        if fused:
            ids, dmin, sums, counts = ops.kmeans_assign_update(
                x, c, precision=precision)
        else:
            ids, dmin = ops.kmeans_assign(x, c, precision=precision)
        p_ids, p_dmin, _, p_counts = tk.plain(prep, fused=True)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(ids.cpu().numpy(), p_ids.cpu().numpy())
        np.testing.assert_allclose(dmin.cpu().numpy(), p_dmin.cpu().numpy(),
                                   **DMIN_TOL)
        if fused:
            np.testing.assert_array_equal(counts.cpu().numpy(),
                                          p_counts.cpu().numpy())


# B5: every tile instance (block_n 64, 128, 256).  ids and dmin are one
# thread's sums over one row, so every tile gives the same bits.  The sums
# differ in their last bits with the grid and the tile: each is held
# within the fp32 bound of its own longest chain of additions,
# chain · 2^-24 · Σ|x| of a float64 sum over its ids, as chip_smoke.py does
TILE_CASES = [(257, 7, 3), (2500, 32, 25), (513, 128, 128), (300_000, 32, 25)]


def _sums_within_chain(prep, ids, sums, fused_geometry):
    grid, rows, warps = fused_geometry
    n = ids.shape[0]
    xv = tk.point_values(prep).double()
    k, f = prep.centroids.shape
    want = torch.zeros((k, f), dtype=torch.float64,
                       device=xv.device).index_add_(0, ids.long(), xv)
    abs_sums = torch.zeros_like(want).index_add_(0, ids.long(), xv.abs())
    chain = -(-n // (rows * grid)) * rows + warps + grid
    tol = chain * 2.0 ** -24 * abs_sums + 1e-6
    assert bool(((sums.double() - want).abs() <= tol).all())


@pytest.mark.parametrize("case", TILE_CASES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_kmeans_tiles_match_plain(sm90_device, case, precision):
    n, f, k = case
    x, c = _blob(case, sm90_device)
    prep = tk.prepare(x, c, precision)
    p_ids, p_dmin, _, _ = tk.plain(prep, fused=True)
    first = None
    for block_n in tk.TILES:
        a_ids, a_dmin = ops.kmeans_assign(x, c, precision=precision,
                                          block_n=block_n)
        if first is None:
            first = (a_ids, a_dmin)
        if tk.smem_bytes(precision, True, f, k, block_n) > \
                tk.MAX_SMEM_BYTES:
            # (513, 128, 128) fp32 is past the 256-row tile's fused limit
            with pytest.raises(ValueError, match="shared memory"):
                ops.kmeans_assign_update(x, c, precision=precision,
                                         block_n=block_n)
            torch.cuda.synchronize()
            assert torch.equal(a_ids, first[0])
            assert torch.equal(a_dmin, first[1])
            continue
        ids, dmin, sums, counts = ops.kmeans_assign_update(
            x, c, precision=precision, block_n=block_n)
        torch.cuda.synchronize()
        assert torch.equal(a_ids, ids) and torch.equal(a_dmin, dmin)
        assert torch.equal(ids, first[0]) and torch.equal(dmin, first[1])
        np.testing.assert_array_equal(ids.cpu().numpy(), p_ids.cpu().numpy())
        np.testing.assert_allclose(dmin.cpu().numpy(), p_dmin.cpu().numpy(),
                                   **DMIN_TOL)
        assert torch.equal(counts, torch.bincount(ids.long(),
                                                  minlength=k).float())
        _sums_within_chain(prep, ids, sums,
                           tk.geometry(prep, True, block_n))


def test_cuda_kmeans_library_holds_every_tile(sm90_device):
    """One library holds the three tile instances; any other tile is
    refused at the C interface as well as by the wrapper."""
    lib = tk._library()
    for block_n in tk.TILES:
        assert lib.kmeans_block_threads(block_n) == block_n // 2
        assert tk.smem_bytes("fp32", True, 32, 25, block_n) \
            <= tk.MAX_SMEM_BYTES
    assert lib.kmeans_block_threads(96) == 0
    assert lib.kmeans_smem_bytes(0, 1, 32, 25, 96) == 2 ** 64 - 1
    out = ctypes.c_int(0)
    assert lib.kmeans_max_grid(0, 1, 32, 25, 96, ctypes.byref(out)) != 0


@pytest.mark.parametrize("precision,fused,f,limits", [
    # the largest K each tile (64, 128, 256 rows) takes, documented in
    # kernels/kmeans.py and ROADMAP B1/B2; 128 rows are PR 16's limits
    ("fp32", True, 32, (832, 800, 736)),
    ("fp32", True, 128, (192, 160, 96)),
    ("fp32", False, 32, (1696, 1632, 1504)),
    ("fp32", False, 128, (384, 320, 192)),
])
def test_cuda_tile_shape_limits(sm90_device, precision, fused, f, limits):
    for block_n, k in zip(tk.TILES, limits):
        assert tk.smem_bytes(precision, fused, f, k, block_n) \
            <= tk.MAX_SMEM_BYTES
        assert tk.smem_bytes(precision, fused, f, k + 1, block_n) \
            > tk.MAX_SMEM_BYTES


def test_cuda_autotune_skips_a_tile_that_cannot_fit(sm90_device):
    # fp32 K = 780 at F = 32: past the 256-row tile's fused limit (736),
    # inside the 128- and 64-row tiles' (800, 832)
    tk._autotune_cache.clear()
    before = tk.LAUNCHES["kmeans_assign_update"].count
    best = tk.autotune_block_n(4096, 32, 780, precision="fp32",
                               candidates=(256, 128, 64))
    assert best in (128, 64)
    assert tk.LAUNCHES["kmeans_assign_update"].count - before == 2 * 3
    tk._autotune_cache.clear()
    with pytest.raises(ValueError, match="no block_n"):
        tk.autotune_block_n(4096, 32, 900, precision="fp32")


def test_cuda_kmeans_shape_past_a_tile_limit_raises(sm90_device):
    # fp32 K = 780 at F = 32: past the 256-row tile's fused limit (736)
    x, c = _blob((4096, 32, 780), sm90_device)
    with pytest.raises(ValueError, match="shared memory"):
        ops.kmeans_assign_update(x, c, block_n=256)
    ids, _, _, counts = ops.kmeans_assign_update(x, c, block_n=128)
    torch.cuda.synchronize()
    assert float(counts.sum()) == 4096.0


def test_cuda_autotune_returns_a_candidate_and_caches(sm90_device):
    tk._autotune_cache.clear()
    before = tk.LAUNCHES["kmeans_assign_update"].count
    best = tk.autotune_block_n(10_000, 32, 25, precision="bf16")
    assert best in tk.AUTOTUNE_CANDIDATES
    launched = tk.LAUNCHES["kmeans_assign_update"].count - before
    assert launched == len(tk.AUTOTUNE_CANDIDATES) * 3   # warm-up + 2 timed
    key = (4096, 32, 25, "bf16", torch.cuda.get_device_name(sm90_device))
    assert tk._autotune_cache[key] == best
    assert tk.autotune_block_n(10_000, 32, 25, precision="bf16") == best
    assert tk.LAUNCHES["kmeans_assign_update"].count - before == launched


# (b, sq, sk, h, hkv, d, causal, window): tests/test_kernels.py's cases, a
# ragged tile with a window, the widest head_dim, hymba's heads; then the
# edges of the two designs' tiles: Sq != Sk without the causal mask (k
# padding), a sequence that no tile size (64, 96, 128) divides, every head
# width from 16 to 256, and hymba's GQA ratio 25/5; last, the zoo's GQA
# ratios at D = 128: qwen2-vl-2b's 12/2 and qwen3-moe's 64/4
FLASH_CASES = [(1, 128, 128, 2, 2, 64, True, None),
               (2, 200, 200, 2, 2, 64, True, 64),
               (1, 384, 384, 8, 1, 32, True, None),
               (1, 128, 128, 4, 4, 128, False, None),
               (1, 96, 96, 2, 2, 16, True, None),
               (1, 300, 300, 4, 2, 192, True, 100),
               (2, 520, 520, 25, 5, 64, True, 256),
               (1, 100, 300, 2, 1, 64, False, None),
               (2, 300, 77, 4, 2, 128, False, None),
               (1, 333, 333, 4, 2, 64, True, None),
               (1, 200, 200, 2, 2, 16, True, None),
               (1, 200, 200, 2, 2, 32, False, 50),
               (1, 200, 200, 2, 2, 256, False, None),
               (1, 333, 333, 25, 5, 256, True, 128),
               (2, 257, 257, 25, 5, 128, True, None),
               (2, 257, 257, 12, 2, 128, True, None),
               (2, 257, 257, 64, 4, 128, True, None)]
# the kernel's online softmax against the plain version's, both fp32 from
# the same inputs, rounded once to the output type: fp32 within
# tests/test_kernels.py's 2e-5; bf16 within one rounding (2^-7 of the
# value) plus 1e-3 of the largest value for the sums' order near a
# rounding boundary


def _flash_tol(want):
    if want.dtype == torch.float32:
        return dict(atol=2e-5, rtol=2e-5)
    return dict(atol=1e-3 * float(want.float().abs().max()), rtol=2.0 ** -7)


def _randn(g, shape, device, dtype=torch.float32):
    return torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_matches_plain(sm90_device, case, dtype):
    b, sq, sk, h, hkv, d, causal, window = case
    g = torch.Generator(device=sm90_device).manual_seed(sq + sk + d)
    q = _randn(g, (b, sq, h, d), sm90_device, dtype)
    k = _randn(g, (b, sk, hkv, d), sm90_device, dtype)
    v = _randn(g, (b, sk, hkv, d), sm90_device, dtype)
    before = tfa.LAUNCHES["flash_attention"].count
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert tfa.LAUNCHES["flash_attention"].count == before + 1
    want = tfa.plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), **_flash_tol(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_fully_masked_rows_give_zero(sm90_device, dtype):
    """tests/test_torch_attention.py's case on the card: under a one-key
    window, query rows 4 and up of 8 see none of the 4 keys."""
    g = torch.Generator(device=sm90_device).manual_seed(1)
    q = _randn(g, (1, 8, 2, 16), sm90_device, dtype)
    k = _randn(g, (1, 4, 2, 16), sm90_device, dtype)
    v = _randn(g, (1, 4, 2, 16), sm90_device, dtype)
    out = ops.flash_attention(q, k, v, causal=False, window=1)
    want = tfa.plain(q, k, v, causal=False, window=1)
    torch.cuda.synchronize()
    assert not out[:, 4:].any()
    torch.testing.assert_close(out.float(), want.float(), **_flash_tol(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_bit_identical_across_launches(sm90_device, dtype):
    """No atomics: the same inputs give the same bits on every launch."""
    g = torch.Generator(device=sm90_device).manual_seed(7)
    q = _randn(g, (2, 1000, 25, 64), sm90_device, dtype)
    k = _randn(g, (2, 1000, 5, 64), sm90_device, dtype)
    v = _randn(g, (2, 1000, 5, 64), sm90_device, dtype)
    runs = [ops.flash_attention(q, k, v, causal=True, window=300)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_cuda_flash_rejects_head_dim_over_256(sm90_device):
    x = torch.zeros((1, 8, 2, 272), device=sm90_device)
    before = tfa.LAUNCHES["flash_attention"].count
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(x, x, x)
    assert tfa.LAUNCHES["flash_attention"].count == before


# (b, s, nh, hd, g, ds, chunk): tests/test_kernels.py's cases, a ragged
# chunk, then the edges of the kernel's tiles: chunks that 64 does not
# divide (200, 16), ds 4 and 256, hd 16, 30 (rows staged element by
# element) and 256, 4 B/C groups of 8 heads, and hymba-1.5b's widths
SSD_CASES = [(1, 64, 2, 16, 1, 16, 16), (2, 128, 4, 32, 1, 16, 32),
             (1, 256, 8, 64, 2, 32, 64), (1, 256, 24, 64, 1, 128, 64),
             (2, 128, 4, 32, 4, 16, 128), (2, 400, 4, 64, 1, 16, 200),
             (1, 512, 24, 64, 1, 128, 256), (1, 256, 4, 32, 1, 4, 128),
             (1, 512, 2, 64, 1, 256, 256), (1, 256, 2, 256, 1, 256, 256),
             (1, 400, 4, 30, 2, 4, 200), (1, 256, 8, 32, 4, 16, 64),
             (2, 1024, 50, 64, 1, 16, 256)]
HYMBA_SSD = (2, 1024, 50, 64, 1, 16, 256)


def _ssd_inputs(case, device, dtype=torch.float32):
    b, s, nh, hd, gr, ds, _ = case
    g = torch.Generator(device=device).manual_seed(s + ds)
    x = _randn(g, (b, s, nh, hd), device, dtype)
    dt = torch.rand((b, s, nh), generator=g, device=device) * 0.1 + 1e-3
    A = -(torch.rand((nh,), generator=g, device=device) * 1.5 + 0.5)
    B = _randn(g, (b, s, gr, ds), device, dtype)
    C = _randn(g, (b, s, gr, ds), device, dtype)
    return x, dt, A, B, C, _randn(g, (nh,), device)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_matches_plain(sm90_device, case, dtype):
    """The chunk kernel's (y, st, cum) and the full scan against the plain
    version within 1e-3 (tests/test_kernels.py's scan tolerance); y in bf16
    within that file's bf16 tolerance of 5e-2, since kernel and plain may
    round a sum to bf16 on either side of a tie."""
    chunk = case[-1]
    x, dt, A, B, C, D = _ssd_inputs(case, sm90_device, dtype)
    before = tssd.LAUNCHES["ssd_chunk_scan"].count
    y, fin = ops.ssd_chunk_scan(x, dt, A, B, C, D, chunk=chunk)
    assert tssd.LAUNCHES["ssd_chunk_scan"].count == before + 1
    parts = tssd.chunk_launch(x, dt, A, B, C, D, chunk)
    want_parts = tssd.chunk_plain(x, dt, A, B, C, D, chunk)
    want_y, want_fin = tssd.inter_chunk(*want_parts, C, chunk)
    torch.cuda.synchronize()
    assert parts[0].dtype == dtype and y.dtype == dtype
    for got, want in zip((*parts, y, fin), (*want_parts, want_y, want_fin)):
        tol = 5e-2 if got.dtype == torch.bfloat16 else 1e-3
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_bit_identical_across_launches(sm90_device, dtype):
    """No atomics, and every work item of a chunk scans cum with the same
    code: three launches at hymba's widths give the same bits."""
    chunk = HYMBA_SSD[-1]
    args = _ssd_inputs(HYMBA_SSD, sm90_device, dtype)
    runs = [tssd.chunk_launch(*args, chunk) for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def test_cuda_batch_server_goes_through_both_kernels(sm90_device):
    """hymba at reduced width on the card: one wave of 2 prompts of 64
    tokens (past the 16-token window) launches each kernel once per layer,
    and the tokens equal the server's on the host with the same weights."""
    cfg = get_arch("hymba-1.5b").reduced()
    params = TT.init_params(cfg, device=sm90_device, seed=1)
    host_params = {k: v for k, v in params.items() if k != "blocks"}
    host_params = {k: v.cpu() for k, v in host_params.items()}
    host_params["blocks"] = [
        {k: ({kk: (vv.cpu() if isinstance(vv, torch.Tensor) else
                   {a: t.cpu() for a, t in vv.items()})
              for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
         for k, v in blk.items()} for blk in params["blocks"]]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, 64).astype(np.int32)
               for _ in range(2)]
    results = {}
    for name, p, dev in (("card", params, sm90_device),
                         ("host", host_params, "cpu")):
        server = BatchServer(p, cfg, n_slots=2, max_len=72, device=dev)
        for i, pr in enumerate(prompts):
            server.submit(Request(request_id=f"r{i}", prompt=pr,
                                  max_new_tokens=5))
        f0 = tfa.LAUNCHES["flash_attention"].count
        s0 = tssd.LAUNCHES["ssd_chunk_scan"].count
        done = server.run(max_requests=2, idle_timeout_s=0.5)
        launches = (tfa.LAUNCHES["flash_attention"].count - f0,
                    tssd.LAUNCHES["ssd_chunk_scan"].count - s0)
        results[name] = ([r.result_tokens for r in done], launches)
    assert results["card"][1] == (cfg.n_layers, cfg.n_layers)
    assert results["host"][1] == (0, 0)
    assert results["card"][0] == results["host"][0]


def _publish_both(tree):
    services = ParameterService(), ParameterService()
    for ps in services:
        ps.publish("m", tree)
    return services


def test_cuda_autoencoder_processor_matches_host(sm90_device):
    """The AE processor on the card and on the host from the same initial
    state on the same messages: equal outlier counts and versions, mean
    scores within 1e-5 relative and params within 5e-5 (the host tests'
    tolerances against the reference, tests/test_torch_autoencoder.py)."""
    gen = MiniAppGenerator(n_points=2_500, seed=21)
    msgs = [gen.sample() for _ in range(4)]
    ps_card, ps_host = _publish_both(AutoEncoder(device="cpu").init())
    card = AutoEncoder(device=sm90_device).make_processor(ps_card, "m")
    host = AutoEncoder(device="cpu").make_processor(ps_host, "m")
    for msg in msgs:
        a, b = card(None, data=msg), host(None, data=msg)
        assert a["n_outliers"] == b["n_outliers"]
        assert a["mean_score"] == pytest.approx(b["mean_score"], rel=1e-5)
    assert ps_card.version("m") == ps_host.version("m") == len(msgs) + 1
    _, ta = ps_card.fetch("m")
    _, tb = ps_host.fetch("m")
    assert int(ta["step"]) == int(tb["step"]) == len(msgs)
    for pa, pb in zip(ta["params"], tb["params"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(pa[k], pb[k], rtol=0, atol=5e-5)


def test_cuda_isoforest_scores_a_host_forest_like_the_host(sm90_device):
    """One forest built on the host and moved to the card: the same leaves
    and depths for every point in every tree, scores within 1e-6."""
    pts, _ = MiniAppGenerator(n_points=3_000, outlier_frac=0.03,
                              seed=4).sample_with_labels()
    host = IsolationForest(device="cpu")
    st = host.fit(pts)
    card = IsolationForest(device=sm90_device)
    st_card = {"forest": {k: v.to(sm90_device)
                          for k, v in st["forest"].items()},
               "psi": st["psi"].to(sm90_device)}
    x = torch.as_tensor(pts, dtype=torch.float32)
    node_h, depth_h = tif._walk(st["forest"], x, host.max_depth)
    node_c, depth_c = tif._walk(st_card["forest"], x.to(sm90_device),
                                host.max_depth)
    assert torch.equal(node_c.cpu(), node_h)
    assert torch.equal(depth_c.cpu(), depth_h)
    np.testing.assert_allclose(
        card.outlier_scores(st_card, pts).cpu().numpy(),
        host.outlier_scores(st, pts).numpy(), rtol=0, atol=1e-6)


def test_cuda_isoforest_own_fit_separates_outliers(sm90_device):
    """tests/test_ml.py's band on a forest the card built itself."""
    pts, is_out = MiniAppGenerator(n_points=1_500, outlier_frac=0.03,
                                   seed=4).sample_with_labels()
    f = IsolationForest(n_trees=50, device=sm90_device)
    st = f.fit(pts)
    assert all(v.device.type == "cuda" for v in st["forest"].values())
    s = f.outlier_scores(st, pts).cpu().numpy()
    assert s[is_out].mean() > s[~is_out].mean() + 0.05
    order = np.argsort(s)
    ranks = np.empty_like(order, float)
    ranks[order] = np.arange(len(s))
    assert (ranks[is_out].mean() - ranks.mean()) / len(s) + 0.5 > 0.85


# ---------------------------------------------------------------------------
# training: no kernel of its own (impl="dense"); the card against the host
# ---------------------------------------------------------------------------


def _train_setup(arch="internlm2-1.8b", **tc_kw):
    from repro_torch.data import make_batch_iterator
    from repro_torch.train import step as TS
    cfg = get_arch(arch).reduced()
    tc = TS.TrainConfig(lr=1e-3, warmup=2, total_steps=20, **tc_kw)
    it = make_batch_iterator(cfg, 4, 64, seed=0, device="cpu")
    return cfg, tc, TS, [next(it) for _ in range(3)]


def test_cuda_train_step_matches_host(sm90_device):
    """Three steps of make_train_step from the same host-made weights:
    loss and grad norm 1e-4 relative, params within 5e-5 (AdamW moves an
    element by about lr)."""
    from torch.utils import _pytree as pytree
    cfg, tc, TS, batches = _train_setup()
    ph, sh = TS.init_train_state(cfg, tc, seed=1, device="cpu")
    pc = pytree.tree_map(lambda t: t.to(sm90_device), ph)
    sc = pytree.tree_map(lambda t: t.to(sm90_device), sh)
    step = TS.make_train_step(cfg, tc)
    for b in batches:
        pc, sc, mc = step(pc, sc, {k: v.to(sm90_device) for k, v in b.items()})
        ph, sh, mh = step(ph, sh, b)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(mc[k]), float(mh[k]), rtol=1e-4)
    assert all(t.device.type == "cuda" for t in pytree.tree_leaves((pc, sc)))
    for a, b in zip(pytree.tree_leaves(pc), pytree.tree_leaves(ph)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=5e-5,
                                   rtol=0)


def test_cuda_remat_gradients_match(sm90_device):
    """Gradients with remat on and off on the card: the recompute runs the
    same kernels on the same inputs (1e-6 of each leaf's largest)."""
    from torch.utils import _pytree as pytree
    cfg = get_arch("hymba-1.5b").reduced()
    params = TT.init_params(cfg, device=sm90_device, seed=2)
    rng = np.random.default_rng(0)
    inputs = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64),
                                               dtype=np.int32)
                                  ).to(sm90_device)
              for k in ("tokens", "labels")}
    leaves, spec = pytree.tree_flatten(params)
    grads = {}
    for remat in (True, False):
        ls = [p.detach().requires_grad_() for p in leaves]
        loss, _ = TT.loss_fn(pytree.tree_unflatten(ls, spec), cfg, inputs,
                             remat=remat)
        grads[remat] = torch.autograd.grad(loss, ls)
    for a, b in zip(grads[True], grads[False]):
        assert a.device.type == "cuda"
        tol = 1e-6 * max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= tol


def test_cuda_checkpoint_round_trip(sm90_device, tmp_path):
    """Card tensors, a bf16 leaf among them, saved and restored onto the
    card with the same bits."""
    from repro_torch.ckpt import restore, save
    g = torch.Generator(device=sm90_device).manual_seed(0)
    tree = {"w": torch.randn(64, 33, device=sm90_device, generator=g),
            "ef": torch.randn(7, 5, device=sm90_device,
                              generator=g).to(torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32, device=sm90_device),
            "blocks": {"b": torch.randn(2, 4, device=sm90_device,
                                        generator=g)}}
    save(str(tmp_path), 3, tree)
    got = restore(str(tmp_path), like=tree, device=sm90_device)
    for key in ("w", "ef", "step"):
        assert got[key].device.type == "cuda"
        assert got[key].dtype == tree[key].dtype
        assert torch.equal(got[key], tree[key])
    assert torch.equal(got["blocks"]["b"], tree["blocks"]["b"])


def test_cuda_compressed_psum_on_one_rank_nccl(sm90_device):
    """compressed_psum on a one-rank NCCL group (its scale goes through an
    NCCL max) equals the no-group form, within scale/2 of g + error."""
    import socket
    import torch.distributed as dist
    from repro_torch.optim import compressed_psum
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        gen = torch.Generator(device=sm90_device).manual_seed(1)
        grad = torch.randn(37, 11, device=sm90_device, generator=gen) * 3
        err = (torch.randn(37, 11, device=sm90_device, generator=gen)
               * 0.01).to(torch.bfloat16)
        avg, new_err = compressed_psum(grad, dist.group.WORLD, err)
        avg0, new_err0 = compressed_psum(grad, None, err)
    finally:
        dist.destroy_process_group()
    assert avg.device.type == "cuda"
    assert torch.equal(avg, avg0) and torch.equal(new_err, new_err0)
    target = grad + err.float()
    half = float(target.abs().max()) / 127 / 2
    assert float((avg - target).abs().max()) <= half + 1e-6
    torch.testing.assert_close(avg + new_err, target, atol=1e-6, rtol=0)


def test_cuda_pipeline_matches_plain_step(sm90_device):
    """The GPipe step with both stages in one process on the card (reduced
    internlm2-1.8b, 2 stages, 4 microbatches of one row): two steps
    against make_train_step's from the same seed on the same batches —
    loss 1e-5 relative, grad norm 1e-4 relative, params within 5e-5."""
    from torch.utils import _pytree as pytree
    from repro_torch.train import pipeline as PP
    cfg, tc, TS, batches = _train_setup()
    pc = PP.PipelineConfig(n_stages=2, microbatches=4)
    pp, ps = PP.init_pp_state(cfg, tc, pc, seed=1, device=sm90_device)
    p, s = TS.init_train_state(cfg, tc, seed=1, device=sm90_device)
    step = PP.make_pp_train_step(cfg, tc, pc)
    plain = TS.make_train_step(cfg, tc)
    for b in batches[:2]:
        b = {k: v.to(sm90_device) for k, v in b.items()}
        pp, ps, m = step(pp, ps, b)
        p, s, mp = plain(p, s, b)
        np.testing.assert_allclose(float(m["loss"]), float(mp["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(mp["grad_norm"]), rtol=1e-4)
    for a, b in zip(pytree.tree_leaves((pp, ps)), pytree.tree_leaves((p, s))):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().float().numpy(),
                                   b.cpu().float().numpy(), atol=5e-5,
                                   rtol=0)


def test_cuda_restore_onto_one_rank_nccl_mesh(sm90_device, tmp_path):
    """Reduced internlm2-1.8b's card parameters saved and restored onto a
    one-rank NCCL mesh (1, 1) by ``param_pspecs``: every leaf a DTensor
    on the card with its spec's placements and the same bits; the rules'
    constraint redistributes a DTensor activation there."""
    import socket
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.ckpt import restore, save
    from repro_torch.launch import mesh as TM
    from repro_torch.models import convert
    cfg = get_arch("internlm2-1.8b").reduced()
    params = TT.init_params(cfg, device=sm90_device, seed=4)
    save(str(tmp_path), 1, convert.stack_blocks(params))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = TM.make_debug_mesh((1, 1))
        rules = TM.make_rules(mesh)
        pspecs = TT.param_pspecs(cfg, rules)
        like = convert.stack_blocks(TT.param_shapes(cfg, torch.float32))
        got = convert.unstack_blocks(
            restore(str(tmp_path), 1, like=like, mesh=mesh, pspecs=pspecs),
            params)
        layered = convert.unstack_specs(pspecs, params)
        for (leaf, spec), (want, _) in zip(
                convert.leaves_with_specs(got, layered),
                convert.leaves_with_specs(params, layered)):
            assert isinstance(leaf, DTensor)
            assert leaf.to_local().device.type == "cuda"
            assert tuple(leaf.placements) == TM.placements(spec, mesh)
            assert torch.equal(leaf.to_local(), want)
        x = torch.randn(2, 8, 16, device=sm90_device)
        d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        y = rules.act(d, rules.batch, None, rules.model)
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert torch.equal(y.full_tensor(), x)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the rest of the zoo: MLA, M-RoPE with embeddings, MoE; the card against
# the host on the same weights
# ---------------------------------------------------------------------------


def _to(tree, device):
    from torch.utils import _pytree as pytree
    return pytree.tree_map(lambda t: t.to(device), tree)


def _zoo_inputs(cfg, lo, hi, seed=0):
    """Positions lo..hi-1 of a seeded sequence (2 rows): token ids
    (codebook ids for musicgen), or embeddings with distinct (t, h, w)
    M-RoPE positions."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        emb = rng.standard_normal((2, hi, cfg.d_model)).astype(np.float32)
        n = np.arange(hi)
        pos = np.stack([n, n // 4 + 1, n % 4 + 2])[:, None].repeat(2, 1)
        return {"embeds": torch.from_numpy(emb[:, lo:hi]),
                "positions": torch.from_numpy(
                    np.ascontiguousarray(pos[:, :, lo:hi]).astype(np.int32))}
    shape = (2, hi, cfg.n_codebooks) if cfg.n_codebooks > 1 else (2, hi)
    toks = rng.integers(0, cfg.vocab_size, shape)
    return {"tokens": torch.from_numpy(toks[:, lo:hi])}


@pytest.mark.parametrize("arch", [
    "minicpm3-4b", "qwen2-vl-2b", "qwen3-moe-235b-a22b", "arctic-480b",
    # the archs chip_smoke.py serves at full width since ROADMAP A11, at
    # their real head structures (tests/zoo_heads.py)
    *(f"{a}:heads" for a in ZOO_HEAD_ARCHS)])
def test_cuda_zoo_prefill_and_decode_match_host(sm90_device, arch):
    """Reduced MLA, M-RoPE and MoE archs, and the five archs of
    ``ZOO_SERVE`` at their real head structures (GQA groups of 4, 12 and
    7 at D 128 and 192, MHA over 4 codebooks, SSD at d_state 128): a
    40-token prefill (64 for the head structures: two of mamba2's
    32-token chunks) through ``impl="kernel"`` (fp32 cache) and 4 decode
    steps on the card and on the host from the same host-made weights;
    logits and every cache entry within 2e-3 (tests/test_serve.py's
    tolerance).  The prefill launches the flash kernel once a layer of
    attention (MLA never: its attention is dense, as in the reference),
    the SSD kernel once a layer of SSM."""
    from repro_torch.serve.engine import prefill_with_cache
    name, _, heads = arch.partition(":")
    cfg = (zoo_head_config(get_arch, name) if heads
           else get_arch(name).reduced())
    host = TT.init_params(cfg, device="cpu", seed=4)
    S, N = (64 if heads else 40), 4
    out = {}
    for name, params, dev in (("card", _to(host, sm90_device), sm90_device),
                              ("host", host, "cpu")):
        before = tfa.LAUNCHES["flash_attention"].count
        scans = tssd.LAUNCHES["ssd_chunk_scan"].count
        with torch.inference_mode():
            inp = {k: v.to(dev) for k, v in _zoo_inputs(cfg, 0, S).items()}
            logits, cache = prefill_with_cache(
                params, cfg, inp, max_len=S + N, impl="kernel",
                cache_dtype=torch.float32)
            rows = [logits]
            for i in range(N):
                inp = {k: v.to(dev) for k, v in
                       _zoo_inputs(cfg, S + i, S + i + 1).items()}
                step, cache = TT.decode_step(params, cfg, cache,
                                             {**inp, "length": S + i})
                rows.append(step)
        launches = (tfa.LAUNCHES["flash_attention"].count - before,
                    tssd.LAUNCHES["ssd_chunk_scan"].count - scans)
        out[name] = ([r.cpu() for r in rows],
                     {k: v.cpu() for k, v in cache.items()}, launches)
    assert out["card"][2] == (
        cfg.n_layers if cfg.attn_kind in ("gqa", "hybrid") else 0,
        cfg.n_layers if cfg.attn_kind in ("none", "hybrid") else 0)
    assert out["host"][2] == (0, 0)
    for a, b in zip(out["card"][0], out["host"][0]):
        torch.testing.assert_close(a, b, atol=2e-3, rtol=2e-3)
    for key, b in out["host"][1].items():
        torch.testing.assert_close(out["card"][1][key], b, atol=2e-3,
                                   rtol=2e-3)


def test_cuda_moe_train_step_matches_host(sm90_device):
    """Reduced qwen3-moe (Adafactor): three steps of make_train_step from
    the same host-made weights, loss, grad norm and the router's aux
    values 1e-4 relative, params within 5e-5."""
    from torch.utils import _pytree as pytree
    cfg, tc, TS, batches = _train_setup("qwen3-moe-235b-a22b")
    ph, sh = TS.init_train_state(cfg, tc, seed=1, device="cpu")
    pc, sc = _to(ph, sm90_device), _to(sh, sm90_device)
    step = TS.make_train_step(cfg, tc)
    for b in batches:
        pc, sc, mc = step(pc, sc, {k: v.to(sm90_device) for k, v in b.items()})
        ph, sh, mh = step(ph, sh, b)
        assert {"lb_loss", "z_loss", "dropped_frac"} <= set(mh)
        for k in ("loss", "grad_norm", "lb_loss", "z_loss"):
            np.testing.assert_allclose(float(mc[k]), float(mh[k]), rtol=1e-4)
        assert float(mc["dropped_frac"]) == float(mh["dropped_frac"])
    for a, b in zip(pytree.tree_leaves(pc), pytree.tree_leaves(ph)):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=5e-5,
                                   rtol=0)


# ---------------------------------------------------------------------------
# the static-shape decode step as one CUDA graph a batch shape
# ---------------------------------------------------------------------------

# one reduced arch a family: GQA, ring + SSM (hybrid), MLA, SSM, MoE,
# codebooks, M-RoPE over embeddings
GRAPH_ARCHS = ["internlm2-1.8b", "hymba-1.5b", "minicpm3-4b", "mamba2-130m",
               "qwen3-moe-235b-a22b", "musicgen-medium", "qwen2-vl-2b"]


def _step_inputs(cfg, seed, pos, device):
    inp = {k: v.to(device) for k, v in
           _zoo_inputs(cfg, pos, pos + 1, seed=seed).items()}
    inp["length"] = torch.tensor(pos, dtype=torch.int32, device=device)
    return inp


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_cuda_decode_graph_is_the_eager_step(sm90_device, arch):
    """``make_decode_fn`` on the card against the eager ``decode_step`` on
    a copy of the same cache: two waves of a 20-token prefill (bf16 cache,
    past hymba's 16-slot ring) and 4 steps each, 8 steps in all, through
    one graph; logits bit for bit at every step, the caches after each
    wave equal."""
    from repro_torch.serve import make_decode_fn
    from repro_torch.serve.engine import prefill_with_cache
    cfg = get_arch(arch).reduced()
    params = TT.init_params(cfg, device=sm90_device, seed=2)
    decode = make_decode_fn(cfg)
    S, N = 20, 4
    for wave in range(2):
        with torch.inference_mode():
            inp = {k: v.to(sm90_device) for k, v in
                   _zoo_inputs(cfg, 0, S, seed=wave).items()}
            _, cache = prefill_with_cache(params, cfg, inp, max_len=S + N,
                                          impl="kernel")
            eager = {k: v.clone() for k, v in cache.items()}
            for i in range(N):
                inp = _step_inputs(cfg, wave, S + i, sm90_device)
                got, cache = decode(params, cache, inp)
                got = got.clone()       # the graph's buffer: next step's
                want, eager = TT.decode_step(params, cfg, eager, inp)
                assert torch.equal(got, want), (wave, i)
        assert cache is decode.last.cache
        for name, t in eager.items():
            assert torch.equal(cache[name], t), (wave, name)
    assert len(decode.graphs) == 1
    g = decode.last
    assert g.capture_s > 0 and g.nodes >= g.kernels > 0


def test_cuda_batch_server_graph_tokens_equal_eager(sm90_device):
    """hymba at reduced width: the server's graph decode and the eager step
    (``server._decode`` swapped for ``decode_step``) give the same tokens
    over two waves of one batch shape; the first wave records a capture,
    the second replays the same graph."""
    cfg = get_arch("hymba-1.5b").reduced()
    params = TT.init_params(cfg, device=sm90_device, seed=1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, 24).astype(np.int32)
               for _ in range(4)]
    results = {}
    for name in ("graph", "eager"):
        server = BatchServer(params, cfg, n_slots=2, max_len=40,
                             device=sm90_device)
        if name == "eager":
            impl = server.decode_fn.impl
            server._decode = torch.inference_mode()(
                lambda p, c, i: TT.decode_step(p, cfg, c, i, impl=impl))
        for i, pr in enumerate(prompts):
            server.submit(Request(request_id=f"r{i}", prompt=pr,
                                  max_new_tokens=8))
        done = server.run(max_requests=4, idle_timeout_s=0.5)
        results[name] = [r.result_tokens for r in done]
        if name == "graph":
            assert len(server.decode_fn.graphs) == 1
            first, second = server.waves
            assert first["graph_capture_s"] > 0
            assert second["graph_capture_s"] == 0.0
            assert first["graph_nodes"] == second["graph_nodes"] > 0
    assert results["graph"] == results["eager"]


def test_cuda_batch_server_counts_evictions_and_spans(sm90_device,
                                                      monkeypatch):
    """hymba at reduced width, five batch shapes through one server: the
    fifth wave's decode and prefill captures each evict the least
    recently used of the 4 graphs kept, and its ``graph_capture_s`` reads
    that capture (the number of graphs kept stays at its limit, so it
    cannot tell).  With spans on, the fifth wave warms and captures two
    graphs, and each of its replayed decode steps looks up, loads and
    replays its graph inside the decode function's call."""
    from repro_torch.core.monitoring import REGISTRY as reg
    from repro_torch.core.monitoring import spans_between
    from repro_torch.serve.engine import MAX_DECODE_GRAPHS
    cfg = get_arch("hymba-1.5b").reduced()
    params = TT.init_params(cfg, device=sm90_device, seed=1)
    monkeypatch.setattr(reg, "spans_on", True)
    server = BatchServer(params, cfg, n_slots=5, max_len=24,
                         device=sm90_device)
    rng = np.random.default_rng(0)
    for b in range(1, 6):
        before = reg.snapshot()
        for i in range(b):
            server.submit(Request(request_id=f"b{b}-{i}", prompt=rng.integers(
                1, cfg.vocab_size, 16).astype(np.int32), max_new_tokens=4))
        server.run(max_requests=b, idle_timeout_s=0.5)
    spans = spans_between(before, reg.snapshot())
    waves = server.waves
    assert [w["batch"] for w in waves] == [1, 2, 3, 4, 5]
    assert all(w["graph_capture_s"] > 0 for w in waves)
    assert all(w["prefill_capture_s"] > 0 for w in waves)
    decode, prefill = server.decode_fn, server.prefill_fn
    assert len(decode.graphs) == MAX_DECODE_GRAPHS
    assert (decode.captures, decode.evictions) == (5, 1)
    assert (prefill.captures, prefill.evictions) == (5, 1)
    assert spans["graphs.warm"]["count"] == 2
    assert spans["graphs.capture"]["count"] == 2
    assert spans["graphs.instantiate"]["parents"] == {"graphs.capture": 2}
    assert spans["serve.decode"]["count"] == 3
    assert spans["graphs.lookup"]["parents"] == {"serve.wave": 1,
                                                 "serve.decode.call": 3}
    for name in ("graphs.load", "graphs.replay"):
        assert spans[name]["parents"] == {"serve.decode.call": 2}, name


def test_cuda_decode_capture_that_syncs_raises(sm90_device, monkeypatch):
    """A step that reads the position on the host (``ring_slot`` patched
    to call ``int``) runs eagerly but cannot be captured: the call raises,
    and the card goes on working."""
    from repro_torch.models import layers as TL
    from repro_torch.serve import make_decode_fn
    from repro_torch.serve.engine import prefill_with_cache
    cfg = get_arch("internlm2-1.8b").reduced()
    params = TT.init_params(cfg, device=sm90_device, seed=3)
    ring = TL.ring_slot
    monkeypatch.setattr(TL, "ring_slot", lambda length, size, r: ring(
        int(length), size, r))
    with torch.inference_mode():
        inp = {k: v.to(sm90_device) for k, v in
               _zoo_inputs(cfg, 0, 8).items()}
        _, cache = prefill_with_cache(params, cfg, inp, max_len=12)
        decode = make_decode_fn(cfg)
        with pytest.raises(RuntimeError):
            decode(params, cache, _step_inputs(cfg, 0, 8, sm90_device))
    assert decode.graphs == {}
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    x = torch.ones(4, device=sm90_device)
    assert float((x + 1).sum()) == 8.0


def test_cuda_decode_capture_that_widens_raises(sm90_device):
    """mamba2 from ``init_cache``'s bf16 conv window: the step widens it to
    fp32 (a new tensor, not the captured one), so the call raises; the
    prefill's fp32 states capture."""
    from repro_torch.serve import make_decode_fn
    cfg = get_arch("mamba2-130m").reduced()
    params = TT.init_params(cfg, device=sm90_device, seed=3)
    cache = TT.init_cache(cfg, 2, 8, device=sm90_device)
    assert cache["conv"].dtype == torch.bfloat16
    decode = make_decode_fn(cfg)
    with torch.inference_mode(), pytest.raises(RuntimeError, match="widen"):
        decode(params, cache, _step_inputs(cfg, 0, 0, sm90_device))
    assert decode.graphs == {}


# ---------------------------------------------------------------------------
# the prefill as one CUDA graph a (batch, prompt) shape
# ---------------------------------------------------------------------------


def _prefill_inputs(cfg, n, seed, device):
    return {k: v.to(device) for k, v in _zoo_inputs(cfg, 0, n,
                                                     seed=seed).items()}


def _assert_prefill_is(got, fn, params, inputs):
    """``got`` (a prefill graph's logits and cache, read before the next
    call) bit for bit the eager prefill of ``fn`` on the same inputs."""
    with torch.inference_mode():
        want, wcache = fn.eager(params, inputs)
    logits, cache = got
    assert torch.equal(logits, want)
    assert set(cache) == set(wcache)
    for name, t in wcache.items():
        assert cache[name].dtype == t.dtype, name
        assert torch.equal(cache[name], t), name


def _graph_launches(g):
    names = {id(c): name for mod in (tfa, tssd)
             for name, c in mod.LAUNCHES.items()}
    return {names[id(c)]: n for c, n in g.launches}


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_cuda_prefill_graph_is_the_eager_prefill(sm90_device, arch):
    """``make_prefill_fn(impl="kernel")`` on the card against the eager
    prefill on the same inputs: two 24-token waves (past hymba's 16-slot
    ring), the first capturing, the second replaying the same graph;
    logits and every cache entry bit for bit.  The graph records a flash
    launch a layer of attention and an SSD launch a layer of SSM (MLA's
    attention is dense)."""
    from repro_torch.serve import make_prefill_fn
    cfg = get_arch(arch).reduced()
    params = TT.init_params(cfg, device=sm90_device, seed=2)
    prefill = make_prefill_fn(cfg, 32, impl="kernel")
    for seed in range(2):
        inp = _prefill_inputs(cfg, 24, seed, sm90_device)
        _assert_prefill_is(prefill(params, inp), prefill, params, inp)
    assert len(prefill.graphs) == 1
    g = prefill.last
    assert g.capture_s > 0 and g.nodes >= g.kernels > 0
    layers = {"flash_attention": cfg.attn_kind in ("gqa", "hybrid"),
              "ssd_chunk_scan": cfg.attn_kind in ("none", "hybrid")}
    assert _graph_launches(g) == {k: cfg.n_layers for k, on in
                                  layers.items() if on}


def test_cuda_prefill_graph_interleaved_lengths(sm90_device):
    """hymba (flash, SSD and the ring): prompts of 16 and 24 tokens in
    turn, A, B, A, B, each with other tokens.  The two graphs share one
    memory pool, and a result holds only until the next call; each one,
    read at once, is the eager prefill's bit for bit."""
    from repro_torch.serve import make_prefill_fn
    cfg = get_arch("hymba-1.5b").reduced()
    params = TT.init_params(cfg, device=sm90_device, seed=5)
    prefill = make_prefill_fn(cfg, 32, impl="kernel")
    for seed, n in enumerate((16, 24, 16, 24)):
        inp = _prefill_inputs(cfg, n, seed, sm90_device)
        _assert_prefill_is(prefill(params, inp), prefill, params, inp)
    assert len(prefill.graphs) == 2 and prefill.pool is not None


def test_cuda_prefill_graph_launches_count_replays(sm90_device):
    """hymba: the first call of a key launches each kernel once a layer
    (the eager warm-up; the capture counts none), ``LAUNCHES`` after 3
    replays are 3 waves x layers, and the graph's kernel nodes hold the
    launches the wrappers counted at its capture."""
    from repro_torch.serve import make_prefill_fn
    cfg = get_arch("hymba-1.5b").reduced()
    params = TT.init_params(cfg, device=sm90_device, seed=6)
    prefill = make_prefill_fn(cfg, 32, impl="kernel")
    counters = {"flash_attention": tfa.LAUNCHES["flash_attention"],
                "ssd_chunk_scan": tssd.LAUNCHES["ssd_chunk_scan"]}
    before = {k: c.count for k, c in counters.items()}
    prefill(params, _prefill_inputs(cfg, 24, 0, sm90_device))
    torch.cuda.synchronize()
    assert {k: c.count - before[k] for k, c in counters.items()} == {
        k: cfg.n_layers for k in counters}
    for c in counters.values():
        c.reset()
    for seed in range(1, 4):
        prefill(params, _prefill_inputs(cfg, 24, seed, sm90_device))
    torch.cuda.synchronize()
    assert {k: c.count for k, c in counters.items()} == {
        k: 3 * cfg.n_layers for k in counters}
    assert _graph_launches(prefill.last) == {k: cfg.n_layers
                                             for k in counters}
    assert dict(prefill.last.counted) == dict(prefill.last.launches)


def test_cuda_prefill_graph_new_params_capture_again(sm90_device):
    """The graph holds the params it was captured with: a new params tree
    captures a graph of its own and drops the other tree's (ROADMAP C9),
    so trees A, B, A capture three times and keep one graph; each call is
    right."""
    from repro_torch.serve import make_prefill_fn
    cfg = get_arch("internlm2-1.8b").reduced()
    trees = [TT.init_params(cfg, device=sm90_device, seed=s) for s in (7, 8)]
    prefill = make_prefill_fn(cfg, 32, impl="kernel")
    inp = _prefill_inputs(cfg, 24, 0, sm90_device)
    for params in (*trees, trees[0]):
        _assert_prefill_is(prefill(params, inp), prefill, params, inp)
        assert prefill.last.params is params
    assert len(prefill.graphs) == 1 and prefill.captures == 3


def test_cuda_prefill_graph_capture_that_syncs_raises(sm90_device,
                                                      monkeypatch):
    """A prefill that reads a value on the host (``_pad_seq`` patched to
    call ``bool`` on a tensor) runs in the eager warm-up but cannot be
    captured: the call raises, no graph is kept, no result comes back from
    an eager fallback, the capture's launches are taken back (the
    warm-up's stay), and the card goes on working."""
    from repro_torch.serve import engine, make_prefill_fn
    pad = engine._pad_seq

    def syncing(x, max_len):
        if bool(x.float().abs().sum() >= 0):
            return pad(x, max_len)
        raise AssertionError("unreachable")

    monkeypatch.setattr(engine, "_pad_seq", syncing)
    cfg = get_arch("internlm2-1.8b").reduced()
    params = TT.init_params(cfg, device=sm90_device, seed=3)
    prefill = make_prefill_fn(cfg, 32, impl="kernel")
    counter = tfa.LAUNCHES["flash_attention"]
    before = counter.count
    with pytest.raises(RuntimeError):
        prefill(params, _prefill_inputs(cfg, 24, 0, sm90_device))
    assert prefill.graphs == {} and prefill.last is None
    assert counter.count - before == cfg.n_layers
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    x = torch.ones(4, device=sm90_device)
    assert float((x + 1).sum()) == 8.0


def test_cuda_prefill_graph_batch_server_tokens_equal_eager(sm90_device):
    """hymba: a server whose prefill is the graph and one whose prefill is
    the eager ``prefill_with_cache`` (``server.prefill_fn`` replaced) give
    the same tokens over three waves of 24, 16 and 24 tokens; the first
    two capture a prefill graph, the third replays the first's."""
    from repro_torch.serve.engine import prefill_with_cache
    cfg = get_arch("hymba-1.5b").reduced()

    class Eager:
        graphs, last, capture_s = {}, None, 0.0

        @torch.inference_mode()
        def __call__(self, p, inputs):
            return prefill_with_cache(p, cfg, inputs, 32, impl="kernel")

    params = TT.init_params(cfg, device=sm90_device, seed=1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (24, 24, 16, 16, 24, 24)]
    results = {}
    for name in ("graph", "eager"):
        server = BatchServer(params, cfg, n_slots=2, max_len=32,
                             device=sm90_device)
        if name == "eager":
            server.prefill_fn = Eager()
        for i, pr in enumerate(prompts):
            server.submit(Request(request_id=f"r{i}", prompt=pr,
                                  max_new_tokens=6))
        done = server.run(max_requests=6, idle_timeout_s=0.5)
        results[name] = [r.result_tokens for r in done]
        waves = server.waves
        assert [w["prompt_len"] for w in waves] == [24, 16, 24]
        if name == "graph":
            assert len(server.prefill_fn.graphs) == 2
            assert waves[0]["prefill_capture_s"] > 0
            assert waves[1]["prefill_capture_s"] > 0
            assert waves[2]["prefill_capture_s"] == 0.0
            assert waves[0]["prefill_nodes"] == waves[2]["prefill_nodes"]
            assert all(w["prefill_nodes"] >= w["prefill_kernels"] > 0
                       for w in waves)
        else:
            assert server.prefill_fn.graphs == {}
    assert results["graph"] == results["eager"]


def test_cuda_prefill_graph_memory_bounded_over_prompt_lengths(
        sm90_device):
    """mamba2-130m at full width through ``BatchServer``: 8 waves of 4
    prompts, each wave of another length (256 to 2,048 tokens, whole SSD
    chunks).  Its prefill function keeps the ``MAX_PREFILL_GRAPHS`` most
    recently used graphs, each holding its last-position logits and its
    cache, so after every wave the allocation beyond the weights stays
    within that many graphs' outputs, the decode graph's and 128 MiB:
    below what 8 graphs would hold, and far below what they would with
    their logits at every position."""
    from repro_torch.serve.engine import MAX_PREFILL_GRAPHS
    cfg = get_arch("mamba2-130m")
    params = TT.init_params(cfg, device=sm90_device, seed=4)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(sm90_device)
    lengths = [256 * i for i in range(1, 9)]
    server = BatchServer(params, cfg, n_slots=4, max_len=max(lengths) + 8,
                         device=sm90_device)
    rng = np.random.default_rng(4)
    held = []
    for n in lengths:
        for i in range(4):
            server.submit(Request(request_id=f"{n}-{i}", prompt=rng.integers(
                1, cfg.vocab_size, n).astype(np.int32), max_new_tokens=2))
        assert len(server.run(max_requests=4, idle_timeout_s=0.5)) == 4
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated(sm90_device) - base)
    fn = server.prefill_fn
    assert [w["prompt_len"] for w in server.waves] == lengths
    assert fn.captures == len(lengths)
    assert len(fn.graphs) == MAX_PREFILL_GRAPHS
    g = fn.last
    outputs = g.logits.numel() * g.logits.element_size() + sum(
        t.numel() * t.element_size() for t in g.cache.values())
    bound = (MAX_PREFILL_GRAPHS + 1) * outputs + 128 * 2 ** 20
    assert max(held) <= bound, (held, bound)
    assert (len(lengths) + 1) * outputs > bound
    every_position = sum(n * g.logits.numel() * 4 for n in lengths)
    assert every_position > 4 * bound


def test_cuda_prefill_graph_freed_with_its_function(sm90_device):
    """Dropping the last reference to a prefill function frees its
    graphs, their outputs and their pool at once, with the garbage
    collector off: the allocation returns to its level."""
    import gc
    from repro_torch.serve import make_prefill_fn
    cfg = get_arch("internlm2-1.8b").reduced()
    params = TT.init_params(cfg, device=sm90_device, seed=9)
    inp = _prefill_inputs(cfg, 24, 0, sm90_device)
    make_prefill_fn(cfg, 32, impl="kernel")(params, inp)   # warms cuBLAS
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(sm90_device)
    gc.disable()
    try:
        prefill = make_prefill_fn(cfg, 32, impl="kernel")
        out = prefill(params, inp)
        prefill(params, _prefill_inputs(cfg, 16, 1, sm90_device))
        assert torch.cuda.memory_allocated(sm90_device) > base
        del prefill, out
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(sm90_device) == base
    finally:
        gc.enable()


def test_cuda_graph_functions_free_a_dropped_params_tree(sm90_device):
    """ROADMAP C9 on the card: a prefill and a decode function called with
    tree A, A dropped by the caller, then called with tree B, hold B's
    graphs only.  internlm2-1.8b at full width cut to 2 layers (1.6 GB of
    params, against a few MB of graph outputs): the allocation comes back
    to what fresh functions called with B alone hold, A is freed, and
    every call is right."""
    import dataclasses
    import weakref
    from torch.utils import _pytree as pytree
    from repro_torch.serve import make_decode_fn, make_prefill_fn
    from repro_torch.serve.engine import prefill_with_cache
    cfg = dataclasses.replace(get_arch("internlm2-1.8b"), n_layers=2)
    inp = _prefill_inputs(cfg, 32, 0, sm90_device)
    step = _step_inputs(cfg, 1, 32, sm90_device)

    def serve(prefill, decode, params):
        _assert_prefill_is(prefill(params, inp), prefill, params, inp)
        with torch.inference_mode():
            _, cache = prefill_with_cache(params, cfg, inp, max_len=40,
                                          impl="kernel")
            want, _ = TT.decode_step(
                params, cfg, {k: v.clone() for k, v in cache.items()}, step)
            got, _ = decode(params, cache, step)
            assert torch.equal(got, want)
        assert prefill.last.params is params
        assert decode.last.params is params

    def functions():
        return (make_prefill_fn(cfg, 40, impl="kernel", last_only=True),
                make_decode_fn(cfg))

    b = TT.init_params(cfg, device=sm90_device, seed=2)
    serve(*functions(), b)                       # warms cuBLAS and the rest
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(sm90_device)
    fns = functions()
    serve(*fns, b)
    torch.cuda.synchronize()
    b_alone = torch.cuda.memory_allocated(sm90_device) - base
    del fns
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(sm90_device) <= base + 8 * 2 ** 20
    a = TT.init_params(cfg, device=sm90_device, seed=3)
    tree = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(a))
    gone = weakref.ref(a["embed"])
    fns = functions()
    serve(*fns, a)
    del a
    serve(*fns, b)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(sm90_device) - base
    assert gone() is None
    assert all(len(f.graphs) == 1 for f in fns)
    assert held <= b_alone + 8 * 2 ** 20, (held, b_alone)
    assert b_alone + 8 * 2 ** 20 < tree


# ---------------------------------------------------------------------------
# the train step as one CUDA graph a batch shape, params and optimizer
# state updated in place inside it
# ---------------------------------------------------------------------------


def _card_batches(batches, device):
    return [{k: v.to(device) for k, v in b.items()} for b in batches]


@pytest.mark.parametrize("arch,micro", [("internlm2-1.8b", 1),
                                        ("mamba2-130m", 1),
                                        ("qwen3-moe-235b-a22b", 1),
                                        ("internlm2-1.8b", 2)])
def test_cuda_train_graph_is_the_eager_step(sm90_device, arch, micro):
    """``make_train_fn`` on the card against its eager step
    (``make_train_step``) from the same params and state on the same 3
    batches: the first call (the eager warm-up on the capture stream)
    and two replays, every metric, and then every param and state leaf,
    bit for bit; one graph, whose returned trees are the function's own
    buffers, with ``state["step"]`` at 3."""
    from torch.utils import _pytree as pytree
    cfg, tc, TS, batches = _train_setup(arch, microbatches=micro)
    fn = TS.make_train_fn(cfg, tc)
    pe, se = TS.init_train_state(cfg, tc, seed=1, device=sm90_device)
    pg, sg = pytree.tree_map(torch.clone, (pe, se))
    own = pytree.tree_leaves((pg, sg))
    for i, b in enumerate(_card_batches(batches, sm90_device)):
        pe, se, want = fn.eager(pe, se, b)
        pg, sg, got = fn(pg, sg, b)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        assert pytree.tree_leaves((pg, sg)) == own
    for a, b in zip(own, pytree.tree_leaves((pe, se))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(sg["step"]) == 3
    assert len(fn.graphs) == 1 and fn.captures == 1
    g = fn.last
    assert g.capture_s > 0 and g.nodes >= g.kernels > 0


def test_cuda_train_graph_copies_a_foreign_tree_in(sm90_device):
    """Reduced internlm2-1.8b: after two steps of tree A, a call with tree
    B (another seed's params and state, as a resume brings) copies B into
    the function's buffers and steps it: the result equals the eager step
    of B bit for bit, the returned leaves stay the function's, and the
    function keeps no reference to B's leaves."""
    import weakref
    from torch.utils import _pytree as pytree
    cfg, tc, TS, batches = _train_setup()
    batches = _card_batches(batches, sm90_device)
    fn = TS.make_train_fn(cfg, tc)
    pa, sa = TS.init_train_state(cfg, tc, seed=1, device=sm90_device)
    for b in batches[:2]:
        pa, sa, _ = fn(pa, sa, b)
    own = pytree.tree_leaves((pa, sa))
    pb, sb = TS.init_train_state(cfg, tc, seed=2, device=sm90_device)
    pw, sw, want = fn.eager(pb, sb, batches[2])
    gone = weakref.ref(pb["embed"])
    p, s, got = fn(pb, sb, batches[2])
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert pytree.tree_leaves((p, s)) == own
    for a, b in zip(own, pytree.tree_leaves((pw, sw))):
        assert torch.equal(a, b)
    del pb, sb
    assert gone() is None
    assert len(fn.graphs) == 1


def test_cuda_train_graph_capture_that_syncs_raises(sm90_device,
                                                    monkeypatch):
    """A step that reads its loss on the host (``compute_grads`` patched
    to call ``.item()``) runs in the eager warm-up but cannot be
    captured: the call raises, no graph is kept, no result comes back
    from an eager fallback, and the card goes on working."""
    cfg, tc, TS, batches = _train_setup()
    compute_grads = TS.compute_grads

    def syncing(*args, **kwargs):
        grads, metrics = compute_grads(*args, **kwargs)
        metrics["loss"].item()
        return grads, metrics

    monkeypatch.setattr(TS, "compute_grads", syncing)
    fn = TS.make_train_fn(cfg, tc)
    params, state = TS.init_train_state(cfg, tc, seed=1, device=sm90_device)
    with pytest.raises(RuntimeError):
        fn(params, state, _card_batches(batches, sm90_device)[0])
    assert fn.graphs == {} and fn.last is None
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    x = torch.ones(4, device=sm90_device)
    assert float((x + 1).sum()) == 8.0


def test_cuda_train_graph_resume_equals_a_straight_run(sm90_device,
                                                       tmp_path):
    """``train_loop`` on the card, through the graph: reduced mamba2-130m,
    4 steps with a checkpoint, resumed to 8 (the restored trees copied
    into a new function's buffers), against a straight run to 8, params
    and state within 1e-6 (``chip_smoke.py``'s ``train_resume``)."""
    from torch.utils import _pytree as pytree
    from repro_torch.launch import train as TL
    from repro_torch.train import step as TS
    cfg = get_arch("mamba2-130m").reduced()
    tc = TS.TrainConfig(lr=1e-3, warmup=2, total_steps=8)
    kw = dict(batch=2, seq_len=32, device=sm90_device, log=lambda _: None)
    d = str(tmp_path / "ck")
    TL.train_loop(cfg, tc, steps=4, ckpt_dir=d, ckpt_every=4, **kw)
    logs = []
    res = TL.train_loop(cfg, tc, steps=8, ckpt_dir=d, ckpt_every=4,
                        **{**kw, "log": logs.append})
    assert "resumed from step 4" in logs
    straight = TL.train_loop(cfg, tc, steps=8, **kw)
    assert int(res[1]["step"]) == int(straight[1]["step"]) == 8
    for a, b in zip(pytree.tree_leaves(res[:2]),
                    pytree.tree_leaves(straight[:2])):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the GPipe step (stages in one process) and the int8 step (a one-rank NCCL
# group) as CUDA graphs: make_pp_train_fn, make_compressed_train_fn
# ---------------------------------------------------------------------------

STEP_GRAPHS = ["pp_graph", "int8_graph"]


@pytest.fixture
def nccl_group(sm90_device):
    """A one-rank NCCL default group on the card, destroyed after the
    test (and after the graphs the test made, which are its locals)."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()


def _step_graph(kind, request):
    """Reduced internlm2-1.8b's (cfg, tc, TS, 3 batches of 4 × 64, the
    compiled step of ``kind``): the GPipe step over 2 stages and 2
    microbatches, or the int8 step on a one-rank NCCL group."""
    from repro_torch.train import pipeline as PP
    if kind == "pp_graph":
        cfg, tc, TS, batches = _train_setup()
        fn = PP.make_pp_train_fn(cfg, tc, PP.PipelineConfig(2, 2))
    else:
        cfg, tc, TS, batches = _train_setup(grad_compression="int8_pod")
        fn = TS.make_compressed_train_fn(
            cfg, tc, request.getfixturevalue("nccl_group"))
    return cfg, tc, TS, batches, fn


@pytest.mark.parametrize("kind", STEP_GRAPHS)
def test_cuda_step_graph_is_the_eager_step(sm90_device, kind, request):
    """The compiled GPipe or int8 step against its eager step from the
    same params and state: three batches of 4 × 64 (a first call, the
    eager warm-up on the capture stream, then two replays), then two of
    4 × 32 (a second key's first call and a replay); every metric, and
    then every param and state leaf (the bf16 error buffers too), bit
    for bit; two graphs, whose returned trees are the function's own
    buffers."""
    from torch.utils import _pytree as pytree
    from repro_torch.data import make_batch_iterator
    cfg, tc, TS, batches, fn = _step_graph(kind, request)
    it = make_batch_iterator(cfg, 4, 32, seed=5, device="cpu")
    batches += [next(it), next(it)]
    pe, se = TS.init_train_state(cfg, tc, seed=1, device=sm90_device)
    pg, sg = pytree.tree_map(torch.clone, (pe, se))
    own = pytree.tree_leaves((pg, sg))
    for i, b in enumerate(_card_batches(batches, sm90_device)):
        pe, se, want = fn.eager(pe, se, b)
        pg, sg, got = fn(pg, sg, b)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        assert pytree.tree_leaves((pg, sg)) == own
    for a, b in zip(own, pytree.tree_leaves((pe, se))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(sg["step"]) == 5 and ("ef" in sg) == (kind == "int8_graph")
    assert len(fn.graphs) == 2 and fn.captures == 2
    g = fn.last
    assert g.capture_s > 0 and g.nodes >= g.kernels > 0


@pytest.mark.parametrize("kind", STEP_GRAPHS)
def test_cuda_step_graph_copies_a_foreign_tree_in(sm90_device, kind,
                                                  request):
    """After two steps of tree A, a call with tree B (another seed's
    params and state) copies B into the function's buffers and steps it:
    the result equals the eager step of B bit for bit, the returned
    leaves stay the function's, and B's leaves are not kept."""
    import weakref
    from torch.utils import _pytree as pytree
    cfg, tc, TS, batches, fn = _step_graph(kind, request)
    batches = _card_batches(batches, sm90_device)
    pa, sa = TS.init_train_state(cfg, tc, seed=1, device=sm90_device)
    for b in batches[:2]:
        pa, sa, _ = fn(pa, sa, b)
    own = pytree.tree_leaves((pa, sa))
    pb, sb = TS.init_train_state(cfg, tc, seed=2, device=sm90_device)
    pw, sw, want = fn.eager(pb, sb, batches[2])
    gone = weakref.ref(pb["embed"])
    p, s, got = fn(pb, sb, batches[2])
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert pytree.tree_leaves((p, s)) == own
    for a, b in zip(own, pytree.tree_leaves((pw, sw))):
        assert torch.equal(a, b)
    del pb, sb
    assert gone() is None
    assert len(fn.graphs) == 1


@pytest.mark.parametrize("kind", STEP_GRAPHS)
def test_cuda_step_graph_capture_that_syncs_raises(sm90_device, kind,
                                                   request, monkeypatch):
    """A step that reads its loss on the host (the GPipe loss, or the int8
    step's gradients before any collective, patched to call ``.item()``)
    runs in the eager warm-up but cannot be captured: the call raises, no
    graph is kept, nothing comes back from an eager fallback, and the
    card goes on working."""
    from repro_torch.train import pipeline as PP
    from repro_torch.train import step as TS
    if kind == "pp_graph":
        loss = PP._Handoff.loss

        def syncing(self, total, n_tokens):
            total.item()
            return loss(self, total, n_tokens)

        monkeypatch.setattr(PP._Handoff, "loss", syncing)
    else:
        grads = TS._grads

        def syncing(*args, **kwargs):
            g, metrics = grads(*args, **kwargs)
            metrics["loss"].item()
            return g, metrics

        monkeypatch.setattr(TS, "_grads", syncing)
    cfg, tc, TS, batches, fn = _step_graph(kind, request)
    params, state = TS.init_train_state(cfg, tc, seed=1, device=sm90_device)
    with pytest.raises(RuntimeError):
        fn(params, state, _card_batches(batches, sm90_device)[0])
    assert fn.graphs == {} and fn.last is None
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    x = torch.ones(4, device=sm90_device)
    assert float((x + 1).sum()) == 8.0


def test_cuda_pp_graph_refuses_two_stage_ranks(sm90_device):
    """The GPipe function over two stage ranks (a fake two-rank group,
    rank 0's stage) raises on a card batch, naming ROADMAP A9.5, before
    it adopts a tree; on the host it is the eager step's function."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.train import pipeline as PP
    cfg, tc, TS, batches = _train_setup()
    pc = PP.PipelineConfig(2, 2)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        fn = PP.make_pp_train_fn(cfg, tc, pc, group=dist.group.WORLD)
        params, state = PP.init_pp_state(cfg, tc, pc, stage=0, seed=1,
                                         device=sm90_device)
        with pytest.raises(RuntimeError, match="A9.5"):
            fn(params, state, _card_batches(batches, sm90_device)[0])
        assert fn.params is None and fn.graphs == {}
    finally:
        dist.destroy_process_group()


def test_cuda_int8_graph_refuses_dtensors(sm90_device, nccl_group):
    """The int8 function takes plain tensors on the card: params
    replicated as DTensors on a one-rank NCCL mesh (the dry-run's form,
    which runs on meta) raise before any launch."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.utils import _pytree as pytree
    cfg, tc, TS, batches = _train_setup(grad_compression="int8_pod")
    fn = TS.make_compressed_train_fn(cfg, tc, nccl_group)
    params, state = TS.init_train_state(cfg, tc, seed=1, device=sm90_device)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
    dparams = pytree.tree_map(
        lambda t: distribute_tensor(t, mesh, [Replicate()]), params)
    with pytest.raises(TypeError, match="plain"):
        fn(dparams, state, _card_batches(batches, sm90_device)[0])
    assert fn.params is None and fn.graphs == {}


def test_cuda_int8_graph_replays_beside_the_nccl_watchdog(sm90_device,
                                                          nccl_group):
    """The int8 graph's NCCL collectives replay while the group's
    watchdog runs: 20 replays with eager all-reduces and pauses of a few
    watchdog periods between them, each step equal to the eager step bit
    for bit, then an eager collective on the default stream and the
    group destroyed cleanly (by the fixture)."""
    import time
    import torch.distributed as dist
    from torch.utils import _pytree as pytree
    cfg, tc, TS, batches = _train_setup(grad_compression="int8_pod")
    fn = TS.make_compressed_train_fn(cfg, tc, nccl_group)
    pe, se = TS.init_train_state(cfg, tc, seed=1, device=sm90_device)
    pg, sg = pytree.tree_map(torch.clone, (pe, se))
    b = _card_batches(batches, sm90_device)[0]
    probe = torch.ones(8, device=sm90_device)
    for i in range(21):
        pe, se, want = fn.eager(pe, se, b)
        pg, sg, got = fn(pg, sg, b)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        dist.all_reduce(probe, group=nccl_group)
        if i % 5 == 0:
            torch.cuda.synchronize()
            time.sleep(0.3)
    for a, b in zip(pytree.tree_leaves((pg, sg)), pytree.tree_leaves((pe, se))):
        assert torch.equal(a, b)
    assert fn.captures == 1 and int(sg["step"]) == 21
    assert torch.equal(probe, torch.ones(8, device=sm90_device))


# ---------------------------------------------------------------------------
# the outlier models' compiled functions (ml.kmeans, ml.autoencoder,
# ml.isoforest): one CUDA graph a key, functional, thread-safe, the forest's
# generator seeded again before every replay
# ---------------------------------------------------------------------------


def _same_bits(a, b):
    """Two trees of tensors with the same structure, types, shapes and
    bits (a NaN equals a NaN of the same bits)."""
    from torch.utils import _pytree as pytree
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.is_floating_point():
            bits = {2: torch.int16, 4: torch.int32}[x.element_size()]
            x, y = x.view(bits), y.view(bits)
        assert torch.equal(x, y)


def _outlier_cases():
    """Each compiled function of the outlier models: (name, the raw
    function, seeded, and ``inputs(n, seed, device) -> (args, static)``
    giving a key per n)."""
    from repro_torch.ml import autoencoder as tae
    from repro_torch.ml import kmeans as tkm

    def points(n, seed, device):
        rng = np.random.default_rng(seed)
        return torch.as_tensor((rng.standard_normal((n, 32)) * 3)
                               .astype(np.float32), device=device)

    def ae_state(device):
        return AutoEncoder(device=device, seed=2).init()

    def km(impl, precision, fused):
        def inputs(n, seed, device):
            x = points(n, seed, device)
            cent, counts = x[:25].clone(), torch.arange(
                25, dtype=torch.float32, device=device)
            args = (cent, counts, x) if fused else (cent, x)
            return args, dict(impl=impl, precision=precision)
        return inputs

    def ae(name):
        def inputs(n, seed, device):
            st = ae_state(device)
            x = points(n, seed, device)
            if name == "step":
                return (st["params"], st["opt"], st["step"] + seed, x), {}
            return (st["params"], x), {}
        return inputs

    def fit(n, seed, device):
        return (points(n, seed, device),), dict(seed=0, n_trees=100, psi=256,
                                                max_depth=8)

    def score(n, seed, device):
        st = IsolationForest(device="cpu").fit(
            points(2_000, 99, "cpu").numpy())
        forest = {k: v.to(device) for k, v in st["forest"].items()}
        return (forest, points(n, seed, device),
                st["psi"].to(device)), dict(max_depth=8)

    step = tae._make_step(AutoEncoder(device="cpu")._opt)
    cases = [(f"assign_{i}_{p}", tkm._assign, False, km(i, p, False))
             for i in ("kernel", "fused", "twopass") for p in PRECISIONS]
    cases += [(f"assign_update_{i}_{p}", tkm._assign_update, False,
               km(i, p, True))
              for i in ("kernel", "fused", "twopass") for p in PRECISIONS]
    cases += [("ae_forward", tae.ae_forward, False, ae("forward")),
              ("ae_recon_error", tae.ae_recon_error, False, ae("recon")),
              ("ae_loss", tae.ae_loss, False, ae("loss")),
              ("ae_step", step, False, ae("step")),
              ("ae_scores", tae._scores, False, ae("scores")),
              ("iforest_fit", tif._fit, True, fit),
              ("iforest_score", tif._score, False, score)]
    return cases


OUTLIER_CASES = _outlier_cases()


@pytest.mark.parametrize("case", OUTLIER_CASES, ids=[c[0] for c in
                                                     OUTLIER_CASES])
def test_cuda_outlier_graph_is_the_eager_function(sm90_device, case):
    """Each compiled function on the card against its eager function on
    the same inputs: three calls of one key (the warm-up, then two
    replays), each with other values, and a call of a second key; every
    output bit for bit, every result a new tensor.  The fused plain form's
    sums add with float atomics, whose order varies from run to run: its
    centroids are held within 1e-5 of their scale, the rest bit for bit."""
    from repro_torch.graphs import GraphFn
    name, raw, seeded, inputs = case
    fn = GraphFn(raw, seeded=seeded)
    results = []
    for n, seed in ((2_000, 1), (2_000, 2), (2_000, 3), (700, 4)):
        args, static = inputs(n, seed, sm90_device)
        got = fn(*args, **static)
        want = fn.eager(*args, **static)
        if name.startswith("assign_update_fused"):
            torch.testing.assert_close(got[0], want[0], rtol=1e-5,
                                       atol=1e-5)
            _same_bits(got[1:], want[1:])
        else:
            _same_bits(got, want)
        results.append(got)
    assert fn.captures == 2 and len(fn.graphs) == 2
    g = fn.last
    assert g.capture_s > 0 and g.nodes >= g.kernels > 0
    from torch.utils import _pytree as pytree
    first, second = (pytree.tree_leaves(r) for r in results[1:3])
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(first, second))


def test_cuda_outlier_graph_forest_replays_the_eager_fit(sm90_device):
    """The forest's fit through its graph: the warm-up and two replays on
    one message, then a replay on another message of the same shape, each
    the eager fit's forest (a new generator seeded with the same seed) bit
    for bit, NaN thresholds included: the graph's generator is seeded
    again before every replay, so no replay draws past the first."""
    from repro_torch.graphs import GraphFn
    fn = GraphFn(tif._fit, seeded=True)
    gen = MiniAppGenerator(n_points=5_000, seed=3)
    a, b = (torch.as_tensor(gen.sample(), dtype=torch.float32,
                            device=sm90_device) for _ in range(2))
    static = dict(seed=0, n_trees=100, psi=256, max_depth=8)
    for x in (a, a, a, b):
        _same_bits(fn(x, **static), fn.eager(x, **static))
    assert fn.captures == 1
    proc = IsolationForest(device=sm90_device)
    eager = IsolationForest(device=sm90_device, graph=False)
    for msg in (a, b, a):
        _same_bits(proc.fit(msg.cpu().numpy()), eager.fit(msg.cpu().numpy()))


def test_cuda_outlier_graph_concurrent_replays(sm90_device):
    """Four threads call one compiled function at once, each on its own
    inputs: first all on a key none has captured (one capture; the three
    others replay it), then 10 calls each on that key; every result is
    what its inputs give serially, eagerly, bit for bit."""
    import threading
    from repro_torch.graphs import GraphFn
    from repro_torch.ml import autoencoder as tae
    ae = AutoEncoder(device=sm90_device)
    fn = GraphFn(tae._make_update(tae._make_step(ae._opt)))
    st = ae.init()
    rng = np.random.default_rng(5)
    msgs = [[torch.as_tensor(rng.standard_normal((1_000, 32)).astype(
        np.float32), device=sm90_device) for _ in range(11)]
        for _ in range(4)]
    got = [[] for _ in range(4)]
    barrier = threading.Barrier(4, timeout=60)
    errors = []

    def worker(w):
        try:
            for i, x in enumerate(msgs[w]):
                if i < 2:
                    barrier.wait()
                got[w].append(fn(st["params"], st["opt"], st["step"], x,
                                 epochs=1))
        except BaseException as err:            # noqa: BLE001
            errors.append(err)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    torch.cuda.synchronize()
    assert fn.captures == 1 and len(fn.graphs) == 1
    for w in range(4):
        for x, out in zip(msgs[w], got[w]):
            _same_bits(out, fn.eager(st["params"], st["opt"], st["step"], x,
                                     epochs=1))


def test_cuda_outlier_graph_workers_lose_updates_as_the_reference(
        sm90_device):
    """tests/test_torch_autoencoder.py's lock-step test on the card,
    through the compiled update: four workers that share one processor's
    state without a lock keep one step a round."""
    import threading
    ae = AutoEncoder(device=sm90_device)
    ps = ParameterService()
    ps.publish("ae", ae.init())
    barrier = threading.Barrier(4, timeout=60)
    update = ae.update

    def lock_step(state, points):
        barrier.wait()
        return update(state, points)

    ae.update = lock_step
    proc = ae.make_processor(ps, "ae")
    gen = MiniAppGenerator(n_points=500, seed=40)
    pts = [gen.sample() for _ in range(12)]

    def worker(w):
        for r in range(3):
            proc(None, data=pts[r * 4 + w])

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    version, tree = ps.fetch("ae")
    assert version == 13 and int(tree["step"]) == 3
    assert ae._update.captures == 1


def test_cuda_outlier_graph_capture_that_syncs_raises(sm90_device):
    """A function that reads a value on the host runs in the eager
    warm-up but cannot be captured: the call raises, no graph is kept, no
    result comes back from an eager fallback, and the card goes on
    working."""
    from repro_torch.graphs import GraphFn

    def syncing(x):
        return x * float(x.sum())

    fn = GraphFn(syncing)
    with pytest.raises(RuntimeError):
        fn(torch.ones(8, device=sm90_device))
    assert fn.graphs == {} and fn.last is None and fn.captures == 0
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    x = torch.ones(4, device=sm90_device)
    assert float((x + 1).sum()) == 8.0


@pytest.mark.parametrize("fused", [True, False])
def test_cuda_outlier_graph_counts_kmeans_launches(sm90_device, fused):
    """The k-means kernel inside a graph: its warm-up launches it once
    (counted by the wrapper), the capture counts none, and each of three
    replays adds one launch to its own form's counter, read from the
    graph's kernel nodes by their mangled template arguments; the other
    form's counter stays at 0."""
    from repro_torch.graphs import GraphFn
    from repro_torch.ml import kmeans as tkm
    fn = GraphFn(tkm._assign_update if fused else tkm._assign)
    mine = tk.LAUNCHES["kmeans_assign_update" if fused else "kmeans_assign"]
    other = tk.LAUNCHES["kmeans_assign" if fused else "kmeans_assign_update"]
    for c in tk.LAUNCHES.values():
        c.reset()
    for seed in range(4):
        x, c = _blob((10_000, 32, 25), sm90_device, seed)
        args = (c, torch.zeros(25, device=sm90_device), x) if fused \
            else (c, x)
        fn(*args, impl="kernel", precision="fp32")
    torch.cuda.synchronize()
    assert mine.count == 4 and other.count == 0
    assert dict(fn.last.launches) == {mine: 1} == dict(fn.last.counted)


# decode attention: (batch, slots, kv heads, query heads a group, head_dim,
# cache type, inputs' type, rope: "shared" / "rows" (M-RoPE) / None, ring)
DECODE_ATTENTION_CASES = [
    (2, 96, 2, 1, 64, "bf16", "fp32", "shared", False),
    (2, 96, 2, 5, 64, "bf16", "fp32", "shared", True),
    (2, 96, 1, 16, 64, "fp32", "fp32", "rows", False),
    (2, 160, 2, 1, 128, "fp32", "fp32", None, True),
    (3, 160, 2, 5, 128, "bf16", "bf16", "rows", False),
    (2, 160, 1, 16, 128, "bf16", "fp32", "shared", True),
    (2, 64, 2, 1, 192, "bf16", "fp32", "shared", False),
    (2, 64, 1, 5, 192, "fp32", "bf16", None, False),
    (2, 64, 1, 16, 192, "bf16", "fp32", "rows", True),
    (2, 64, 2, 2, 64, "bf16", "fp32", "shared", False),
    (2, 128, 2, 4, 128, "bf16", "fp32", "shared", False),
    (2, 128, 2, 6, 128, "bf16", "fp32", "rows", False),
    (2, 128, 2, 7, 128, "bf16", "fp32", "shared", False),
    (2, 96, 2, 12, 192, "bf16", "fp32", "shared", False),
    (2, 48, 2, 2, 16, "bf16", "fp32", "shared", True),
    (16, 1280, 5, 5, 64, "bf16", "fp32", "shared", False),   # decode_heavy
]
_TYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _decode_attention_inputs(case, device, seed=0):
    b, s, hkv, rep, d, cache_t, q_t, rope, _ = case
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=device).to(dtype)
    q = rnd(b, hkv * rep, d, dtype=_TYPES[q_t])
    k, v = (rnd(b, hkv, d, dtype=_TYPES[q_t]) for _ in range(2))
    kc, vc = (rnd(b, s, hkv, d, dtype=_TYPES[cache_t]) for _ in range(2))
    cos = sin = None
    if rope is not None:
        ang = rnd(b if rope == "rows" else 1, 1, d // 2) * 3.0
        cos, sin = torch.cos(ang), torch.sin(ang)
    return q, k, v, kc, vc, cos, sin


@pytest.mark.parametrize("case", DECODE_ATTENTION_CASES)
def test_cuda_decode_attention_matches_plain(sm90_device, case):
    """The kernel against its plain version on the same card inputs, at
    one valid key, mid-cache, a full cache and (for a ring) a position
    past the wrap, the slot the step writes holding a stale row far from
    the new k and v: the slot written with the same bits, the output
    within one rounding of the cache's type (the sums run in another
    order): for bf16, 2^-7 of the value and 2^-8 of the largest value;
    for fp32, 1e-5 of each."""
    b, s, hkv, rep, d, cache_t, q_t, rope, ring = case
    q, k, v, kc, vc, cos, sin = _decode_attention_inputs(case, sm90_device)
    lengths = [0, s // 2 + 3, s - 1] + ([s + 7, 3 * s + s // 3] if ring
                                        else [])
    rtol, of_scale = (2.0 ** -7, 2.0 ** -8) if cache_t == "bf16" else (
        1e-5, 1e-5)
    for n in lengths:
        widx = tda.ring_slot(n, s, ring)[0]
        kc[:, widx], vc[:, widx] = 40.0, -40.0
        length = torch.tensor(n, dtype=torch.int32, device=sm90_device)
        before = tda.LAUNCHES["decode_attention"].count
        kk, vk = kc.clone(), vc.clone()
        got = ops.decode_attention(q, k, v, kk, vk, length, cos, sin,
                                   ring=ring)
        assert tda.LAUNCHES["decode_attention"].count == before + 1
        kp, vp = kc.clone(), vc.clone()
        want = tda.plain(q, k, v, kp, vp, n, cos, sin, ring=ring)
        torch.cuda.synchronize()
        assert got.shape == (b, 1, hkv * rep * d) and got.dtype == want.dtype
        assert torch.equal(kk, kp) and torch.equal(vk, vp), n
        want = want.float().cpu().numpy()
        np.testing.assert_allclose(got.float().cpu().numpy(), want,
                                   rtol=rtol,
                                   atol=of_scale * np.abs(want).max())
        kc.copy_(kp)
        vc.copy_(vp)


def test_cuda_decode_attention_repeats_its_bits(sm90_device):
    """Two launches on the same inputs give the same bits: no atomics, the
    cluster's partial sums added in rank order."""
    case = DECODE_ATTENTION_CASES[-1]
    q, k, v, kc, vc, cos, sin = _decode_attention_inputs(case, sm90_device)
    length = torch.tensor(767, dtype=torch.int64, device=sm90_device)
    outs = [ops.decode_attention(q, k, v, kc, vc, length, cos, sin,
                                 ring=False) for _ in range(3)]
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_cuda_decode_attention_refuses_what_it_does_not_take(sm90_device):
    """A head_dim the kernel does not take, or scores that fit no cluster's
    shared memory, raise before any launch, naming the limit."""
    case = (1, 64, 1, 4, 64, "bf16", "fp32", "shared", False)
    q, k, v, kc, vc, cos, sin = _decode_attention_inputs(case, sm90_device)
    length = torch.tensor(3, device=sm90_device)
    with pytest.raises(ValueError, match="multiple of 16"):
        tda.launch(q[..., :40], k[..., :40], v[..., :40], kc[..., :40],
                   vc[..., :40], length, cos[..., :20], sin[..., :20],
                   ring=False)
    big = torch.zeros((1, 131072, 1, 64), dtype=torch.bfloat16,
                      device=sm90_device)
    q16 = torch.zeros((1, 16, 64), device=sm90_device)
    with pytest.raises(ValueError, match="shared memory"):
        tda.launch(q16, k, v, big, big.clone(), length, cos, sin, ring=False)
    with pytest.raises(ValueError, match="1 to 16 query heads"):
        tda.launch(torch.zeros((1, 17, 64), device=sm90_device), k, v, kc,
                   vc, length, cos, sin, ring=False)


def test_cuda_decode_graph_runs_one_attention_kernel_a_layer(sm90_device):
    """hymba-1.5b at full width and 2 layers: the decode graph with
    ``impl="kernel"`` holds one decode attention launch a layer, read
    from its kernel nodes and counted at its capture, and at least 25
    fewer kernel nodes a layer than the op-by-op step's graph; its replays
    give the eager kernel step's bits, and each adds its launches to the
    counter."""
    import dataclasses
    from repro_torch.serve import make_decode_fn
    cfg = dataclasses.replace(get_arch("hymba-1.5b"), n_layers=2)
    params = TT.init_params(cfg, device=sm90_device, seed=3)
    counter = tda.LAUNCHES["decode_attention"]
    ssm_counter = tsd.LAUNCHES["ssm_decode"]
    graphs = {}
    for impl in ("dense", "kernel"):
        # its own generator: a capture that failed in an earlier test can
        # leave the default one unable to draw outside a capture
        gen = torch.Generator(device=sm90_device).manual_seed(5)
        cache = TT.init_cache(cfg, 4, 96, device=sm90_device)
        cache["conv"] = cache["conv"].float()
        for name in ("k", "v", "conv", "ssm"):
            cache[name].normal_(generator=gen)
        eager = {n: t.clone() for n, t in cache.items()}
        decode = make_decode_fn(cfg, impl)
        before, ssm_before = counter.count, ssm_counter.count
        for pos in range(40, 44):
            inp = {"tokens": torch.full((4, 1), pos, device=sm90_device),
                   "length": torch.tensor(pos, dtype=torch.int32,
                                          device=sm90_device)}
            with torch.inference_mode():
                got, cache = decode(params, cache, inp)
                got = got.clone()
                want, eager = TT.decode_step(params, cfg, eager, inp,
                                             impl=impl)
            assert torch.equal(got, want), (impl, pos)
        for name, t in eager.items():
            assert torch.equal(cache[name], t), (impl, name)
        g = graphs[impl] = decode.last
        torch.cuda.synchronize()
        launches = {c.symbols: n for c, n in g.launches}
        if impl == "kernel":
            # the hybrid layer's SSM step is one fused launch too
            assert launches == {counter.symbols: cfg.n_layers,
                                ssm_counter.symbols: cfg.n_layers}
            assert dict(g.counted) == dict(g.launches)
            # the eager steps 4, the warm-up 1, three replays: a step each
            assert counter.count - before == 8 * cfg.n_layers
            assert ssm_counter.count - ssm_before == 8 * cfg.n_layers
        else:
            assert counter.symbols not in launches
            assert ssm_counter.symbols not in launches
            assert counter.count == before
            assert ssm_counter.count == ssm_before
    fewer = graphs["dense"].kernels - graphs["kernel"].kernels
    assert fewer >= 25 * cfg.n_layers, (graphs["dense"].kernels,
                                        graphs["kernel"].kernels)
    # the hybrid layer's SSM step: its region holds fewer nodes fused
    dense, kernel = (graphs[i].span_nodes["mixer.ssm"]
                     for i in ("dense", "kernel"))
    assert 0 < kernel < dense, (kernel, dense)


# granite-4.0-h-small's attention: no rope, 32/8 heads of 128, a 768-slot
# bf16 cache, the scores times its attention multiplier 1/128
GRANITE_ATTENTION = (4, 768, 8, 4, 128, "bf16", "fp32", None, False)


def test_cuda_decode_attention_takes_a_scale_without_rope(sm90_device):
    """The kernel with ``scale`` 1/128 and no rope at granite's shape,
    against its plain version with the same scale: the slot written with
    the same bits, the output within one bf16 rounding (as
    ``test_cuda_decode_attention_matches_plain``); and the scale is used
    (the default 1/√128 gives other values)."""
    q, k, v, kc, vc, _, _ = _decode_attention_inputs(GRANITE_ATTENTION,
                                                     sm90_device)
    q = q * 8.0                 # scores wide enough that the scale shows
    for n in (0, 383, 767):
        length = torch.tensor(n, dtype=torch.int32, device=sm90_device)
        kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        got = ops.decode_attention(q, k, v, kk, vk, length, None, None,
                                   ring=False, scale=1 / 128)
        want = tda.plain(q, k, v, kp, vp, n, None, None, ring=False,
                         scale=1 / 128)
        plain_default = tda.plain(q, k, v, kc.clone(), vc.clone(), n, None,
                                  None, ring=False)
        torch.cuda.synchronize()
        assert torch.equal(kk, kp) and torch.equal(vk, vp), n
        want = want.float().cpu().numpy()
        np.testing.assert_allclose(got.float().cpu().numpy(), want,
                                   rtol=2.0 ** -7,
                                   atol=2.0 ** -8 * np.abs(want).max())
        if n:
            assert not np.allclose(plain_default.float().cpu().numpy(),
                                   want, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_takes_a_scale(sm90_device, dtype):
    """The flash kernel with ``scale`` 1/128 at granite's heads (32/8 of
    128) against the plain version with the same scale, within
    ``_flash_tol``; the default scale's result differs."""
    g = torch.Generator(device=sm90_device).manual_seed(11)
    q = _randn(g, (2, 257, 32, 128), sm90_device, dtype) * 4
    k = _randn(g, (2, 257, 8, 128), sm90_device, dtype)
    v = _randn(g, (2, 257, 8, 128), sm90_device, dtype)
    out = ops.flash_attention(q, k, v, causal=True, scale=1 / 128)
    want = tfa.plain(q, k, v, causal=True, scale=1 / 128)
    default = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), **_flash_tol(want))
    assert not torch.allclose(default.float(), want.float(), rtol=1e-2,
                              atol=1e-2)


def test_cuda_granite_decode_graph_counts_its_regions(sm90_device):
    """granite-4.0-h-small at its widths and 4 layers (Mamba2, attention,
    Mamba2, Mamba2; 9 of 72 experts, dropless): the decode graph's
    replays give the eager step's bits; its capture records the kernel
    nodes of each region, every region holding some and together no more
    than the graph; the routed pairs it adds on the device at each replay
    are the eager step's, in one node a layer outside the regions (a
    graph captured without a counter has the same regions' nodes and 4
    kernel nodes fewer)."""
    import dataclasses
    from repro_torch.models import layers as TL
    from repro_torch.serve import make_decode_fn
    cfg = dataclasses.replace(
        get_arch("granite-4.0-h-small"), n_layers=4,
        layer_types=("mamba", "attention", "mamba", "mamba"))
    params = TT.init_params(cfg, device=sm90_device, seed=3)
    gen = torch.Generator(device=sm90_device).manual_seed(5)
    cache = TT.init_cache(cfg, 4, 96, device=sm90_device)
    cache["conv"] = cache["conv"].float()
    for t in cache.values():
        t.normal_(generator=gen)
    eager = {n: t.clone() for n, t in cache.items()}
    uncounted = {n: t.clone() for n, t in cache.items()}
    decode, plain = make_decode_fn(cfg, "kernel"), make_decode_fn(cfg,
                                                                  "kernel")
    zero = lambda: torch.zeros((), dtype=torch.int64, device=sm90_device)
    counter, eager_counter = zero(), zero()
    for pos in range(40, 44):
        inp = {"tokens": torch.full((4, 1), pos, device=sm90_device),
               "length": torch.tensor(pos, dtype=torch.int32,
                                      device=sm90_device)}
        with torch.inference_mode():
            with TL.counting(counter):
                got, cache = decode(params, cache, inp)
            got = got.clone()
            with TL.counting(eager_counter):
                want, eager = TT.decode_step(params, cfg, eager, inp,
                                             impl="kernel")
            bare, uncounted = plain(params, uncounted, inp)
        assert torch.equal(got, want), pos
        assert torch.equal(bare, want), pos
    g, h = decode.last, plain.last
    torch.cuda.synchronize()
    assert set(g.span_nodes) == {"mixer.attn", "mixer.ssm", "moe.route",
                                 "moe.experts", "moe.shared"}
    assert all(n > 0 for n in g.span_nodes.values()), g.span_nodes
    assert sum(g.span_nodes.values()) <= g.kernels
    assert g.span_nodes == h.span_nodes
    assert g.kernels == h.kernels + 4
    assert int(counter) == int(eager_counter) > 0


# the SSM decode step: (b, heads, head_dim, d_state, groups) at
# granite-4.0-h-small's batch_decode layer and hymba-1.5b's decode_heavy one
SSM_DECODE_CASES = [(32, 128, 64, 128, 1), (16, 50, 64, 16, 1)]
# the other instances: bf16 with two groups, the tiny widths
SSM_DECODE_MORE = [((4, 32, 64, 128, 2), torch.bfloat16),
                   ((3, 16, 16, 16, 2), torch.bfloat16),
                   ((2, 8, 16, 128, 1), torch.float32),
                   ((5, 12, 16, 16, 3), torch.float32)]


def _ssm_decode_inputs(case, device, seed=0, dtype=torch.float32):
    """xbc and dt_raw as strided views of one in-projection row (as
    ``layers.ssm_decode`` passes them), a d_conv 4 window, an fp32 state,
    the conv's weight and bias, dt_bias, A_log (log 1..nh) and D."""
    b, nh, hd, ds, ng = case
    conv_dim = nh * hd + 2 * ng * ds
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=device)  # noqa
    proj = mk(b, conv_dim + nh + 3).to(dtype)
    return dict(
        xbc=proj[:, :conv_dim], dt_raw=proj[:, conv_dim:conv_dim + nh],
        conv_state=mk(b, 3, conv_dim).to(dtype), ssm_state=mk(b, nh, hd, ds),
        conv_w=(mk(4, conv_dim) * 0.5).to(dtype),
        conv_b=(mk(conv_dim) * 0.1).to(dtype), dt_bias=mk(nh) * 0.5 - 3.0,
        A_log=torch.log(torch.arange(1, nh + 1, device=device,
                                     dtype=torch.float32)),
        D=mk(nh)), ng


def _ssm_close(got, want):
    """Kernel against plain, within the kernel's ``tolerance``."""
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tsd.tolerance(want)).all()), float(diff.max())


@pytest.mark.parametrize("case,dtype", [(c, torch.float32)
                                        for c in SSM_DECODE_CASES]
                         + SSM_DECODE_MORE)
def test_cuda_ssm_decode_matches_plain(sm90_device, case, dtype):
    """The kernel against its plain version on the card, four consecutive
    steps each on its own copies of the states: the shifted window bit for
    bit, the state and y within :func:`_ssm_close`; one launch counted a
    call."""
    a, ng = _ssm_decode_inputs(case, sm90_device, sum(case), dtype)
    mine = {k: a[k].clone() for k in ("conv_state", "ssm_state")}
    counter = tsd.LAUNCHES["ssm_decode"]
    for step in range(4):
        a["xbc"].mul_(-1.0 if step % 2 else 1.0)
        before = counter.count
        got = ops.ssm_decode(a["xbc"], a["dt_raw"], mine["conv_state"],
                             mine["ssm_state"], a["conv_w"], a["conv_b"],
                             a["dt_bias"], a["A_log"], a["D"], n_groups=ng)
        assert counter.count == before + 1
        want = tsd.plain(**a, n_groups=ng)
        torch.cuda.synchronize()
        assert torch.equal(mine["conv_state"], a["conv_state"]), step
        _ssm_close(mine["ssm_state"], a["ssm_state"])
        _ssm_close(got, want)


@pytest.mark.parametrize("case", SSM_DECODE_CASES)
def test_cuda_ssm_decode_graph_replays_are_the_eager_launches(sm90_device,
                                                              case):
    """One launch captured in a CUDA graph and replayed over 8 positions,
    each with new xbc and dt_raw copied into its static inputs, against
    eager launches on copies of the states: y, the state and the window
    bit for bit at every position (a race on the group's shared B and C
    window, or a state the graph no longer writes, would show), and the
    window bit for bit the plain version's."""
    a, ng = _ssm_decode_inputs(case, sm90_device, 5)
    eager = {k: a[k].clone() for k in ("conv_state", "ssm_state")}
    plain = {k: a[k].clone() for k in ("conv_state", "ssm_state")}
    run = lambda: tsd.launch(**a, n_groups=ng)  # noqa
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    saved = {k: a[k].clone() for k in ("conv_state", "ssm_state")}
    with torch.cuda.stream(side):
        run()                                   # builds and loads
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    for k, t in saved.items():                  # undo the warm-up's step
        a[k].copy_(t)
    g = torch.Generator(device=sm90_device).manual_seed(9)
    for pos in range(8):
        xbc = torch.randn(a["xbc"].shape, generator=g, device=sm90_device)
        dt_raw = torch.randn(a["dt_raw"].shape, generator=g,
                             device=sm90_device)
        a["xbc"].copy_(xbc)
        a["dt_raw"].copy_(dt_raw)
        graph.replay()
        want = tsd.launch(xbc, dt_raw, eager["conv_state"],
                          eager["ssm_state"], a["conv_w"], a["conv_b"],
                          a["dt_bias"], a["A_log"], a["D"], n_groups=ng)
        ref = tsd.plain(xbc, dt_raw, plain["conv_state"], plain["ssm_state"],
                        a["conv_w"], a["conv_b"], a["dt_bias"], a["A_log"],
                        a["D"], n_groups=ng)
        torch.cuda.synchronize()
        assert torch.equal(out, want), pos
        for k in ("conv_state", "ssm_state"):
            assert torch.equal(a[k], eager[k]), (pos, k)
        assert torch.equal(a["conv_state"], plain["conv_state"]), pos
        _ssm_close(a["ssm_state"], plain["ssm_state"])
        _ssm_close(out, ref)
    del graph


def _kernel_node(node):
    """(mangled name, threads launched) of a captured graph's kernel
    node."""
    from repro_torch import graphs
    cu = ctypes.CDLL("libcuda.so.1")
    p, name = graphs._KernelNodeParams(), ctypes.c_char_p()
    assert cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                            ctypes.byref(p)) == 0
    err = (cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func))
           if p.func else cu.cuKernelGetName(ctypes.byref(name),
                                             ctypes.c_void_p(p.kern)))
    assert err == 0 and name.value is not None
    threads = (p.grid[0] * p.grid[1] * p.grid[2]
               * p.block[0] * p.block[1] * p.block[2])
    return name.value.decode(), threads


def test_cuda_decode_graph_runs_one_ssm_kernel_a_layer(sm90_device,
                                                       monkeypatch):
    """granite-4.0-h-small at its widths and 4 layers (3 Mamba2): with
    ``impl="kernel"`` each ``mixer.ssm`` region of the decode graph holds
    exactly one ``ssm_decode`` kernel node and no elementwise or copy node
    as wide as the layer's state (the op-by-op graph's regions hold such
    nodes, so the test sees them), read from the captured graph's nodes;
    the regions hold at least 60% fewer kernel nodes than the op-by-op
    graph's; the replays give the eager kernel step's bits, and every step
    counts one launch a Mamba2 layer."""
    import dataclasses
    from repro_torch import spans as tspans
    from repro_torch.serve import make_decode_fn
    cfg = dataclasses.replace(
        get_arch("granite-4.0-h-small"), n_layers=4,
        layer_types=("mamba", "attention", "mamba", "mamba"))
    params = TT.init_params(cfg, device=sm90_device, seed=3)
    seen = []
    exit_ = tspans._Region.__exit__

    def recording_exit(self, *exc):
        if exc[0] is None:
            seen.append((self.name, self.tally.read() - self.before))
        return exit_(self, *exc)

    monkeypatch.setattr(tspans._Region, "__exit__", recording_exit)
    counter = tsd.LAUNCHES["ssm_decode"]
    b, n_mamba = 4, 3
    state_numel = b * 128 * 64 * 128
    regions, graphs = {}, {}
    for impl in ("dense", "kernel"):
        gen = torch.Generator(device=sm90_device).manual_seed(5)
        cache = TT.init_cache(cfg, b, 96, device=sm90_device)
        cache["conv"] = cache["conv"].float()
        for t in cache.values():
            t.normal_(generator=gen)
        eager = {n: t.clone() for n, t in cache.items()}
        decode = make_decode_fn(cfg, impl)
        del seen[:]
        before = counter.count
        for pos in range(40, 44):
            inp = {"tokens": torch.full((b, 1), pos, device=sm90_device),
                   "length": torch.tensor(pos, dtype=torch.int32,
                                          device=sm90_device)}
            with torch.inference_mode():
                got, cache = decode(params, cache, inp)
                got = got.clone()
                want, eager = TT.decode_step(params, cfg, eager, inp,
                                             impl=impl)
            assert torch.equal(got, want), (impl, pos)
        for name, t in eager.items():
            assert torch.equal(cache[name], t), (impl, name)
        torch.cuda.synchronize()
        graphs[impl] = decode.last
        regions[impl] = [[_kernel_node(n) for n in nodes]
                         for name, nodes in seen if name == "mixer.ssm"]
        assert len(regions[impl]) == n_mamba, impl
        wide = [[(k, t) for k, t in r if 16 * t >= state_numel and any(
            w in k for w in ("elementwise", "reduce", "Cat", "copy"))]
            for r in regions[impl]]
        ssm = [[k for k, _ in r if counter.counts(k)] for r in regions[impl]]
        if impl == "kernel":
            assert all(len(s) == 1 for s in ssm), ssm
            assert wide == [[]] * n_mamba, wide
            # the eager steps 4, the warm-up 1, three replays
            assert counter.count - before == 8 * n_mamba
        else:
            assert ssm == [[]] * n_mamba
            assert all(len(w) >= 3 for w in wide), wide
            assert counter.count == before
    dense, kernel = (graphs[i].span_nodes["mixer.ssm"]
                     for i in ("dense", "kernel"))
    assert kernel <= 0.4 * dense, (kernel, dense)


def test_cuda_a_capture_outlives_a_collection_of_cyclic_graphs(
        sm90_device):
    """A graph left in a reference cycle is freed by the collector, which
    may run inside a later capture (here ``fn`` runs it): that capture
    still ends and replays, since ``_captured`` collects before it
    begins."""
    import gc
    from repro_torch import graphs
    stream = graphs._capture_stream(sm90_device)
    x = torch.ones(4, device=sm90_device)

    class Holder:
        pass
    held = Holder()
    held.graph = graphs._captured(stream, lambda: x * 2)[0]
    held.me = held                       # a cycle only the collector frees
    del held

    def collecting():
        gc.collect()
        return x + 1
    graph, out, _ = graphs._captured(stream, collecting)
    x.fill_(2.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full((4,), 3.0, device=sm90_device))


def test_cuda_a_failed_capture_leaves_the_default_generator_drawing(
        sm90_device):
    """A capture that fails (a host read inside it) raises its own error,
    and the device's default generator then draws outside a capture again,
    from the seed and offset it had."""
    from repro_torch import graphs
    torch.cuda.manual_seed(123)
    torch.randn(8, device=sm90_device)
    gen = torch.cuda.default_generators[sm90_device.index or 0]
    seed, offset = gen.initial_seed(), gen.get_offset()
    x = torch.ones(4, device=sm90_device)
    with pytest.raises(Exception):
        graphs._captured(graphs._capture_stream(sm90_device),
                         lambda: float(x.sum()))
    assert (gen.initial_seed(), gen.get_offset()) == (seed, offset)
    got = torch.randn(8, device=sm90_device)
    torch.cuda.manual_seed(123)
    torch.randn(8, device=sm90_device)
    assert torch.equal(got, torch.randn(8, device=sm90_device))
