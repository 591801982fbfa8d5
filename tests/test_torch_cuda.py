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
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import kmeans as tk
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as tssd
from repro_torch.ml import (AutoEncoder, IsolationForest, KMeans,
                            MiniAppGenerator)
from repro_torch.ml import isoforest as tif
from repro_torch.models import transformer as TT
from repro_torch.serve import BatchServer, Request

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
# width from 16 to 256, and hymba's GQA ratio 25/5
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
               (2, 257, 257, 25, 5, 128, True, None)]
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
