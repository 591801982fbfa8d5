"""The port's k-means kernel module against the JAX reference: int8
quantization exact, and the kernel's plain version (what a CPU tensor
takes) against the Pallas kernel in interpret mode on the reference's
fused-kernel cases at every precision.  The CUDA kernel itself runs only
on an sm_90 card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
it against the plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kmeans as jk
from repro.kernels import quant as jquant
from repro_torch.kernels import kmeans as tk
from repro_torch.kernels import ops, quant, ref

PRECISIONS = ("fp32", "bf16", "int8")
# the reference's fused-kernel cases, tests/test_kernels.py:181; then the
# edges of the CUDA kernel's tiles: F and K across its 32-padding, one
# feature and one centroid, and ragged 64-row tiles
FUSED_CASES = [(257, 7, 3), (1000, 32, 25), (25, 32, 25), (513, 128, 128),
               (2500, 32, 25), (300, 33, 33), (65, 1, 1), (129, 64, 40)]
# dmin: the expansion ||x||²−2x·c+||c||² cancels at d ≈ 0 (the centroids
# are sample points), so the absolute floor is sqrt(eps·||x||²); the bound
# of tests/test_ml.py:75-79
DMIN_TOL = dict(atol=0.05, rtol=1e-3)
SUMS_TOL = dict(rtol=1e-5, atol=1e-4)


def _blob(case, seed=0):
    n, f, k = case
    rng = np.random.default_rng(seed + n + 7 * f + 13 * k)
    pts = (rng.standard_normal((n, f)) * 5).astype(np.float32)
    return pts, pts[:k].copy()


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def test_quant_matches_reference_exactly():
    pts, cent = _blob((500, 16, 8))
    s_t = quant.symmetric_scales(torch.from_numpy(pts), torch.from_numpy(cent))
    s_j = jquant.symmetric_scales(jnp.asarray(pts), jnp.asarray(cent))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    q_t = quant.quantize(torch.from_numpy(pts), s_t)
    q_j = jquant.quantize(jnp.asarray(pts), s_j)
    assert q_t.dtype == torch.int8
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(
        quant.fake_quantize(torch.from_numpy(cent), s_t).numpy(),
        np.asarray(jquant.fake_quantize(jnp.asarray(cent), s_j)))


def test_quant_rounds_half_to_even_like_reference():
    # a scale of exactly 1.0 (amax 127) puts x/s on the .5 ties
    x = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float32)
    s_t = quant.symmetric_scales(torch.from_numpy(x), torch.from_numpy(x))
    s_j = jquant.symmetric_scales(jnp.asarray(x), jnp.asarray(x))
    assert float(s_t[-1]) == 1.0
    q_t = quant.quantize(torch.from_numpy(x), torch.ones(6))
    q_j = jquant.quantize(jnp.asarray(x), jnp.ones(6, jnp.float32))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(q_t.numpy()[0], [0, 2, 2, 0, -2, 127])
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_assign_update_plain_matches_pallas(case, precision):
    pts, cent = _blob(case)
    j_ids, j_dmin, j_sums, j_counts = jk.kmeans_assign_update(
        jnp.asarray(pts), jnp.asarray(cent), interpret=True,
        precision=precision)
    t_ids, t_dmin, t_sums, t_counts = ops.kmeans_assign_update(
        torch.from_numpy(pts), torch.from_numpy(cent), precision=precision)
    assert t_ids.dtype == torch.int32 and t_dmin.dtype == torch.float32
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    np.testing.assert_allclose(t_sums.numpy(), np.asarray(j_sums),
                               **SUMS_TOL)
    np.testing.assert_allclose(t_dmin.numpy(), np.asarray(j_dmin),
                               **DMIN_TOL)


@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_assign_plain_matches_pallas(case, precision):
    pts, cent = _blob(case, seed=1)
    j_ids, j_dmin = jk.kmeans_assign(jnp.asarray(pts), jnp.asarray(cent),
                                     interpret=True, precision=precision)
    t_ids, t_dmin = ops.kmeans_assign(torch.from_numpy(pts),
                                      torch.from_numpy(cent),
                                      precision=precision)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_dmin.numpy(), np.asarray(j_dmin),
                               **DMIN_TOL)


def test_padded_rows_never_reach_the_accumulators():
    """257 rows is two full 128-row tiles of the CUDA kernel plus one row:
    counts sum to exactly n and the sums to the points' column sums."""
    pts, cent = _blob((257, 7, 3))
    _, _, sums, counts = ops.kmeans_assign_update(torch.from_numpy(pts),
                                                  torch.from_numpy(cent))
    assert float(counts.sum()) == 257.0
    np.testing.assert_allclose(sums.sum(dim=0).numpy(), pts.sum(axis=0),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_no_rows_give_empty_ids_and_zero_sums(precision):
    """n = 0 at every precision: the int8 scales then come from the
    centroids alone, and the sums and counts are zero."""
    _, cent = _blob((64, 8, 4))
    c = torch.from_numpy(cent)
    x = torch.zeros((0, 8))
    ids, dmin, sums, counts = ops.kmeans_assign_update(x, c,
                                                       precision=precision)
    a_ids, a_dmin = ops.kmeans_assign(x, c, precision=precision)
    assert ids.shape == a_ids.shape == dmin.shape == a_dmin.shape == (0,)
    assert not sums.any() and sums.shape == (4, 8)
    assert not counts.any() and counts.shape == (4,)
    np.testing.assert_array_equal(
        quant.symmetric_scales(x, c).numpy(),
        quant.symmetric_scales(c, c).numpy())


@pytest.mark.parametrize("precision", PRECISIONS)
def test_plain_matches_ported_oracles(precision):
    """The fused plain version against the two-pass one-hot oracles of
    kernels/ref.py on the same precision view."""
    pts, cent = _blob((1000, 32, 25), seed=2)
    x, c = torch.from_numpy(pts), torch.from_numpy(cent)
    if precision == "int8":
        o_ids, o_dmin, o_sums, o_counts = ref.kmeans_assign_update_int8_ref(
            x, c)
    else:
        if precision == "bf16":
            x = x.to(torch.bfloat16).float()
            c = c.to(torch.bfloat16).float()
        o_ids, o_dmin, o_sums, o_counts = ref.kmeans_assign_update_ref(x, c)
    ids, dmin, sums, counts = ops.kmeans_assign_update(
        torch.from_numpy(pts), torch.from_numpy(cent), precision=precision)
    np.testing.assert_array_equal(ids.numpy(), o_ids.numpy())
    np.testing.assert_array_equal(counts.numpy(), o_counts.numpy())
    np.testing.assert_allclose(sums.numpy(), o_sums.numpy(), **SUMS_TOL)
    np.testing.assert_allclose(dmin.numpy(), o_dmin.numpy(), **DMIN_TOL)


def test_ops_takes_plain_version_on_cpu_and_counts_no_launch():
    for counter in tk.LAUNCHES.values():
        counter.reset()
    pts, cent = _blob((300, 32, 25))
    ops.kmeans_assign_update(torch.from_numpy(pts), torch.from_numpy(cent))
    ops.kmeans_assign(torch.from_numpy(pts), torch.from_numpy(cent),
                      precision="int8")
    assert {k: c.count for k, c in tk.LAUNCHES.items()} == {
        "kmeans_assign": 0, "kmeans_assign_update": 0}


def test_wrapper_rejects_bad_inputs():
    pts, cent = _blob((64, 8, 4))
    x, c = torch.from_numpy(pts), torch.from_numpy(cent)
    with pytest.raises(ValueError, match="precision"):
        ops.kmeans_assign(x, c, precision="fp16")
    with pytest.raises(ValueError, match="feature widths"):
        ops.kmeans_assign(x, c[:, :4])
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        ops.kmeans_assign(x.to("meta"), c.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.launch(tk.prepare(x, c), fused=True)


def test_launch_counter_is_thread_safe():
    import threading
    counter = tk.LaunchCounter()

    def bump():
        for _ in range(2_000):
            counter.incr()

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert counter.count == 16_000
    counter.reset()
    assert counter.count == 0


def test_build_names_a_missing_compiler(monkeypatch):
    from repro_torch.kernels import build
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        build._nvcc()
    # the library name carries a digest of the source and the flags
    target = build._target(build.CSRC / "kmeans.cu")
    assert target.parent == build.BUILD_DIR
    assert target.name.startswith("libkmeans-") and target.suffix == ".so"


# ---------------------------------------------------------------------------
# B5: the tile (block_n) and its autotune, tests/test_kernels.py:279-302
# ---------------------------------------------------------------------------


def _growing_clock(state):
    """An injected timer whose ticks grow, so that the earlier a candidate
    is timed the faster it looks: the first candidate timed wins."""
    def clock():
        state["calls"] += 1
        state["t"] += state["step"]
        state["step"] *= 2.0
        return state["t"]
    return clock


def test_autotune_block_n_first_candidate_wins_and_caches():
    state = {"t": 0.0, "step": 1.0, "calls": 0}
    tk._autotune_cache.clear()
    best = tk.autotune_block_n(1000, 32, 25, precision="fp32",
                               candidates=(128, 256), probe_n=512,
                               timer=_growing_clock(state), device="cpu")
    assert best == 128
    n_calls = state["calls"]
    assert n_calls == 2 * 2 * 2          # two timer reads, two repeats, two tiles
    again = tk.autotune_block_n(1000, 32, 25, precision="fp32",
                                candidates=(128, 256), probe_n=512,
                                timer=_growing_clock(state), device="cpu")
    assert again == best and state["calls"] == n_calls     # cache hit
    assert tk._autotune_cache[(512, 32, 25, "fp32", "cpu")] == 128
    # the reference's sweep under the same clock picks the same candidate
    jk._autotune_cache.clear()
    ref_state = {"t": 0.0, "step": 1.0, "calls": 0}
    assert jk.autotune_block_n(1000, 32, 25, precision="fp32",
                               interpret=True, candidates=(128, 256),
                               probe_n=512,
                               timer=_growing_clock(ref_state)) == best


def _fits_below(limit_k):
    """A stand-in for the card's shared-memory check: the 256-row tile
    holds the fused form up to ``limit_k`` centroids, the others any K
    (the card's real limits: tests/test_torch_cuda.py)."""
    def fits(precision, f, k, block_n, device):
        return block_n != 256 or k <= limit_k
    return fits


def test_autotune_block_n_skips_a_candidate_that_cannot_fit(monkeypatch):
    monkeypatch.setattr(tk, "_fits", _fits_below(736))
    state = {"t": 0.0, "step": 1.0, "calls": 0}
    tk._autotune_cache.clear()
    best = tk.autotune_block_n(600, 32, 780, precision="fp32",
                               candidates=(256, 128, 64), probe_n=256,
                               timer=_growing_clock(state), device="cpu")
    assert best == 128
    assert state["calls"] == 2 * 2 * 2   # only the two tiles that fit


def test_autotune_block_n_raises_when_no_candidate_fits(monkeypatch):
    monkeypatch.setattr(tk, "_fits", lambda *args: False)
    tk._autotune_cache.clear()
    state = {"t": 0.0, "step": 1.0, "calls": 0}
    with pytest.raises(ValueError, match="no block_n"):
        tk.autotune_block_n(600, 32, 900, precision="fp32",
                            candidates=tk.AUTOTUNE_CANDIDATES,
                            timer=_growing_clock(state), device="cpu")
    assert state["calls"] == 0


def test_autotune_block_n_on_the_cpu_checks_no_shared_memory():
    # the plain version has no tile limit: fp32 K = 900 at F = 32, past
    # every tile's fused limit on the card, sweeps every candidate here
    assert all(tk._fits("fp32", 32, 900, c, torch.device("cpu"))
               for c in tk.TILES)
    state = {"t": 0.0, "step": 1.0, "calls": 0}
    tk._autotune_cache.clear()
    assert tk.autotune_block_n(600, 32, 900, precision="fp32",
                               candidates=tk.AUTOTUNE_CANDIDATES,
                               probe_n=64, timer=_growing_clock(state),
                               device="cpu") == 64
    assert state["calls"] == 2 * 2 * 3


def test_block_n_is_checked_and_ignored_by_the_plain_version():
    pts, cent = _blob((300, 33, 33))
    x, c = torch.from_numpy(pts), torch.from_numpy(cent)
    want = ops.kmeans_assign_update(x, c, precision="int8")
    for block_n in tk.TILES:
        got = ops.kmeans_assign_update(x, c, precision="int8",
                                       block_n=block_n)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="block_n"):
        tk.kmeans_assign(x, c, block_n=96)
