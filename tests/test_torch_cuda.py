"""The port's CUDA kernel on an sm_90 card, against its plain version on
the same inputs.  Imports torch only, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test skips on a host without a Hopper card; ``chip_smoke.py`` drives
the same comparisons at the main path's full sizes."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import kmeans as tk
from repro_torch.kernels import ops
from repro_torch.ml import KMeans, MiniAppGenerator

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
