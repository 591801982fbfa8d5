"""The port's Mamba2 SSD scan against the reference on the CPU: the chunk
kernel's plain version (with the inter-chunk recurrence) against the
Pallas kernel in interpret mode and the exact sequential oracle, and the
model's chunked scan against the reference's, on the same numpy inputs.

Tolerance 1e-3, that of ``tests/test_kernels.py:123`` for the scan against
the sequential recurrence (the chunked form sums exp-weighted terms in
another order); 2e-5 where both sides run the same chunked algorithm."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd import ssd_chunk_scan as jssd
from repro.models import layers as JL
from repro_torch.kernels import ops, ref as tref
from repro_torch.kernels import ssd as tssd
from repro_torch.models import layers as TL

SSD_CASES = [
    # (b, s, nh, hd, g, ds, chunk): tests/test_kernels.py:99-106
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 32, 1, 16, 32),
    (1, 256, 8, 64, 2, 32, 64),
    (1, 256, 24, 64, 1, 128, 64),
    (2, 128, 4, 32, 4, 16, 128),
    (1, 400, 4, 32, 2, 16, 200),      # a ragged chunk (not a power of two)
    (1, 512, 5, 64, 1, 16, 256),      # hymba-1.5b's per-chunk widths
]


def _inputs(case, seed=0):
    b, s, nh, hd, g, ds, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, nh, hd)).astype(np.float32),
            rng.uniform(0.001, 0.1, (b, s, nh)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (nh,)).astype(np.float32),
            rng.standard_normal((b, s, g, ds)).astype(np.float32),
            rng.standard_normal((b, s, g, ds)).astype(np.float32),
            rng.standard_normal((nh,)).astype(np.float32))


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_matches_reference_kernel_and_oracle(case):
    chunk = case[-1]
    arrs = _inputs(case)
    jin = [jnp.asarray(a) for a in arrs]
    tin = [torch.from_numpy(a) for a in arrs]
    y_k, fin_k = jssd(*jin, chunk=chunk, interpret=True)
    y_r, fin_r = jref.ssd_ref(*jin)
    before = tssd.LAUNCHES["ssd_chunk_scan"].count
    y, fin = ops.ssd_chunk_scan(*tin, chunk=chunk)
    assert tssd.LAUNCHES["ssd_chunk_scan"].count == before   # plain
    assert y.shape == tin[0].shape and fin.shape == fin_r.shape
    # the Pallas kernel runs the same chunked algorithm: 2e-5
    for got, want in ((y, y_k), (fin, fin_k)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)
    for got, want in ((y, y_r), (fin, fin_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-3, rtol=1e-3)
    if case[1] <= 256:
        y_o, fin_o = tref.ssd_ref(*tin)
        np.testing.assert_allclose(y_o.numpy(), np.asarray(y_r), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(fin_o.numpy(), np.asarray(fin_r),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", [SSD_CASES[1], SSD_CASES[2], SSD_CASES[5]])
def test_ssd_chunked_matches_reference(case):
    chunk = case[-1]
    arrs = _inputs(case, seed=1)
    want_y, want_st = JL.ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk,
                                     return_state=True)
    got_y, got_st = TL.ssd_chunked(*(torch.from_numpy(a) for a in arrs),
                                   chunk, return_state=True)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st),
                               atol=2e-5, rtol=2e-5)
    # and the kernel path computes the same function
    k_y, k_st = ops.ssd_chunk_scan(*(torch.from_numpy(a) for a in arrs),
                                   chunk=chunk)
    np.testing.assert_allclose(k_y.numpy(), got_y.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(k_st.numpy(), got_st.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_ssd_chunk_parts_have_the_kernel_layout():
    case = SSD_CASES[2]
    b, s, nh, hd, g, ds, chunk = case
    arrs = [torch.from_numpy(a) for a in _inputs(case)]
    y, st, cum = tssd.chunk_plain(*arrs, chunk)
    nc = s // chunk
    assert y.shape == (b, s, nh, hd) and st.shape == (b, nh, nc, ds, hd)
    assert cum.shape == (b, nh, nc, chunk) and cum.is_contiguous()
    dA = (arrs[1] * arrs[2]).reshape(b, nc, chunk, nh)
    np.testing.assert_allclose(cum.numpy(),
                               dA.cumsum(2).permute(0, 3, 1, 2).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("chunk", [48, 512])
def test_ssd_rejects_bad_chunk(chunk):
    arrs = [torch.from_numpy(a) for a in _inputs((1, 512, 2, 16, 1, 16, 0))]
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_chunk_scan(*arrs, chunk=chunk)
