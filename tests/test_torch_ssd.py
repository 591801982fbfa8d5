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


# ROADMAP C1's inputs (b, s, nh, hd, g, ds, chunk), drawn from
# default_rng(0) in this order; xh, B and C are cast to bf16
C1_CASE = (1, 256, 4, 32, 1, 16, 64)


def _c1_inputs(case):
    b, s, nh, hd, g, ds, _ = case
    rng = np.random.default_rng(0)
    xh = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dt = (0.1 * np.abs(rng.standard_normal((b, s, nh)))).astype(np.float32)
    A = (-0.5 * np.arange(1, nh + 1)).astype(np.float32)
    B = rng.standard_normal((b, s, g, ds)).astype(np.float32)
    C = rng.standard_normal((b, s, g, ds)).astype(np.float32)
    return xh, dt, A, B, C, np.ones((nh,), np.float32)


def _bf16_values(arrs):
    """xh, B and C rounded to bf16 and widened back: the values a bf16 run
    computes with, as fp32 numpy arrays."""
    out = list(arrs)
    for i in (0, 3, 4):
        out[i] = torch.from_numpy(arrs[i]).to(torch.bfloat16).float().numpy()
    return out


def _to(arrs, dtype):
    """(jax arrays, torch tensors) with xh, B and C in ``dtype``."""
    jd = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    td = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jin = [jnp.asarray(a) for a in arrs]
    tin = [torch.from_numpy(a) for a in arrs]
    for i in (0, 3, 4):
        jin[i], tin[i] = jin[i].astype(jd), tin[i].to(td)
    return jin, tin


def _one_rounding_apart(want):
    """Two bf16 roundings of fp32 values that differ only in their sums'
    order: within 2^-7 of the value plus 1e-3 of the largest value (the
    bf16 flash check's bound)."""
    return 2.0 ** -7 * np.abs(want) + 1e-3 * np.abs(want).max()


# (case, dtype, inputs): the file's cases in fp32 and bf16, and C1's
CHUNKED_CASES = [(SSD_CASES[i], dt, "seed1") for dt in ("fp32", "bf16")
                 for i in (1, 2, 5)] + [(C1_CASE, "bf16", "c1")]
CHUNKED_IDS = ["case0", "case1", "case2", "bf16-case0", "bf16-case1",
               "bf16-case2", "bf16-c1"]


def _chunked_inputs(case, inputs):
    return _c1_inputs(case) if inputs == "c1" else _inputs(case, seed=1)


@pytest.mark.parametrize("case,dtype,inputs", CHUNKED_CASES, ids=CHUNKED_IDS)
def test_ssd_chunked_matches_reference(case, dtype, inputs):
    """fp32: within 2e-5 of the reference.  bf16: the reference sums
    ``y_intra + y_inter + D·x`` in fp32 and rounds once; the port's y is
    within one rounding of the reference's bf16 y, and is the reference's
    fp32 y (on the same bf16 input values) rounded once: within half a
    bf16 ulp, 2^-8 of the value, plus the fp32 tolerance.  A second
    rounding (ROADMAP C1) breaks the last bound.  The kernel path's bf16
    y rounds twice (the next test)."""
    chunk = case[-1]
    arrs = _chunked_inputs(case, inputs)
    jin, tin = _to(arrs, dtype)
    want_y, want_st = JL.ssd_chunked(*jin, chunk, return_state=True)
    got_y, got_st = TL.ssd_chunked(*tin, chunk, return_state=True)
    assert got_y.dtype == tin[0].dtype and got_st.dtype == torch.float32
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st),
                               atol=2e-5, rtol=2e-5)
    if dtype == "fp32":
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   atol=2e-5, rtol=2e-5)
        # and the kernel path computes the same function
        k_y, k_st = ops.ssd_chunk_scan(*tin, chunk=chunk)
        np.testing.assert_allclose(k_y.numpy(), got_y.numpy(), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(k_st.numpy(), got_st.numpy(), atol=1e-4,
                                   rtol=1e-4)
        return
    got = got_y.float().numpy()
    want = np.asarray(want_y.astype(jnp.float32))
    assert (np.abs(got - want) <= _one_rounding_apart(want)).all()
    y32 = np.asarray(JL.ssd_chunked(
        *(jnp.asarray(a) for a in _bf16_values(arrs)), chunk))
    half_ulp = 2.0 ** -8 * np.abs(y32) + 2e-5 * (1 + np.abs(y32))
    assert (np.abs(got - y32) <= half_ulp).all(), \
        int((np.abs(got - y32) > half_ulp).sum())


@pytest.mark.parametrize("case,inputs", [(C1_CASE, "c1"),
                                         (SSD_CASES[2], "seed1")])
def test_ssd_kernel_path_bf16_rounds_twice_like_pallas(case, inputs):
    """The kernel path on a CPU tensor rounds a bf16 y after the chunk's own
    part and again after ``y_inter``, as the reference's Pallas entry point
    ``ssd_chunk_scan`` (interpret mode) does: the two agree within one
    rounding and bit for bit in all but a few near-ties, while the
    model's ``ssd_chunked`` (rounded once) differs in many entries."""
    chunk = case[-1]
    jin, tin = _to(_chunked_inputs(case, inputs), "bf16")
    j_y, j_st = jssd(*jin, chunk=chunk, interpret=True)
    y, st = ops.ssd_chunk_scan(*tin, chunk=chunk)
    assert y.dtype == torch.bfloat16
    got = y.float().numpy()
    want = np.asarray(j_y.astype(jnp.float32))
    assert (np.abs(got - want) <= _one_rounding_apart(want)).all()
    assert (got != want).mean() < 0.01
    np.testing.assert_allclose(st.numpy(), np.asarray(j_st), atol=2e-5,
                               rtol=2e-5)
    once = TL.ssd_chunked(*tin, chunk).float().numpy()
    assert (once != got).mean() > 0.05


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
