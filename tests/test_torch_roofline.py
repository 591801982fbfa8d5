"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``): ``model_flops`` and the roofline terms equal under
the reference's constants, the rows the report renders, and the
counter on the reference's analytic cases and on sharded products over
a fake 2×2 mesh, where it counts one rank's work."""
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st

from repro.configs import SHAPES as JSHAPES, get_arch as jget_arch
from repro.roofline import analysis as JR
from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.roofline import analysis as R
from repro_torch.roofline.counter import COLL_KINDS, Counter, count

# the reference's own hardware, for the classification to compare
REF_HW = R.Hardware(name="reference constants", peak_flops=JR.PEAK_FLOPS,
                    hbm_bw=JR.HBM_BW, link_bw=JR.ICI_BW)


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_the_reference(arch):
    for name in SHAPES:
        assert R.model_flops(get_arch(arch), SHAPES[name]) == \
            JR.model_flops(jget_arch(arch), JSHAPES[name])


def _pair(**kw):
    return (JR.Roofline(**kw), R.Roofline(**kw, hw=REF_HW))


# tests/test_roofline.py's two classification cases
CASES = [dict(arch="a", shape="s", mesh="16x16", chips=256, hlo_flops=1e18,
              hlo_bytes=1e12, collective_bytes=1e12, model_flops=9e17),
         dict(arch="a", shape="s", mesh="16x16", chips=256, hlo_flops=1e15,
              hlo_bytes=1e12, collective_bytes=1e15, model_flops=9e14)]


@pytest.mark.parametrize("case", CASES, ids=["compute", "collective"])
def test_bottleneck_equals_the_reference_on_its_cases(case):
    ref, port = _pair(**case)
    assert port.bottleneck == ref.bottleneck
    assert port.roofline_fraction == ref.roofline_fraction
    assert port.row() == ref.row()


@settings(max_examples=200, deadline=None, database=None)
@given(st.floats(1e9, 1e22), st.floats(1e6, 1e18), st.floats(0, 1e18),
       st.sampled_from([1, 8, 256, 512]))
def test_terms_equal_the_reference_under_its_constants(flops, nbytes, coll,
                                                       chips):
    ref, port = _pair(arch="a", shape="s", mesh="m", chips=chips,
                      hlo_flops=flops, hlo_bytes=nbytes,
                      collective_bytes=coll, model_flops=flops / 3)
    for term in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "roofline_fraction", "useful_flop_ratio"):
        assert getattr(port, term) == getattr(ref, term), term


def test_default_hardware_is_the_h100_datasheet():
    roof = R.Roofline(**CASES[0])
    hw = roof.hw
    assert (hw.peak_flops, hw.peak_flops_fp32, hw.hbm_bw, hw.link_bw) == (
        989.4e12, 66.9e12, 3.35e12, 450e9)
    assert "H100" in hw.name
    # the compute term takes the peak of the counted work's type
    assert roof.dtype == "bfloat16"
    assert roof.t_compute == 1e18 / (256 * 989.4e12)
    fp32 = R.Roofline(**CASES[0], dtype="float32")
    assert fp32.t_compute == 1e18 / (256 * 66.9e12)
    assert list(fp32.row()) == list(roof.row())


def test_row_keys_and_the_report_renders_a_port_row():
    from benchmarks.roofline_report import render_table
    ref, port = _pair(**CASES[0])
    assert list(port.row()) == list(ref.row())
    table = render_table([port.row()])
    assert "| a | s | 16x16 | 256 |" in table and "compute" in table


# --- the counter on the reference's analytic cases ------------------------


def test_loop_of_products_counts_each_product():
    n, t = 64, 12
    h, w = torch.randn(n, n), torch.randn(t, n, n)

    def loop(h, ws):
        for i in range(ws.shape[0]):
            h = h @ ws[i]
        return h

    _, c = count(loop, h, w)
    want = t * 2 * n ** 3
    assert abs(c.dot_flops - want) / want < 0.01
    assert c.flops == c.dot_flops


def test_nested_loops():
    n, t1, t2 = 32, 3, 5
    h, w = torch.randn(n, n), torch.randn(t1, t2, n, n)

    def nested(h, wss):
        for ws in wss:
            for wi in ws:
                h = h @ wi
        return h

    _, c = count(nested, h, w)
    want = t1 * t2 * 2 * n ** 3
    assert abs(c.dot_flops - want) / want < 0.01


def test_unrolled_equals_looped():
    n, t = 32, 4
    h, w = torch.randn(n, n), torch.randn(t, n, n)
    _, unrolled = count(lambda h, w: h @ w[0] @ w[1] @ w[2] @ w[3], h, w)
    _, looped = count(lambda h, w: [h := h @ wi for wi in w][-1], h, w)
    assert unrolled.dot_flops == looped.dot_flops
    assert unrolled.bytes == looped.bytes


def test_bytes_scale_with_the_loop():
    n, t = 64, 16
    h, w = torch.randn(n, n), torch.randn(t, n, n)

    def loop(h, ws):
        for i in range(ws.shape[0]):
            h = h @ ws[i]
        return h

    _, c = count(loop, h, w)
    ideal = t * (3 * n * n * 4)           # read h, read w_i, write h
    assert 0.9 * ideal <= c.bytes <= 4.0 * ideal


def _hlo_and_counter(case, n):
    """The reference's ``HloCostModel`` of a case of tests/test_roofline.py
    (compiled by XLA) and the counter of the same function in eager torch
    on meta tensors."""
    import jax
    import jax.numpy as jnp
    from repro.roofline.hlo_cost import HloCostModel
    t = 12
    spec = jax.ShapeDtypeStruct((n, n), jnp.float32)
    meta = torch.empty(n, n, device="meta")
    if case == "loop":
        def scanned(h, ws):
            return jax.lax.scan(lambda h, wi: (h @ wi, None), h, ws)[0]
        jit_args = (spec, jax.ShapeDtypeStruct((t, n, n), jnp.float32))
        hlo = HloCostModel(jax.jit(scanned).lower(*jit_args).compile()
                           .as_text())
        _, c = count(lambda h, ws: [h := h @ wi for wi in ws][-1], meta,
                     torch.empty(t, n, n, device="meta"))
        return hlo, c, t * 3 * n * n * 4
    grad = jax.grad(lambda x, w: jnp.sum((x @ w) ** 2), argnums=1)
    hlo = HloCostModel(jax.jit(grad).lower(spec, spec).compile().as_text())
    w = torch.empty(n, n, device="meta", requires_grad=True)
    _, c = count(lambda: torch.autograd.grad(torch.sum((meta @ w) ** 2), w))
    return hlo, c, None


@pytest.mark.parametrize("case", ["loop", "grad"])
def test_counter_against_the_reference_hlo_cost_model(case):
    """The counter against the reference's own counter on the same work:
    the products' flops are equal, all flops agree within 0.5% (XLA's
    loop counter and fused square add a few), and the loop's bytes lie
    in the reference test's 0.9–4× of the ideal traffic on both sides
    (eager torch moves the ideal bytes; XLA's scan adds its carries)."""
    hlo, c, ideal = _hlo_and_counter(case, 256)
    assert c.dot_flops == hlo.dot_flops_only()
    assert abs(c.flops - hlo.flops()) <= 5e-3 * hlo.flops()
    if ideal:
        for got in (c.bytes, hlo.bytes_accessed()):
            assert 0.9 * ideal <= got <= 4.0 * ideal


def test_gradient_counts_at_least_twice_the_forward():
    n = 64
    x, w = torch.randn(n, n), torch.randn(n, n, requires_grad=True)
    fwd = lambda: torch.sum((x @ w) ** 2)
    _, f = count(fwd)
    _, g = count(lambda: torch.autograd.grad(fwd(), w))
    assert g.dot_flops >= 1.9 * f.dot_flops


def test_elementwise_and_moves():
    """One flop an output element of a computing op; casts, copies and
    views none, as in the reference's HLO count."""
    a = torch.randn(8, 16)
    _, c = count(lambda: (a * 2.0).exp())
    assert (c.flops, c.dot_flops) == (2 * 128, 0)
    assert c.bytes == 4 * 128 * 4        # two ops, each reads and writes
    _, c = count(lambda: a.T.contiguous().to(torch.float64).view(-1))
    assert c.flops == 0 and c.bytes > 0


# --- per rank on DTensors over a fake 2×2 mesh ------------------------------


@pytest.fixture
def fake_mesh():
    """A 2×2 (data, model) mesh over a fake group of 4 ranks in this
    process; the group is destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_debug_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield make_debug_mesh((2, 2), device="cpu")
    finally:
        dist.destroy_process_group()


def _meta(mesh, shape, placements):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    stride = tuple(int(torch.tensor(shape[i + 1:]).prod())
                   for i in range(len(shape)))
    return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                              placements, run_check=False, shape=shape,
                              stride=stride)


M, K, N = 256, 128, 512


def test_column_parallel_product_counts_one_rank(fake_mesh):
    """x split on rows over data, w on columns over model: each rank does
    a quarter of 2MNK, and nothing is exchanged."""
    from torch.distributed.tensor import Replicate, Shard
    x = _meta(fake_mesh, (M, K), [Shard(0), Replicate()])
    w = _meta(fake_mesh, (K, N), [Replicate(), Shard(1)])
    y, c = count(torch.matmul, x, w)
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert c.dot_flops == 2 * M * N * K / 4
    assert c.collective_bytes == 0


def test_row_parallel_product_counts_one_rank_and_one_all_reduce(fake_mesh):
    """x split on its contracted dim over model, w on rows: a Partial
    output whose each rank's product is a quarter of 2MNK, and the
    reduction to Replicate is one all-reduce of the rank's local result.
    Not the global count plus the local one that ``FlopCounterMode``
    gives."""
    from torch.distributed.tensor import Replicate, Shard
    x = _meta(fake_mesh, (M, K), [Shard(0), Shard(1)])
    w = _meta(fake_mesh, (K, N), [Replicate(), Shard(0)])
    with Counter() as c:
        y = x @ w
        assert y.placements[1].is_partial()
        y = y.redistribute(fake_mesh, [Shard(0), Replicate()])
    assert c.dot_flops == 2 * M * N * K / 4
    assert c.dot_flops != 2 * M * N * K + 2 * M * N * K / 4
    assert c.coll_counts["all-reduce"] == 1
    assert c.coll_bytes["all-reduce"] == (M // 2) * N * 4
    assert c.collective_bytes == c.coll_bytes["all-reduce"]


def test_c10d_collectives_count_their_operands(fake_mesh):
    """``dist.all_reduce`` and ``send`` on plain tensors: the c10d ops,
    operand bytes under the reference's kinds; ``recv`` counts nothing
    (its bytes are the peer's send)."""
    x = torch.empty(16, 8, device="meta")
    with Counter() as c:
        dist.all_reduce(x)
        dist.send(x, 1)
        dist.recv(x, 1)
    want = {k: 0 for k in COLL_KINDS}
    want.update({"all-reduce": 1, "collective-permute": 1})
    assert c.coll_counts == want
    assert c.coll_bytes["all-reduce"] == c.coll_bytes[
        "collective-permute"] == 16 * 8 * 4


def test_analyze_scales_one_rank_to_the_module(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard
    x = _meta(fake_mesh, (M, K), [Shard(0), Shard(1)])
    w = _meta(fake_mesh, (K, N), [Replicate(), Shard(0)])
    _, c = count(lambda: (x @ w).redistribute(fake_mesh,
                                              [Shard(0), Replicate()]))
    cost = R.analyze(c, chips=4)
    assert cost["dot_flops"] == 2 * M * N * K
    assert cost["collective_bytes"] == 4 * c.collective_bytes
    assert cost["coll_counts"]["all-reduce"] == 1
