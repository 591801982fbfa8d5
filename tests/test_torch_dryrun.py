"""The port's dry-run (``repro_torch.launch.dryrun``) on fake process
groups: the reference's own smoke cell on both production meshes, one
reduced config of each family through train, prefill and decode on a
small fake mesh, reduced cells' per-rank products against the
reference's own dry-run of the same cells, the int8 and pipeline steps,
and the CLI against the reference's.

Every fake group made here is destroyed before the test ends.

Run as a script, it prints the port's and the reference's per-rank
counts of every family's reduced train, prefill and decode cells on the
(2, 4) mesh, and their ratios:

    PYTHONPATH=src python tests/test_torch_dryrun.py
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

from repro.configs import SHAPES as JSHAPES, get_arch as jget_arch
from repro.roofline import analysis as JR
from repro_torch.configs import SHAPES, ShapeConfig, get_arch
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as TM
from repro_torch.models import convert
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_reference_smoke_cell_on_both_meshes(multi_pod):
    """internlm2-1.8b × decode_32k, the reference's dry-run smoke cell:
    it lowers, ``model_flops`` is the reference's, the terms are finite,
    the fake group is gone after, and one rank's bf16 parameters weigh
    what the specs give (0.236 GB on either mesh)."""
    roof = D.lower_cell("internlm2-1.8b", "decode_32k", multi_pod=multi_pod,
                        verbose=False)
    assert not dist.is_initialized()
    assert roof.chips == (512 if multi_pod else 256)
    assert roof.mesh == ("2x16x16" if multi_pod else "16x16")
    assert roof.model_flops == JR.model_flops(jget_arch("internlm2-1.8b"),
                                              JSHAPES["decode_32k"])
    row = roof.row()
    assert row["bottleneck"] in ("compute", "memory", "collective")
    assert all(np.isfinite(row[k]) and row[k] > 0 for k in (
        "hlo_flops", "dot_flops", "hlo_bytes", "collective_bytes",
        "per_device_hbm"))
    # the cache (32,768 slots × 128 × 24 layers, bf16) dominates a rank
    cfg = get_arch("internlm2-1.8b")
    mesh = TM.make_production_mesh(multi_pod=multi_pod, device="cpu")
    try:
        rules = TM.make_rules(mesh)
        shapes = T.param_shapes(cfg)
        params = D.distribute(shapes, convert.unstack_specs(
            T.param_pspecs(cfg, rules), shapes), mesh)
        assert round(D.local_bytes(params) / 1e9, 3) == 0.236
    finally:
        dist.destroy_process_group()


@pytest.fixture
def fake_mesh(request):
    """A fake group of prod(shape) ranks in this process and a mesh of
    that shape; destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = request.param
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        yield TM.make_debug_mesh(shape, axes, device="cpu")
    finally:
        dist.destroy_process_group()


SMALL = ((2, 4), ("data", "model"))
PODS = ((2, 2, 2), ("pod", "data", "model"))
SHAPES_SMALL = [ShapeConfig("train_s", 32, 4, "train"),
                ShapeConfig("prefill_s", 64, 2, "prefill"),
                ShapeConfig("decode_s", 64, 4, "decode")]
FAMILIES = {"gqa": "internlm2-1.8b", "mla": "minicpm3-4b",
            "hybrid": "hymba-1.5b", "ssm": "mamba2-130m",
            "moe": "qwen3-moe-235b-a22b", "mrope": "qwen2-vl-2b",
            "codebooks": "musicgen-medium"}


def _check(roof, kind):
    row = roof.row()
    assert row["hlo_flops"] > 0 and row["dot_flops"] > 0
    assert row["hlo_bytes"] > 0 and row["per_device_hbm"] > 0
    assert row["collective_bytes"] > 0, "a sharded cell exchanges nothing"
    if kind == "train":
        assert row["dot_flops"] > 2 * row["model_flops"] / 6


@pytest.mark.parametrize("fake_mesh", [SMALL], indirect=True)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_each_family_lowers_train_prefill_decode(fake_mesh, family):
    """One reduced config of each family on a (2, 4) fake mesh, where the
    two kv heads are cut by the 4-wide model axis."""
    cfg = get_arch(FAMILIES[family]).reduced()
    for shape in SHAPES_SMALL:
        _check(D.lower(cfg, shape, fake_mesh), shape.kind)


# the reference's own dry-run of reduced cells: ``_lower_cell_inner``
# (XLA's partitioned program, counted by ``HloCostModel``) on a (2, 4)
# mesh of eight host devices with Auto axes, under the rules its
# ``lower_cell`` builds; in a subprocess, so that the device count does
# not reach this process.  Prints {"arch/kind": row}.
_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import compat
from repro.configs import get_arch
from repro.configs.base import ShapeConfig
from repro.launch import dryrun as JD
from repro.models import transformer as JT
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch, shape in json.loads(sys.argv[1]):
    shape = ShapeConfig(*shape)
    cfg = get_arch(arch).reduced()
    axes = JD._batch_axes_for(shape, mesh)
    rules = JT.ShardRules(batch=axes, model="model",
                          fsdp="data" if JD.wants_fsdp(cfg) else None,
                          moe_groups=JD._prod(mesh, axes), model_size=1)
    with compat.set_mesh(mesh):
        roof = JD._lower_cell_inner(cfg, shape, arch, shape.name, mesh, 8,
                                    rules, jnp.bfloat16, 0.0, None, False,
                                    False)
    out[f"{arch}/{shape.kind}"] = roof.row()
print(json.dumps(out))
"""


def _both(cells):
    """{"arch/kind": (port row, reference row)} of reduced ``cells``
    ((arch, ShapeConfig)) on the (2, 4) mesh."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    arg = json.dumps([(a, dataclasses.astuple(s)) for a, s in cells])
    ref = subprocess.run([sys.executable, "-c", _REFERENCE, arg], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert ref.returncode == 0, ref.stderr[-3000:]
    ref = json.loads(ref.stdout.strip().splitlines()[-1])
    out = {}
    for arch, shape in cells:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        try:
            mesh = TM.make_debug_mesh(*SMALL, device="cpu")
            row = D.lower(get_arch(arch).reduced(), shape, mesh).row()
        finally:
            dist.destroy_process_group()
        out[f"{arch}/{shape.kind}"] = (row, ref[f"{arch}/{shape.kind}"])
    return out


# cells whose products the two programs share; DOT_RTOL covers the few
# the partitioners place differently (XLA's loss and MoE's spare row)
REF_CELLS = [("internlm2-1.8b", SHAPES_SMALL[0]),
             ("internlm2-1.8b", SHAPES_SMALL[2]),
             ("minicpm3-4b", SHAPES_SMALL[1]),
             ("qwen3-moe-235b-a22b", SHAPES_SMALL[0]),
             ("mamba2-130m", SHAPES_SMALL[2])]
DOT_RTOL = 0.01


@pytest.fixture(scope="module")
def against_reference():
    return _both(REF_CELLS)


@pytest.mark.parametrize("cell", [f"{a}/{s.kind}" for a, s in REF_CELLS])
def test_per_rank_products_equal_the_reference_dry_run(against_reference,
                                                       cell):
    """One rank's dot flops of a reduced cell equal those of the
    reference's partitioned program of the same cell within
    ``DOT_RTOL``; both programs reduce the row-parallel products with
    all-reduces.  The other collective kinds differ by design: XLA's
    partitioner reshards with all-to-all and collective-permute where
    DTensor gathers and reduce-scatters (PERF.md §6)."""
    port, ref = against_reference[cell]
    assert port["chips"] == ref["chips"] == 8
    assert port["model_flops"] == ref["model_flops"]
    assert abs(port["dot_flops"] - ref["dot_flops"]) <= \
        DOT_RTOL * ref["dot_flops"], (port["dot_flops"], ref["dot_flops"])
    assert port["coll_counts"]["all-reduce"] > 0
    assert ref["coll_counts"]["all-reduce"] > 0


@pytest.mark.parametrize("fake_mesh", [SMALL], indirect=True)
def test_uneven_query_heads(fake_mesh):
    """Six query heads over a 4-wide model axis (the ranks take 2, 2, 2
    and 0, as XLA's padded split): the uneven head paths lower."""
    cfg = dataclasses.replace(get_arch("internlm2-1.8b").reduced(),
                              n_heads=6)
    for shape in SHAPES_SMALL:
        _check(D.lower(cfg, shape, fake_mesh), shape.kind)


@pytest.mark.parametrize("fake_mesh", [PODS], indirect=True)
def test_compression_and_pipeline_exchange_over_the_pods(fake_mesh):
    """``--compression``: the int8 reduction's all-to-all and all-gather
    over the 'pod' subgroup; ``--pipeline``: the GPipe hops (one send a
    microbatch from stage 0) on the same subgroup."""
    cfg = get_arch("internlm2-1.8b").reduced()
    shape = ShapeConfig("train_s", 32, 8, "train")
    comp = D.lower(cfg, shape, fake_mesh, compression=True).row()
    assert comp["coll_counts"]["all-to-all"] > 0
    assert comp["collective_bytes"] > 0
    pipe = D.lower(cfg, shape, fake_mesh, pipeline=True).row()
    assert pipe["coll_counts"]["collective-permute"] == 4
    assert pipe["collective_bytes"] > 0


def test_kernel_attention_cannot_be_dry_run():
    with pytest.raises(ValueError, match="ctypes"):
        D.lower(get_arch("internlm2-1.8b"), SHAPES["train_4k"], None,
                overrides={"attn_impl": "kernel"})


def test_main_return_code_and_summary_equal_the_reference(capsys):
    """An unknown arch fails in both CLIs before anything is built: the
    same return code and summary line; a cell that lowers returns 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = ["--arch", "no-such-arch", "--shape", "train_4k"]
    ref = subprocess.run([sys.executable, "-m", "repro.launch.dryrun",
                          *args], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    rc = D.main(args)
    out = capsys.readouterr().out
    assert rc == ref.returncode == 1
    assert out.strip().splitlines()[-1] == \
        ref.stdout.strip().splitlines()[-1] == "0 cells OK, 1 failed"
    assert D.main(["--arch", "mamba2-130m", "--shape", "long_500k"]) == 0
    assert "1 cells OK, 0 failed" in capsys.readouterr().out


if __name__ == "__main__":
    rows = _both([(FAMILIES[f], shape) for f in FAMILIES
                  for shape in SHAPES_SMALL])
    print("| cell | port dot/rank | ref dot/rank | ratio | port coll B/rank"
          " | ref coll B/rank | port kinds | ref kinds |")
    for cell, (port, ref) in rows.items():
        kinds = lambda r: ",".join(f"{k}:{n}" for k, n in
                                   r["coll_counts"].items() if n)
        print(f"| {cell} | {port['dot_flops'] / 8:.0f} | "
              f"{ref['dot_flops'] / 8:.0f} | "
              f"{port['dot_flops'] / ref['dot_flops']:.4f} | "
              f"{port['collective_bytes'] / 8:.0f} | "
              f"{ref['collective_bytes'] / 8:.0f} | {kinds(port)} | "
              f"{kinds(ref)} |")
