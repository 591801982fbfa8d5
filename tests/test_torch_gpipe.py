"""The port's GPipe pipeline (``repro_torch.train.pipeline``) against the
reference's on ``tests/pp_check.py``'s case: reduced internlm2-1.8b
(remat off), 2 stages, 2 microbatches, 4 × 32 tokens, lr 1e-3, three
steps on fresh batches, in both of the port's forms — two gloo ranks (a
file store, no fixed port) and the stages in one process.

The reference runs once per module in a subprocess with two host devices
and saves its initial parameters, batches, metrics and final parameters.
Tolerances: losses 1e-5 relative (fp32 sums of the microbatches in
another order); parameters after three AdamW steps 5e-5 absolute
(``tests/test_torch_train.py``: Adam moves an element by about lr, so a
rounding of g where |g| ~ sqrt(nu) moves it by up to that; the
reference's pipeline itself ends within 2.1e-5 of its plain step); the
two forms of the port against each other 1e-6.

ROADMAP C5 and C6 are pinned here: the port's ``grad_norm`` is the whole
model's (the plain step's), the reference's S times the norm over stage
0's blocks and the replicated leaves; and the pipeline's loss carries no
MoE router losses, in either package (reduced qwen3-moe, one step)."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import transformer as TT
from repro_torch.train import step as TS
from repro_torch.train.pipeline import (PipelineConfig, init_pp_state,
                                        make_pp_loss_fn, make_pp_train_step)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
MOE = "qwen3-moe-235b-a22b"
STEPS = {ARCH: 3, MOE: 1}
TC = dict(lr=1e-3, warmup=1, total_steps=10)
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-5

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.configs import get_arch
    from repro.models import transformer as T
    from repro.train import step as TS
    from repro.train.pipeline import (PipelineConfig, init_pp_state,
                                      make_pp_train_step)

    def flat(tree, prefix):
        return {prefix + "/".join(str(k.key) for k in path): np.asarray(x)
                for path, x in jax.tree_util.tree_leaves_with_path(tree)}

    out, steps = sys.argv[1], dict(a.split("=") for a in sys.argv[2:])
    tc = TS.TrainConfig(lr=1e-3, warmup=1, total_steps=10)
    pc = PipelineConfig(n_stages=2, microbatches=2, stage_axis="pod")
    mesh = jax.make_mesh((2,), ("pod",))
    rules = T.ShardRules(batch=(), model=None, fsdp=None, moe_groups=1)
    for arch, n in steps.items():
        cfg = dataclasses.replace(get_arch(arch).reduced(), remat=False)
        rng = np.random.default_rng(7)
        batches = [{k: rng.integers(0, cfg.vocab_size, (4, 32),
                                    dtype=np.int32)
                    for k in ("tokens", "labels")} for _ in range(int(n))]
        key = jax.random.key(0)
        params, state = TS.init_train_state(key, cfg, tc)
        res = flat(params, "init/")
        g = jax.grad(lambda p, b: T.loss_fn(p, cfg, b)[0])(params,
                                                           batches[0])
        half = cfg.n_layers // 2
        for s in range(2):
            res[f"sq_blocks_stage{s}"] = np.float64(sum(
                float(jnp.sum(jnp.square(x[s * half:(s + 1) * half])))
                for x in jax.tree.leaves(g["blocks"])))
        res["sq_replicated"] = np.float64(sum(
            float(jnp.sum(jnp.square(v)))
            for k, v in g.items() if k != "blocks"))
        plain = jax.jit(TS.make_train_step(cfg, tc))
        pp_params, pp_state = init_pp_state(key, cfg, tc, pc)
        with compat.set_mesh(mesh):
            pp = jax.jit(make_pp_train_step(cfg, tc, pc, rules, mesh))
            for i, b in enumerate(batches):
                pp_params, pp_state, m = pp(pp_params, pp_state, b)
                params, state, mp = plain(params, state, b)
                res.update({f"batch{i}/{k}": v for k, v in b.items()})
                res.update({f"pp{i}/{k}": np.asarray(v)
                            for k, v in m.items()})
                res.update({f"plain{i}/{k}": np.asarray(v)
                            for k, v in mp.items()})
        pp_params["blocks"] = jax.tree.map(
            lambda x: x.reshape(-1, *x.shape[2:]), pp_params["blocks"])
        res.update(flat(pp_params, "pp_final/"))
        res.update(flat(params, "plain_final/"))
        np.savez(f"{out}/{arch}.npz", **res)
""")

_RANK = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch import configs
    from repro_torch.train import step as TS
    from repro_torch.train.pipeline import PipelineConfig, make_pp_train_step
    sys.path.insert(0, sys.argv[4])
    from test_torch_gpipe import TC, load, start
    rank, path, arch = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{path}/store",
                            world_size=2, rank=rank)
    ref = dict(np.load(f"{path}/{arch}.npz"))
    cfg = dataclasses.replace(configs.get_arch(arch).reduced(), remat=False)
    tc = TS.TrainConfig(**TC)
    params, state = start(ref, cfg, tc, stage=rank)
    step = make_pp_train_step(cfg, tc, PipelineConfig(2, 2),
                              group=dist.group.WORLD)
    out = {}
    for i, batch in enumerate(load(ref, "batch")):
        params, state, m = step(params, state, batch)
        out.update({f"{i}/{k}": v for k, v in m.items()})
    torch.save({"metrics": out, "params": params},
               f"{path}/rank{rank}.pt")
    dist.destroy_process_group()
""")


def load(ref, prefix):
    """The batches (prefix "batch") of the reference's npz as tensors."""
    n = sum(1 for k in ref if k.startswith(prefix) and k.endswith("/tokens"))
    return [{k: torch.from_numpy(ref[f"{prefix}{i}/{k}"])
             for k in ("tokens", "labels")} for i in range(n)]


def _tree(ref, prefix):
    """A nested dict of the npz's arrays under ``prefix``."""
    tree = {}
    for key, value in ref.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = value
    return tree


def start(ref, cfg, tc, stage=None):
    """The reference's initial params in the port's layout (one stage's
    layers when ``stage`` is given) and a zero train state."""
    params = convert.load_reference_params(_tree(ref, "init/"), cfg,
                                           device="cpu")
    if stage is not None:
        per = cfg.n_layers // 2
        params["blocks"] = params["blocks"][stage * per:(stage + 1) * per]
    return params, {"opt": TS._opt(cfg, tc).init(params),
                    "step": torch.zeros((), dtype=torch.int32)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("gpipe")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(path)]
        + [f"{a}={n}" for a, n in STEPS.items()],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return path, {a: dict(np.load(path / f"{a}.npz")) for a in STEPS}


def _cfg(arch):
    return dataclasses.replace(tconfigs.get_arch(arch).reduced(),
                               remat=False)


def _run_one_process(ref, arch):
    cfg, tc = _cfg(arch), TS.TrainConfig(**TC)
    params, state = start(ref, cfg, tc)
    step = make_pp_train_step(cfg, tc, PipelineConfig(2, 2))
    metrics = []
    for batch in load(ref, "batch"):
        params, state, m = step(params, state, batch)
        metrics.append(m)
    return params, metrics


@pytest.fixture(scope="module")
def one_process(reference):
    return _run_one_process(reference[1][ARCH], ARCH)


@pytest.fixture(scope="module")
def two_ranks(reference):
    """Both stage ranks' final params joined into the whole model, and
    rank 0's and rank 1's metrics."""
    path, _ = reference
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(path), ARCH,
         str(ROOT / "tests")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    ranks = [torch.load(path / f"rank{r}.pt") for r in (0, 1)]
    params = dict(ranks[0]["params"])
    params["blocks"] = ranks[0]["params"]["blocks"] + \
        ranks[1]["params"]["blocks"]
    for k in params:
        if k != "blocks":      # the replicated leaves agree on both ranks
            assert torch.equal(params[k], ranks[1]["params"][k]), k
    return params, [r["metrics"] for r in ranks]


def _assert_params_close(params, ref, prefix, atol):
    got = convert.to_reference(params)
    want = _tree(ref, prefix)
    flat_got = dict(pytree.tree_flatten_with_path(got)[0])
    flat_want = dict(pytree.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    for path, a in flat_got.items():
        np.testing.assert_allclose(a, flat_want[path], atol=atol, rtol=0,
                                   err_msg=str(path))


def test_one_process_pipeline_matches_the_reference(reference, one_process):
    ref = reference[1][ARCH]
    params, metrics = one_process
    for i, m in enumerate(metrics):
        np.testing.assert_allclose(float(m["loss"]), ref[f"pp{i}/loss"],
                                   rtol=LOSS_RTOL)
    _assert_params_close(params, ref, "pp_final/", PARAM_ATOL)
    _assert_params_close(params, ref, "plain_final/", PARAM_ATOL)


def test_two_rank_pipeline_matches_the_reference(reference, two_ranks):
    ref = reference[1][ARCH]
    params, metrics = two_ranks
    for rank_metrics in metrics:
        for i in range(STEPS[ARCH]):
            np.testing.assert_allclose(float(rank_metrics[f"{i}/loss"]),
                                       ref[f"pp{i}/loss"], rtol=LOSS_RTOL)
    _assert_params_close(params, ref, "pp_final/", PARAM_ATOL)


def test_one_process_and_two_ranks_agree(one_process, two_ranks):
    params, metrics = one_process
    r_params, r_metrics = two_ranks
    for i, m in enumerate(metrics):
        for k in ("loss", "grad_norm"):
            for rank_metrics in r_metrics:
                np.testing.assert_allclose(float(rank_metrics[f"{i}/{k}"]),
                                           float(m[k]), rtol=1e-6)
    for a, b in zip(pytree.tree_leaves(params),
                    pytree.tree_leaves(r_params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_grad_norm_is_the_whole_models_not_the_references(reference,
                                                          one_process):
    """ROADMAP C5.  The port reports (and clips by) the plain step's norm
    at every step.  The reference's is S = 2 times the norm over stage 0's
    blocks and the replicated leaves: the psum's transpose scales each
    gradient by S, and its clip sees one stage's tree."""
    ref = reference[1][ARCH]
    _, metrics = one_process
    for i, m in enumerate(metrics):
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   ref[f"plain{i}/grad_norm"], rtol=1e-5)
    stage0 = 2 * np.sqrt(ref["sq_blocks_stage0"] + ref["sq_replicated"])
    whole = np.sqrt(ref["sq_blocks_stage0"] + ref["sq_blocks_stage1"]
                    + ref["sq_replicated"])
    np.testing.assert_allclose(ref["pp0/grad_norm"], stage0, rtol=1e-5)
    np.testing.assert_allclose(float(metrics[0]["grad_norm"]), whole,
                               rtol=1e-5)
    ratios = [ref[f"pp{i}/grad_norm"] / ref[f"plain{i}/grad_norm"]
              for i in range(STEPS[ARCH])]
    assert all(1.8 < r < 2.0 for r in ratios), ratios


def test_pipeline_loss_has_no_router_losses(reference):
    """ROADMAP C6, reproduced: for an MoE arch both pipelines' loss is the
    cross entropy alone, the plain step's ``ce``, not its ``loss``
    (``ce + lb_loss + z_loss``)."""
    ref = reference[1][MOE]
    cfg = _cfg(MOE)
    params, state = start(ref, cfg, TS.TrainConfig(**TC))
    batch = load(ref, "batch")[0]
    loss = make_pp_loss_fn(cfg, PipelineConfig(2, 2))(params, batch)
    _, plain = TT.loss_fn(params, cfg, batch)
    np.testing.assert_allclose(float(loss), ref["pp0/loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), float(plain["ce"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(ref["pp0/loss"], ref["plain0/ce"],
                               rtol=LOSS_RTOL)
    router = float(plain["lb_loss"] + plain["z_loss"])
    assert router > 1e-3
    np.testing.assert_allclose(float(plain["loss"]) - float(loss), router,
                               rtol=1e-3)
    _, _, m = make_pp_train_step(cfg, TS.TrainConfig(**TC),
                                 PipelineConfig(2, 2))(params, state, batch)
    assert set(m) == {"loss", "grad_norm"}


def test_pipeline_refuses_what_it_cannot_split():
    cfg = tconfigs.get_arch(ARCH).reduced()
    tc = TS.TrainConfig(**TC)
    with pytest.raises(ValueError, match="do not split into 3 stages"):
        make_pp_train_step(cfg, tc, PipelineConfig(3, 2))
    with pytest.raises(ValueError, match="token inputs"):
        make_pp_loss_fn(tconfigs.get_arch("qwen2-vl-2b").reduced(),
                        PipelineConfig(2, 2))
    params, _ = init_pp_state(cfg, tc, PipelineConfig(2, 2), device="cpu")
    bad = {k: torch.zeros((3, 8), dtype=torch.int32)
           for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="3 does not split into 2"):
        make_pp_loss_fn(cfg, PipelineConfig(2, 2))(params, bad)


def test_init_pp_state_is_the_plain_init_or_one_stage_of_it():
    cfg = tconfigs.get_arch(ARCH).reduced()
    tc = TS.TrainConfig(**TC)
    pc = PipelineConfig(2, 2)
    whole, state = init_pp_state(cfg, tc, pc, device="cpu", seed=3)
    plain, plain_state = TS.init_train_state(cfg, tc, device="cpu", seed=3)
    for a, b in zip(pytree.tree_leaves((whole, state)),
                    pytree.tree_leaves((plain, plain_state))):
        assert torch.equal(a, b)
    second, s_state = init_pp_state(cfg, tc, pc, device="cpu", seed=3,
                                    stage=1)
    assert len(second["blocks"]) == cfg.n_layers // 2
    for a, b in zip(pytree.tree_leaves(second["blocks"]),
                    pytree.tree_leaves(whole["blocks"][cfg.n_layers // 2:])):
        assert torch.equal(a, b)
    assert len(s_state["opt"]["mu"]["blocks"]) == cfg.n_layers // 2
