"""The models on ``DTensor``s: ``forward``, ``loss_fn`` and
``decode_step`` with DTensor parameters, inputs and caches on a one-rank
gloo mesh give the plain tensors' results bit for bit, one reduced config
of each family (the dry-run's families, ``tests/test_torch_dryrun.py``);
on a 2×2 gloo mesh of four processes the gradients of the regions run on
each rank's shards by hand equal the plain ones."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.launch import mesh as TM
from repro_torch.models import convert
from repro_torch.models import transformer as T

FAMILIES = {"gqa": "internlm2-1.8b", "mla": "minicpm3-4b",
            "hybrid": "hymba-1.5b", "ssm": "mamba2-130m",
            "moe": "qwen3-moe-235b-a22b", "mrope": "qwen2-vl-2b",
            "codebooks": "musicgen-medium"}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank_mesh():
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://localhost:{_free_port()}")
    try:
        yield TM.make_debug_mesh((1, 1), device="cpu")
    finally:
        dist.destroy_process_group()


def _spread(tree, specs, mesh):
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: _spread(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, list):
        return [_spread(v, s, mesh) for v, s in zip(tree, specs)]
    return distribute_tensor(tree, mesh, TM.placements(specs, mesh))


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _inputs(cfg, b, s, rng):
    if cfg.input_mode == "embeddings":
        return {"embeds": torch.from_numpy(rng.standard_normal(
                    (b, s, cfg.d_model), dtype=np.float32)),
                "positions": torch.from_numpy(np.broadcast_to(
                    np.arange(s, dtype=np.int32), (3, b, s)).copy())}
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, shape, dtype=np.int32))}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dtensor_parameters_equal_plain_bit_for_bit(one_rank_mesh, family):
    """forward, loss_fn and decode_step with DTensor parameters, inputs
    and caches on a (1, 1) mesh give the plain tensors' results bit for
    bit."""
    cfg = get_arch(FAMILIES[family]).reduced()
    mesh = one_rank_mesh
    rules = TM.make_rules(mesh)
    params = T.init_params(cfg, device="cpu", seed=3)
    dparams = _spread(params, convert.unstack_specs(
        T.param_pspecs(cfg, rules), params), mesh)
    rng = np.random.default_rng(7)
    b, s = 2, 32
    inputs = _inputs(cfg, b, s, rng)
    labels = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1
        else (b, s), dtype=np.int32))
    spec = lambda k, v: (T.P(None, rules.batch, None) if k == "positions"
                         else T.P(rules.batch, *(None,) * (v.ndim - 1)))
    dinputs = {k: _spread(v, spec(k, v), mesh) for k, v in inputs.items()}

    plain, _ = T.forward(params, cfg, inputs, rules=rules)
    dist_, _ = T.forward(dparams, cfg, dinputs, rules=rules)
    assert torch.equal(_full(dist_), plain)

    batch = {**inputs, "labels": labels}
    dbatch = {**dinputs, "labels": _spread(labels, spec("labels", labels),
                                           mesh)}
    loss, _ = T.loss_fn(params, cfg, batch, rules=rules)
    dloss, _ = T.loss_fn(dparams, cfg, dbatch, rules=rules)
    assert torch.equal(_full(dloss), loss)

    cache = T.init_cache(cfg, b, 16, torch.float32, device="cpu")
    dcache = _spread(cache, T.cache_pspecs(cfg, rules), mesh)
    step = {k: v[..., :1] if k == "positions" else v[:, :1]
            for k, v in inputs.items()}
    dstep = {k: _spread(v, spec(k, v), mesh) for k, v in step.items()}
    for length in (0, 1):
        logits, cache = T.decode_step(params, cfg, cache,
                                      {**step, "length": length},
                                      rules=rules)
        dlogits, dcache = T.decode_step(dparams, cfg, dcache,
                                        {**dstep, "length": length},
                                        rules=rules)
        assert torch.equal(_full(dlogits), logits)
    for k in cache:
        assert torch.equal(_full(dcache[k]), cache[k]), k


# one rank of the 2×2 mesh: loss and gradients with DTensor parameters and
# batch against the plain ones on the same seeded inputs; rank 0 prints
# {arch: [plain loss, DTensor loss, worst gradient error]}
_RANK = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from torch.utils import _pytree as pytree
rank, port, tests, archs = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            sys.argv[4:])
sys.path.insert(0, tests)
import test_torch_dtensor as TD
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as TM
from repro_torch.models import convert, layers as L, transformer as T
dist.init_process_group("gloo", world_size=4, rank=rank,
                        init_method=f"tcp://localhost:{port}")
mesh = TM.make_debug_mesh((2, 2), device="cpu")
rules = TM.make_rules(mesh)
out = {}
for arch in archs:
    cfg = get_arch(arch).reduced()
    params = T.init_params(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(7)
    b, s = 4, 32
    batch = TD._inputs(cfg, b, s, rng)
    batch["labels"] = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1
        else (b, s), dtype=np.int32))
    spec = lambda k, v: (T.P(None, rules.batch, None) if k == "positions"
                         else T.P(rules.batch, *(None,) * (v.ndim - 1)))
    dbatch = {k: TD._spread(v, spec(k, v), mesh) for k, v in batch.items()}
    dparams = TD._spread(params, convert.unstack_specs(
        T.param_pspecs(cfg, rules), params), mesh)
    leaves, tree = pytree.tree_flatten(params)
    dleaves = pytree.tree_leaves(dparams)
    for t in leaves + dleaves:
        t.requires_grad_()
    loss, _ = T.loss_fn(pytree.tree_unflatten(leaves, tree), cfg, batch,
                        rules=rules)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    dloss, _ = T.loss_fn(pytree.tree_unflatten(dleaves, tree), cfg, dbatch,
                         rules=rules)
    with L.dtensor_scope(dleaves):
        dgrads = torch.autograd.grad(dloss, dleaves, allow_unused=True)
    worst = 0.0
    for g, dg in zip(grads, dgrads):
        assert (g is None) == (dg is None)
        if g is not None:
            err = (g - dg.full_tensor()).abs().max() / g.abs().max()
            worst = max(worst, float(err))
    out[arch] = [float(loss), float(dloss.full_tensor().detach()), worst]
dist.destroy_process_group()
if rank == 0:
    print(json.dumps(out))
"""

GRAD_RTOL = 1e-5          # of each gradient's largest magnitude
LOSS_RTOL = 1e-6


def test_dtensor_gradients_on_a_2x2_mesh_equal_plain():
    """Four gloo ranks, a (data 2, model 2) mesh: the loss and every
    gradient with DTensor parameters equal the plain ones, for the
    families whose regions run on each rank's shards by hand and declare
    their gradients' pending sums themselves (the vocab-parallel lookup,
    the SSM's causal conv, the codebook heads, MoE's dispatch)."""
    archs = [FAMILIES[f] for f in ("gqa", "ssm", "codebooks", "moe")]
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), port, str(root / "tests"),
         *archs], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        outs.append(out)
    res = json.loads(outs[0].strip().splitlines()[-1])
    assert set(res) == set(archs)
    for arch, (loss, dloss, worst) in res.items():
        assert abs(dloss - loss) <= LOSS_RTOL * abs(loss), arch
        assert worst <= GRAD_RTOL, (arch, worst)
