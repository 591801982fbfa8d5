"""The port's int8 gradient compression against the reference's on the
CPU: ``int8_compress``/``compressed_psum``/``tree_compressed_psum`` at
p = 1 against the reference under its one-device ``shard_map``
(tests/test_train_integration.py:93), bit for bit; at p = 2 over two gloo
processes against the reference's ``compressed_psum`` over two host
devices, on the same arrays, bit for bit; and the int8 train steps.

The quantized values are exact functions of the same fp32 inputs, so the
comparisons on identical arrays are exact.  Through a train step the
gradients differ in the last bits between the packages, and where an
element sits at a rounding boundary of ``g / scale`` its int8 value
flips: those elements are counted and bounded separately."""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.utils import _pytree as pytree

from repro import compat
from repro.configs import get_arch
from repro.data import make_batch_iterator as ref_batches
from repro.models import transformer as JT
from repro.optim import compression as JC
from repro.train import step as JS
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.optim import (compressed_psum, int8_compress,
                               int8_decompress, tree_compressed_psum)
from repro_torch.train import step as TS

ROOT = Path(__file__).resolve().parents[1]


def _arrays(seed=0, shape=(9, 7)):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * 3).astype(np.float32)
    e = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    return g, np.asarray(jnp.asarray(e, jnp.bfloat16))


def _on_one_device(fn, *args):
    mesh = jax.make_mesh((1,), ("pod",))
    return compat.shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                            out_specs=P(), check_vma=False)(*args)


def test_int8_compress_matches_the_reference():
    g, _ = _arrays(1)
    q_ref, s_ref = JC.int8_compress(jnp.asarray(g))
    q, s = int8_compress(torch.from_numpy(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    assert float(s) == float(s_ref)
    np.testing.assert_array_equal(
        int8_decompress(q, s).numpy(),
        np.asarray(JC.int8_decompress(q_ref, s_ref)))


@pytest.mark.parametrize("with_error", [False, True])
def test_compressed_psum_one_rank_matches_the_reference(with_error):
    """p = 1: the dequantized gradient within scale/2 of g + error, the
    residual carried exactly, both equal to the reference's bits."""
    g, e = _arrays(2)
    args = (jnp.asarray(g),) + ((jnp.asarray(e),) if with_error else ())
    ref_avg, ref_err = _on_one_device(
        lambda g, *e: JC.compressed_psum(g, "pod", *(e or (None,))), *args)
    err_in = torch.from_numpy(e.astype(np.float32)).to(torch.bfloat16) \
        if with_error else None
    avg, err = compressed_psum(torch.from_numpy(g), None, err_in)
    np.testing.assert_array_equal(avg.numpy(), np.asarray(ref_avg))
    np.testing.assert_array_equal(err.numpy(), np.asarray(ref_err))
    target = g + (e.astype(np.float32) if with_error else 0)
    scale = np.abs(target).max() / 127.0
    assert np.abs(avg.numpy() - target).max() <= scale / 2 + 1e-6
    np.testing.assert_allclose(avg.numpy() + err.numpy(), target, atol=1e-6)


def test_tree_compressed_psum_matches_the_reference():
    g1, e1 = _arrays(3, (5, 4))
    g2, e2 = _arrays(4, (6,))
    jg = {"a": jnp.asarray(g1), "b": [jnp.asarray(g2)]}
    je = {"a": jnp.asarray(e1), "b": [jnp.asarray(e2)]}
    ref_avg, ref_err = _on_one_device(
        lambda g, e: JC.tree_compressed_psum(g, "pod", e), jg, je)
    tg = {"a": torch.from_numpy(g1), "b": [torch.from_numpy(g2)]}
    te = {"a": torch.from_numpy(e1.astype(np.float32)).to(torch.bfloat16),
          "b": [torch.from_numpy(e2.astype(np.float32)).to(torch.bfloat16)]}
    avg, err = tree_compressed_psum(tg, None, te)
    for a, b in zip(pytree.tree_leaves(avg), jax.tree_util.tree_leaves(
            ref_avg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(pytree.tree_leaves(err), jax.tree_util.tree_leaves(
            ref_err)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    _, zero_err = tree_compressed_psum(tg)              # errors default 0
    assert all(t.dtype == torch.bfloat16
               for t in pytree.tree_leaves(zero_err))


# ---------------------------------------------------------------------------
# p = 2: two gloo processes against the reference over two host devices
# ---------------------------------------------------------------------------

_RANK = textwrap.dedent("""
    import sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.optim import compressed_psum
    rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    a = np.load(path + "/in.npz")
    g = torch.from_numpy(a["g"][rank])
    e = torch.from_numpy(a["e"][rank]).to(torch.bfloat16)
    avg, err = compressed_psum(g, dist.group.WORLD, e)
    np.savez(path + f"/rank{rank}.npz", avg=avg.numpy(), err=err.numpy())
    dist.destroy_process_group()
""")

_REFERENCE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.optim.compression import compressed_psum
    path = sys.argv[1]
    a = np.load(path + "/in.npz")
    mesh = jax.make_mesh((2,), ("pod",))
    def body(g, e):
        avg, err = compressed_psum(g[0], "pod", e[0])
        return avg[None], err[None]
    fn = compat.shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                          out_specs=(P("pod"), P("pod")), check_vma=False)
    avg, err = fn(jnp.asarray(a["g"]),
                  jnp.asarray(a["e"]).astype(jnp.bfloat16))
    np.savez(path + "/ref.npz", avg=np.asarray(avg), err=np.asarray(err))
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_compressed_psum_two_ranks_matches_the_reference(tmp_path):
    """37 elements a rank (one of padding at p = 2): both ranks hold the
    reference's average, and each its own residual, bit for bit."""
    rng = np.random.default_rng(5)
    g = (rng.standard_normal((2, 37)) * [[1.0], [4.0]]).astype(np.float32)
    e = np.asarray(jnp.asarray(rng.standard_normal((2, 37)) * 0.01,
                               jnp.bfloat16)).astype(np.float32)
    np.savez(tmp_path / "in.npz", g=g, e=e)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                               str(port), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    procs.append(subprocess.Popen([sys.executable, "-c", _REFERENCE,
                                   str(tmp_path)], env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True))
    for proc in procs:
        _, err = proc.communicate(timeout=180)
        assert proc.returncode == 0, err
    ref = np.load(tmp_path / "ref.npz")
    for r in (0, 1):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_array_equal(got["avg"], ref["avg"][r])
        np.testing.assert_array_equal(got["err"], ref["err"][r])
    mean = (g + e).mean(0)                 # the average it approximates
    assert np.abs(ref["avg"][0] - mean).max() < 0.1


# ---------------------------------------------------------------------------
# int8 train steps
# ---------------------------------------------------------------------------

INT8_TC = dict(lr=1e-3, warmup=2, total_steps=20, grad_compression="int8_pod")


@pytest.fixture
def one_rank_gloo():
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://localhost:{_free_port()}")
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_int8_train_steps_match_the_reference(one_rank_gloo):
    """Two steps of the port's compressed step on a one-rank gloo group
    equal the port's make_train_step with the int8 branch (no group) bit
    for bit, and match the reference's compressed step on a one-device
    'pod' mesh: loss and grad norm 1e-5 relative, error buffers bf16;
    params within 5e-5 except elements whose int8 gradient rounded the
    other way (Adam moves those by up to 2·lr), fewer than 0.2%."""
    jcfg = get_arch("mamba2-130m").reduced()
    cfg = tconfigs.get_arch("mamba2-130m").reduced()
    jtc, tc = JS.TrainConfig(**INT8_TC), TS.TrainConfig(**INT8_TC)
    jp, js = JS.init_train_state(jax.random.key(0), jcfg, jtc)
    params = convert.load_reference_params(
        jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    state = TS.init_state(cfg, tc, params)
    jstep = jax.jit(JS.make_compressed_train_step(
        jcfg, jtc, JT.ShardRules(batch=("pod",), model=None),
        jax.make_mesh((1,), ("pod",))))
    step = TS.make_compressed_train_step(cfg, tc, one_rank_gloo)
    plain = TS.make_train_step(cfg, tc)
    p2, s2 = params, state
    it = ref_batches(jcfg, 2, 32, seed=1)
    for _ in range(2):
        batch = next(it)
        jp, js, jm = jstep(jp, js, batch)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        params, state, m = step(params, state, tb)
        p2, s2, m2 = plain(p2, s2, tb)
        for a, b in zip(pytree.tree_leaves((params, state, m)),
                        pytree.tree_leaves((p2, s2, m2))):
            assert torch.equal(a, b)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    assert all(t.dtype == torch.bfloat16 and torch.isfinite(t).all()
               for t in pytree.tree_leaves(state["ef"]))
    got = convert.to_reference(params)
    n = flipped = 0
    for path, b in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jp)):
        a = got
        for k in path:
            a = a[k.key]
        d = np.abs(a - b)
        assert d.max() <= 2 * INT8_TC["lr"], jax.tree_util.keystr(path)
        n += d.size
        flipped += int((d > 5e-5).sum())
    assert flipped < 0.002 * n, (flipped, n)
