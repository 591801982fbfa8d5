"""The port's training path against the reference on the CPU: ``loss_fn``
and its gradient (remat on and off), the vocab-pad mask, train steps from
weights carried across, gradient accumulation, the train loop's resume
(within the port and across the two packages), the pod-loss restart and
the CLI.

Tolerances, each stated where it is used: losses 1e-5 relative (fp32
sums in another order); gradients 1e-4 relative to each leaf's largest
entry; parameters after AdamW steps 5e-5 absolute (Adam moves an element
by about lr, so a rounding of g where |g| ~ sqrt(nu) moves it by up to
that), grad norms 1e-5 relative.  Within the port on the CPU, resume and
remat are bit-exact."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_arch
from repro.data import make_batch_iterator as ref_batches
from repro.launch import train as JL
from repro.models import transformer as JT
from repro.train import step as JS
from repro_torch import configs as tconfigs
from repro_torch.ckpt import CheckpointManager, restore
from repro_torch.core import ComputeResource, PilotManager, remesh_restart
from repro_torch.data import make_batch_iterator
from repro_torch.launch import train as TLaunch
from repro_torch.models import convert
from repro_torch.models import transformer as TT
from repro_torch.train import step as TS

LOSS_ARCHS = ["internlm2-1.8b", "mamba2-130m", "hymba-1.5b",
              "musicgen-medium"]
GRAD_RTOL = 1e-4           # of each leaf's largest |gradient|
PARAM_ATOL = 5e-5
QUIET = dict(log=lambda *_: None)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, s) if cfg.n_codebooks == 1 else (b, s, cfg.n_codebooks)
    return {"tokens": rng.integers(0, cfg.vocab_size, shape, dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _reference_grad(arch):
    cfg = get_arch(arch).reduced()
    params = JT.init_params(jax.random.key(0), cfg)
    inputs = _inputs(cfg)
    (loss, _), grads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, cfg, {k: jnp.asarray(v)
                                      for k, v in inputs.items()}),
        has_aux=True)(params)
    return _np(params), inputs, float(loss), _np(grads)


def _port_grad(params_np, cfg, inputs, remat):
    params = convert.load_reference_params(params_np, cfg, device="cpu")
    leaves, spec = pytree.tree_flatten(params)
    for p in leaves:
        p.requires_grad_()
    loss, metrics = TT.loss_fn(params, cfg, _t(inputs), remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, pytree.tree_unflatten(list(grads), spec)


def _assert_tree_close(port_np, ref_np, rtol_of_max):
    flat_p = jax.tree_util.tree_leaves_with_path(port_np)
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref_np))
    assert len(flat_p) == len(flat_r)
    for path, a in flat_p:
        b = np.asarray(flat_r[path], np.float32)
        atol = rtol_of_max * max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grad_match_the_reference(arch, remat):
    params_np, inputs, ref_loss, ref_grads = _reference_grad(arch)
    cfg = tconfigs.get_arch(arch).reduced()
    loss, metrics, grads = _port_grad(params_np, cfg, inputs, remat)
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    assert set(metrics) == {"ce", "loss"}
    _assert_tree_close(convert.to_reference(grads), ref_grads, GRAD_RTOL)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "hymba-1.5b"])
def test_remat_gives_the_same_gradients_bit_for_bit(arch):
    params_np, inputs, _, _ = _reference_grad(arch)
    cfg = tconfigs.get_arch(arch).reduced()
    _, _, g_on = _port_grad(params_np, cfg, inputs, True)
    _, _, g_off = _port_grad(params_np, cfg, inputs, False)
    for a, b in zip(pytree.tree_leaves(g_on), pytree.tree_leaves(g_off)):
        assert torch.equal(a, b)


def _padded(module_cfg):
    return dataclasses.replace(module_cfg("internlm2-1.8b").reduced(),
                               vocab_size=251)          # pads to 256


def test_pad_columns_get_no_gradient_and_loss_is_unpadded():
    """tests/test_vocab_padding.py's cases: the pad columns of the head
    get zero gradient, real columns get some, and the loss equals a plain
    251-column cross entropy and the reference's loss (1e-5)."""
    jcfg, cfg = _padded(get_arch), _padded(tconfigs.get_arch)
    assert cfg.padded_vocab_size == 256
    params_np = _np(JT.init_params(jax.random.key(0), jcfg))
    inputs = {"tokens": (np.arange(16, dtype=np.int32)[None] % 251),
              "labels": ((np.arange(16, dtype=np.int32)[None] + 1) % 251)}
    ref_loss, _ = JT.loss_fn(jax.tree_util.tree_map(jnp.asarray, params_np),
                             jcfg, {k: jnp.asarray(v)
                                    for k, v in inputs.items()})
    loss, metrics, grads = _port_grad(params_np, cfg, inputs, True)
    assert torch.isfinite(metrics["loss"])
    assert float(grads["head"][:, 251:].abs().sum()) == 0.0
    assert float(grads["head"][:, :251].abs().sum()) > 0.0
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    params = convert.load_reference_params(params_np, cfg, device="cpu")
    with torch.no_grad():
        logits, _ = TT.forward(params, cfg, _t(inputs))
    lg = logits[..., :251].float()
    gold = torch.gather(lg, -1, _t(inputs)["labels"].long()[..., None])
    manual = (torch.logsumexp(lg, -1) - gold[..., 0]).mean()
    np.testing.assert_allclose(float(loss.detach()), float(manual),
                               rtol=1e-5)


def test_kernel_impl_raises_under_autograd():
    cfg = tconfigs.get_arch("internlm2-1.8b").reduced()
    params = TT.init_params(cfg, device="cpu")
    inputs = _t(_inputs(cfg))
    with torch.no_grad():                     # forward-only: allowed
        loss, _ = TT.loss_fn(params, cfg, inputs, impl="kernel")
    assert torch.isfinite(loss)
    params["head"].requires_grad_()
    with pytest.raises(NotImplementedError, match="no gradient"):
        TT.loss_fn(params, cfg, inputs, impl="kernel")
    tc = TS.TrainConfig(attn_impl="kernel")
    with pytest.raises(NotImplementedError, match="no gradient"):
        TS.make_train_step(cfg, tc)(params, TS.init_state(cfg, tc, params),
                                    inputs)


# ---------------------------------------------------------------------------
# train steps from weights carried across
# ---------------------------------------------------------------------------

STEP_TC = dict(lr=1e-3, warmup=2, total_steps=20)


def _both_steps(arch, n_steps, **tc_kw):
    """n_steps of the reference's jitted step and of the port's, from the
    reference's initial params and zero state, on the same numpy batches.
    Returns [(ref_params, ref_metrics, port_params, port_metrics)] a step."""
    jcfg = get_arch(arch).reduced()
    cfg = tconfigs.get_arch(arch).reduced()
    jtc = JS.TrainConfig(**STEP_TC, **tc_kw)
    tc = TS.TrainConfig(**STEP_TC, **tc_kw)
    jparams, jstate = JS.init_train_state(jax.random.key(0), jcfg, jtc)
    params = convert.load_reference_params(_np(jparams), cfg, device="cpu")
    state = TS.init_state(cfg, tc, params)
    jstep = jax.jit(JS.make_train_step(jcfg, jtc))
    step = TS.make_train_step(cfg, tc)
    it = ref_batches(jcfg, 4, 32, seed=1)
    out = []
    for _ in range(n_steps):
        batch = next(it)
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        params, state, m = step(params, state, _t(batch))
        out.append((jparams, jm, params, m))
    assert int(state["step"]) == n_steps
    return out


@pytest.mark.parametrize("arch,n_steps", [("internlm2-1.8b", 1),
                                          ("internlm2-1.8b", 3),
                                          ("mamba2-130m", 3),
                                          ("nemotron-4-340b", 3)])
def test_train_steps_match_the_reference(arch, n_steps):
    """AdamW (and, for nemotron, Adafactor over the stacked layout):
    params within 5e-5 after each step, grad norm 1e-5 and loss 1e-5
    relative."""
    for jparams, jm, params, m in _both_steps(arch, n_steps):
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        got = convert.to_reference(params)
        for path, b in jax.tree_util.tree_leaves_with_path(_np(jparams)):
            a = got
            for k in path:
                a = a[k.key]
            np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0,
                                       err_msg=jax.tree_util.keystr(path))


def test_microbatches_two_equal_one():
    """tests/test_train_integration.py:27 in the port: loss within 1e-4,
    params atol 3e-5 / rtol 3e-4; and m = 2 against the reference's m = 2
    (the tolerances above)."""
    cfg = tconfigs.get_arch("mamba2-130m").reduced()
    rng = np.random.default_rng(0)
    inputs = {k: rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int32)
              for k in ("tokens", "labels")}
    jparams, _ = JS.init_train_state(jax.random.key(2), get_arch(
        "mamba2-130m").reduced(), JS.TrainConfig())
    outs = {}
    for m in (1, 2):
        tc = TS.TrainConfig(microbatches=m)
        params = convert.load_reference_params(_np(jparams), cfg,
                                               device="cpu")
        p2, _, metrics = TS.make_train_step(cfg, tc)(
            params, TS.init_state(cfg, tc, params), _t(inputs))
        outs[m] = (p2, float(metrics["loss"]))
    assert abs(outs[1][1] - outs[2][1]) < 1e-4
    for a, b in zip(pytree.tree_leaves(outs[1][0]),
                    pytree.tree_leaves(outs[2][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5,
                                   rtol=3e-4)
    jtc = JS.TrainConfig(microbatches=2)
    jcfg = get_arch("mamba2-130m").reduced()
    jp2, _, jm = jax.jit(JS.make_train_step(jcfg, jtc))(
        jparams, JS.init_train_state(jax.random.key(2), jcfg, jtc)[1],
        inputs)
    np.testing.assert_allclose(outs[2][1], float(jm["loss"]), rtol=1e-5)
    _assert_tree_close(convert.to_reference(outs[2][0]), _np(jp2), 1e-4)


# ---------------------------------------------------------------------------
# the train loop: resume, cross-package resume, pod loss, CLI
# ---------------------------------------------------------------------------

RESUME_TC = dict(lr=1e-3, warmup=2, total_steps=20)


def test_checkpoint_resume_bit_exact(tmp_path):
    """Stop at step 10, resume to 20 == straight run to 20, bit for bit."""
    cfg = tconfigs.get_arch("mamba2-130m").reduced()
    tc = TS.TrainConfig(**RESUME_TC)
    d = str(tmp_path / "a")
    kw = dict(batch=2, seq_len=32, device="cpu", **QUIET)
    TLaunch.train_loop(cfg, tc, steps=10, ckpt_dir=d, ckpt_every=10, **kw)
    logs = []
    p_res, s_res, _ = TLaunch.train_loop(cfg, tc, steps=20, ckpt_dir=d,
                                         ckpt_every=10, batch=2, seq_len=32,
                                         device="cpu", log=logs.append)
    assert "resumed from step 10" in logs
    p_str, s_str, _ = TLaunch.train_loop(cfg, tc, steps=20, **kw)
    for a, b in zip(pytree.tree_leaves((p_res, s_res)),
                    pytree.tree_leaves((p_str, s_str))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume_across_packages(tmp_path, writer):
    """A checkpoint written at step 2 by one package's train loop resumes
    in the other's, which then matches the reference's straight run to
    step 4 (params within 5e-5)."""
    jcfg = get_arch("mamba2-130m").reduced()
    cfg = tconfigs.get_arch("mamba2-130m").reduced()
    jtc, tc = JS.TrainConfig(**RESUME_TC), TS.TrainConfig(**RESUME_TC)
    d = str(tmp_path / "ck")
    kw = dict(batch=2, seq_len=32)
    # both packages start from the reference's weights: the port's run
    # writing step 0 takes them from a reference checkpoint at step 0
    jp0, js0 = JS.init_train_state(jax.random.key(0), jcfg, jtc)
    from repro.ckpt import save as ref_save
    logs = []
    if writer == "reference":
        JL.train_loop(jcfg, jtc, steps=2, ckpt_dir=d, **kw, **QUIET)
        params, _, _ = TLaunch.train_loop(cfg, tc, steps=4, ckpt_dir=d,
                                          device="cpu", log=logs.append,
                                          **kw)
        got = convert.to_reference(params)
        leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    else:
        ref_save(d, 0, {"params": jp0, "state": js0})
        TLaunch.train_loop(cfg, tc, steps=2, ckpt_dir=d, device="cpu",
                           **kw, **QUIET)
        jparams, _, _ = JL.train_loop(jcfg, jtc, steps=4, ckpt_dir=d,
                                      log=logs.append, **kw)
        leaves = dict(jax.tree_util.tree_leaves_with_path(_np(jparams)))
    assert "resumed from step 2" in logs
    jref, _, _ = JL.train_loop(jcfg, jtc, steps=4, **kw, **QUIET)
    for path, b in jax.tree_util.tree_leaves_with_path(_np(jref)):
        np.testing.assert_allclose(np.asarray(leaves[path]), b,
                                   atol=PARAM_ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_pod_loss_checkpoint_restart(tmp_path):
    """tests/test_fault_tolerance.py's pod loss in the port: train 6
    steps on a two-device pilot, checkpoint, lose the pilot (its devices
    go with it), restore onto the replacement pilot's device through
    remesh_restart, train 3 more: equal to an uninterrupted run, bit for
    bit on the CPU."""
    cfg = tconfigs.get_arch("mamba2-130m").reduced()
    tc = TS.TrainConfig(**RESUME_TC)
    cpu = torch.device("cpu")
    mgr = PilotManager(devices=(cpu, cpu, cpu))
    pilot = mgr.submit_pilot(ComputeResource(tier="cloud", n_devices=2))
    step_fn = TS.make_train_step(cfg, tc)
    it = make_batch_iterator(cfg, 2, 32, seed=1, device="cpu")
    batches = [next(it) for _ in range(9)]
    params, state = TS.init_train_state(cfg, tc, device=pilot.devices[0])
    init = (params, state)
    for i in range(6):
        params, state, _ = step_fn(params, state, batches[i])
    ck = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    like = {"params": params, "state": state}
    ck.save(6, convert.stack_blocks(like))

    def restore_fn(new_pilot):
        got = restore(str(tmp_path), 6, like=convert.stack_blocks(like),
                      device=new_pilot.devices[0])
        return convert.unstack_blocks(got, like)

    new_pilot, restored = remesh_restart(mgr, pilot, 1,
                                         restore_fn=restore_fn)
    assert new_pilot.state == "active" and len(new_pilot.devices) == 1
    r_params, r_state = restored["params"], restored["state"]
    assert int(r_state["step"]) == 6
    for i in range(6, 9):
        r_params, r_state, m2 = step_fn(r_params, r_state, batches[i])
    p_ref, s_ref = init
    for i in range(9):
        p_ref, s_ref, m_ref = step_fn(p_ref, s_ref, batches[i])
    assert float(m2["loss"]) == float(m_ref["loss"])
    for a, b in zip(pytree.tree_leaves(r_params),
                    pytree.tree_leaves(p_ref)):
        assert torch.equal(a, b)


def test_train_driver_cli(tmp_path):
    rc = TLaunch.main(["--arch", "mamba2-130m", "--reduced", "--steps", "4",
                       "--batch", "2", "--seq", "32", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "c")])
    assert rc == 0
    assert os.path.isdir(tmp_path / "c" / "step_4")


def test_entry_points_default_to_the_card():
    """Without a device the training entry points ask for cuda:0, which
    raises on a host without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tconfigs.get_arch("mamba2-130m").reduced()
    tc = TS.TrainConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.init_train_state(cfg, tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLaunch.train_loop(cfg, tc, steps=1, batch=1, seq_len=8, **QUIET)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLaunch.main(["--arch", "mamba2-130m", "--reduced", "--steps", "1"])


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """ROADMAP C2: in a 256-step chunk with dt·A = −2.4 a step, cum_i −
    cum_j above the diagonal passes fp32's exp range.  The reference masks
    after the exp, so its dt gradient is NaN (pinned here); the port masks
    before it, and its gradient at chunk 256 equals the reference's at
    chunk 16, where nothing overflows (1e-4 of each leaf's largest)."""
    from repro.models import layers as JLay
    from repro_torch.models import layers as TLay
    rng = np.random.default_rng(0)
    xh = rng.standard_normal((1, 256, 2, 4)).astype(np.float32)
    dt = np.full((1, 256, 2), 0.1, np.float32)
    rest = (np.array([-1.0, -24.0], np.float32),
            rng.standard_normal((1, 256, 1, 8)).astype(np.float32),
            rng.standard_normal((1, 256, 1, 8)).astype(np.float32),
            np.ones(2, np.float32))

    def ref_grad(chunk):
        return jax.grad(lambda x, d: JLay.ssd_chunked(
            x, d, *map(jnp.asarray, rest), chunk).sum(), argnums=(0, 1))(
            jnp.asarray(xh), jnp.asarray(dt))

    assert np.isnan(np.asarray(ref_grad(256)[1])).any()
    x = torch.from_numpy(xh).requires_grad_()
    d = torch.from_numpy(dt).requires_grad_()
    TLay.ssd_chunked(x, d, *map(torch.from_numpy, rest), 256).sum().backward()
    for got, want in zip((x.grad, d.grad), ref_grad(16)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
