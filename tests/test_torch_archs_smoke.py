"""``tests/test_archs_smoke.py``'s fast trio through the port on the CPU:
one SSM (mamba2-130m), the embeddings arch (qwen2-vl-2b) and one MoE
(qwen3-moe-235b-a22b), reduced: forward shapes without NaN, one train
step, one decode step, finite loss gradients.  Each also against the
reference on the same weights and inputs: the train step's loss, grad
norm and metrics (the MoE aux values among them) 1e-5 relative and its
params within 5e-5 (Adam moves an element by about lr), as
``tests/test_torch_train.py`` holds them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_arch
from repro.data import make_batch_iterator as ref_batches
from repro.models import transformer as JT
from repro.train import step as JS
from repro_torch import configs as tconfigs
from repro_torch.launch import train as TLaunch
from repro_torch.models import convert
from repro_torch.models import transformer as TT
from repro_torch.train import step as TS

FAST_ARCHS = ("mamba2-130m", "qwen2-vl-2b", "qwen3-moe-235b-a22b")
STEP_TC = dict(lr=1e-3, warmup=2, total_steps=20)


def _inputs(cfg, b=2, s=32, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return {"embeds": torch.from_numpy(rng.standard_normal(
                    (b, s, cfg.d_model)).astype(np.float32)),
                "positions": torch.arange(s, dtype=torch.int32)[
                    None, None].repeat(3, b, 1),
                "labels": torch.zeros((b, s), dtype=torch.int32)}
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    shape)),
            "labels": torch.zeros(shape, dtype=torch.int32)}


@pytest.mark.parametrize("arch", FAST_ARCHS)
def test_forward_shapes_no_nan(arch):
    cfg = tconfigs.get_arch(arch).reduced()
    params = TT.init_params(cfg, device="cpu")
    logits, aux = TT.forward(params, cfg, _inputs(cfg))
    assert tuple(logits.shape) == (2, 32, cfg.padded_vocab_size)
    assert not bool(torch.isnan(logits).any())
    assert set(aux) == ({"lb_loss", "z_loss", "dropped_frac"}
                        if cfg.moe is not None else set())


@pytest.mark.parametrize("arch", FAST_ARCHS)
def test_train_step_matches_the_reference(arch):
    jcfg = get_arch(arch).reduced()
    cfg = tconfigs.get_arch(arch).reduced()
    jtc, tc = JS.TrainConfig(**STEP_TC), TS.TrainConfig(**STEP_TC)
    jparams, jstate = JS.init_train_state(jax.random.key(0), jcfg, jtc)
    params = convert.load_reference_params(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    state = TS.init_state(cfg, tc, params)
    before = [t.clone() for t in pytree.tree_leaves(params)]
    batch = next(ref_batches(jcfg, 2, 32, seed=1))
    jparams, _, jm = jax.jit(JS.make_train_step(jcfg, jtc))(
        jparams, jstate, batch)
    params, state, m = TS.make_train_step(cfg, tc)(
        params, state, {k: torch.from_numpy(np.asarray(v))
                        for k, v in batch.items()})
    assert int(state["step"]) == 1
    assert not bool(torch.isnan(m["loss"])) and float(m["grad_norm"]) > 0
    assert set(m) == set(jm)
    for name in jm:
        np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    delta = sum(float((a - b).abs().sum()) for a, b in
                zip(pytree.tree_leaves(params), before))
    assert delta > 0
    got = convert.to_reference(params)
    for path, want in jax.tree_util.tree_leaves_with_path(jparams):
        a = got
        for k in path:
            a = a[k.key]
        np.testing.assert_allclose(a, np.asarray(want), atol=5e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", FAST_ARCHS)
def test_decode_step(arch):
    cfg = tconfigs.get_arch(arch).reduced()
    params = TT.init_params(cfg, device="cpu")
    b = 2
    cache = TT.init_cache(cfg, b, 16, torch.float32, device="cpu")
    want = {k: (tuple(v.shape), v.dtype) for k, v in cache.items()}
    ref = JT.init_cache(get_arch(arch).reduced(), b, 16, jnp.float32)
    assert {k: s for k, (s, _) in want.items()} == {
        k: v.shape for k, v in ref.items()}
    if cfg.input_mode == "embeddings":
        inp = {"embeds": torch.randn((b, 1, cfg.d_model),
                                     generator=torch.Generator()
                                     .manual_seed(2)),
               "positions": torch.zeros((3, b, 1), dtype=torch.int32)}
    else:
        inp = {"tokens": torch.ones((b, 1), dtype=torch.int64)}
    logits, new_cache = TT.decode_step(params, cfg, cache,
                                       {**inp, "length": 0})
    assert not bool(torch.isnan(logits).any())
    assert logits.shape[1] == 1
    assert {k: (tuple(v.shape), v.dtype)
            for k, v in new_cache.items()} == want


@pytest.mark.parametrize("arch", FAST_ARCHS)
def test_loss_grads_finite(arch):
    cfg = tconfigs.get_arch(arch).reduced()
    params = TT.init_params(cfg, device="cpu")
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.requires_grad_() for p in leaves]
    loss, _ = TT.loss_fn(pytree.tree_unflatten(leaves, spec), cfg,
                         _inputs(cfg))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for g in grads:
        assert g is None or bool(torch.isfinite(g).all())
    assert sum(g is not None for g in grads) == len(leaves)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "qwen2-vl-2b"])
def test_train_driver_cli(arch, tmp_path, capsys):
    rc = TLaunch.main(["--arch", arch, "--reduced", "--steps", "2",
                       "--batch", "2", "--seq", "32", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "c")])
    assert rc == 0
    assert "step     1 loss" in capsys.readouterr().out
    assert (tmp_path / "c" / "step_2").is_dir()
