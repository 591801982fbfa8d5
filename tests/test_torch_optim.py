"""``repro_torch.optim`` against ``repro.optim`` on the CPU: the same
seeded numpy tree of params and gradients through both packages'
``adamw`` / ``adafactor`` for one and ten updates, and the schedule and
clipping helpers.  Tolerance: 1e-6 relative (fp32 formulas evaluated in
the same order; ``pow``, ``sqrt`` and ``rsqrt`` may round an ulp apart)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
import repro_torch.optim as topt

RTOL = 1e-6
# absolute floor for entries that are 0 or cancel to near 0
ATOL = 1e-9


def _tree(rng):
    """A small tree: a matrix, a bias vector, a stacked 3-d leaf, a scalar
    leaf (the factored and unfactored Adafactor cases)."""
    shapes = {"w": (6, 5), "b": (5,), "stack": [(2, 3, 4)], "s": ()}
    return {"w": rng.standard_normal(shapes["w"]).astype(np.float32),
            "b": rng.standard_normal(shapes["b"]).astype(np.float32),
            "stack": [rng.standard_normal((2, 3, 4)).astype(np.float32)],
            "s": np.float32(rng.standard_normal())}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want):
    """Every leaf of a torch tree within tolerance of a jax tree."""
    got_l = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
    want_l = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _run(jo, to, n_steps, seed):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    pj, pt = _to_jax(params), _to_torch(params)
    sj, st = jo.init(pj), to.init(pt)
    for step in range(n_steps):
        grads = _tree(rng)
        uj, sj = jo.update(_to_jax(grads), sj, pj, step)
        ut, st = to.update(_to_torch(grads), st, pt, step)
        _close(ut, uj)
        pj = jax.tree.map(lambda p, u: p + u, pj, uj)
        pt = jax.tree.map(lambda p, u: p + u, pt, ut)
    _close(pt, pj)
    _close(st, sj)


@pytest.mark.parametrize("n_steps", [1, 10])
@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.0},
                                {"b1": 0.8, "b2": 0.99, "eps": 1e-6}])
def test_adamw_matches_reference(n_steps, kw):
    lr = jopt.cosine_schedule(1e-2, 3, 20)
    lr_t = topt.cosine_schedule(1e-2, 3, 20)
    _run(jopt.adamw(lr, **kw), topt.adamw(lr_t, **kw), n_steps, seed=1)


@pytest.mark.parametrize("n_steps", [1, 10])
@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.01},
                                {"clip_threshold": 0.5}])
def test_adafactor_matches_reference(n_steps, kw):
    _run(jopt.adafactor(lambda s: 1e-2, **kw),
         topt.adafactor(lambda s: 1e-2, **kw), n_steps, seed=2)


def test_make_optimizer_names():
    assert isinstance(topt.make_optimizer("adamw", lambda s: 1e-3),
                      topt.optimizers.Optimizer)
    assert isinstance(topt.make_optimizer("adafactor", lambda s: 1e-3),
                      topt.optimizers.Optimizer)
    with pytest.raises(ValueError):
        topt.make_optimizer("sgd", lambda s: 1e-3)


def test_adamw_defaults_are_the_reference_formulas():
    """b2 = 0.95, bias correction at step + 1, eps after the sqrt and
    weight decay added to the update, written out by hand for one
    element."""
    p, g = torch.tensor([2.0]), torch.tensor([0.5])
    opt = topt.adamw(lambda s: 0.1)
    upd, st = opt.update(g, opt.init(p), p, 0)
    mu, nu = 0.1 * 0.5, 0.05 * 0.25
    want = -0.1 * ((mu / 0.1) / (np.sqrt(nu / 0.05) + 1e-8) + 0.1 * 2.0)
    np.testing.assert_allclose(upd.numpy(), [want], rtol=1e-6)
    np.testing.assert_allclose(st["nu"].numpy(), [nu], rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 4, 5, 12, 99, 150])
def test_cosine_schedule_matches_reference(step):
    j = jopt.cosine_schedule(3e-4, 5, 100, min_ratio=0.2)
    t = topt.cosine_schedule(3e-4, 5, 100, min_ratio=0.2)
    np.testing.assert_allclose(float(t(step)), float(j(step)), rtol=RTOL)
    np.testing.assert_allclose(float(t(torch.tensor(step))), float(j(step)),
                               rtol=RTOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _tree(np.random.default_rng(3))
    cj, nj = jopt.clip_by_global_norm(_to_jax(grads), max_norm)
    ct, nt = topt.clip_by_global_norm(_to_torch(grads), max_norm)
    np.testing.assert_allclose(float(nt), float(nj), rtol=RTOL)
    _close(ct, cj)
