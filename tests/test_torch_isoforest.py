"""``repro_torch.ml.isoforest`` against ``repro.ml.isoforest`` on the CPU.

``jax.random`` streams cannot be matched, so parity is split in two:
* on a forest ``repro`` built and carried across as tensors, the port's
  ``_path_length`` gives the same depths and leaves exactly (the same fp32
  comparisons), and ``_score`` agrees within 1e-6 (the mean over the
  trees may sum in another order);
* the port's own fit is held to tests/test_ml.py's detection band and to
  the structure every isolation tree has.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.ml as jml
import repro.ml.isoforest as JI
import repro_torch.core as tcore
import repro_torch.ml as tml
import repro_torch.ml.isoforest as TI

SCORE_ATOL = 1e-6


def _data(n=1_500, frac=0.03, seed=4):
    return jml.MiniAppGenerator(n_points=n, outlier_frac=frac,
                                seed=seed).sample_with_labels()


def _ref_forest(pts, n_trees, psi=256, seed=0):
    f = jml.IsolationForest(n_trees=n_trees, psi=psi, seed=seed)
    st = f.fit(pts)
    return f, st, jax.tree.map(np.asarray, st)


def _auc(s, is_out):
    order = np.argsort(s)
    ranks = np.empty_like(order, float)
    ranks[order] = np.arange(len(s))
    return (ranks[is_out].mean() - ranks.mean()) / len(s) + 0.5


@pytest.mark.parametrize("n_trees,psi,n", [(50, 256, 1_500), (7, 64, 300),
                                           (3, 256, 100)])
def test_path_length_and_score_on_a_reference_forest(n_trees, psi, n):
    pts, _ = _data(n)
    f, st, tree = _ref_forest(pts, n_trees, psi)
    st_t = TI.load_reference_state(tree, "cpu")
    x = np.concatenate([pts, np.random.default_rng(1).standard_normal(
        (64, 32)) * 30]).astype(np.float32)
    # depths plus leaf continuations, every tree: the reference's walk
    # vmapped over the forest, as its _score does
    walk = jax.jit(jax.vmap(lambda t, xs: JI._path_length(t, xs,
                                                          f.max_depth),
                            in_axes=(0, None)))
    want = np.asarray(walk(st["forest"], jnp.asarray(x)))
    got = TI._path_length(st_t["forest"], torch.from_numpy(x),
                          f.max_depth).numpy()
    np.testing.assert_array_equal(got, want)
    node, depth = TI._walk(st_t["forest"], torch.from_numpy(x), f.max_depth)
    assert bool(st_t["forest"]["is_leaf"].gather(1, node).all())
    assert float(depth.max()) <= f.max_depth
    got = tml.IsolationForest(n_trees=n_trees, psi=psi,
                              device="cpu").outlier_scores(st_t, x).numpy()
    want = np.asarray(f.outlier_scores(st, x))
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)


def test_c_matches_reference():
    n = np.array([0, 1, 2, 3, 10, 255, 256, 1e4], np.float32)
    np.testing.assert_allclose(TI._c(torch.from_numpy(n)).numpy(),
                               np.asarray(JI._c(n)), rtol=1e-6)


def test_isoforest_separates_outliers():
    """tests/test_ml.py's band on the port's own fit."""
    pts, is_out = _data()
    f = tml.IsolationForest(n_trees=50, device="cpu")
    s = f.outlier_scores(f.fit(pts), pts).numpy()
    assert s[is_out].mean() > s[~is_out].mean() + 0.05
    assert _auc(s, is_out) > 0.85


def test_fit_layout_and_tree_structure():
    pts, _ = _data(600, seed=5)
    f = tml.IsolationForest(n_trees=20, psi=128, device="cpu")
    st = f.fit(pts)
    forest = st["forest"]
    _, _, ref = _ref_forest(pts, 20, 128)
    for k, v in forest.items():
        assert v.shape == ref["forest"][k].shape
        assert str(v.dtype).split(".")[-1] == str(ref["forest"][k].dtype)
    assert float(st["psi"]) == 128.0
    size, leaf = forest["size"].numpy(), forest["is_leaf"].numpy()
    thr, feat = forest["threshold"].numpy(), forest["feature"].numpy()
    n_nodes = size.shape[1]
    inner = np.arange((n_nodes - 1) // 2)
    assert (size[:, 0] == 128).all()
    assert (feat >= 0).all() and (feat < 32).all()
    assert leaf[:, (n_nodes - 1) // 2:].all()
    # a split node passes every point to one of its children; a leaf
    # passes none on
    kids = size[:, 2 * inner + 1] + size[:, 2 * inner + 2]
    split = ~leaf[:, inner]
    np.testing.assert_array_equal(kids[split], size[:, inner][split])
    assert (kids[~split] == 0).all()
    assert np.isfinite(thr[:, inner][split]).all()
    # the leaves hold the subsample
    np.testing.assert_array_equal((size * leaf).sum(1), 128.0)


def test_empty_nodes_keep_nan_thresholds():
    """An empty node's segment min/max are ±inf (scatter_reduce started
    from ±inf), so its threshold is inf + u·(−inf − inf) = NaN, as the
    reference's segment_min/max give."""
    pts, _ = _data(400, seed=6)
    st = tml.IsolationForest(n_trees=10, device="cpu").fit(pts)
    forest = st["forest"]
    n_inner = (forest["size"].shape[1] - 1) // 2
    empty = (forest["size"][:, :n_inner] == 0)
    thr = forest["threshold"][:, :n_inner]
    assert empty.any()
    assert torch.isnan(thr[empty]).all()
    assert not torch.isnan(thr[~empty]).any()
    assert forest["is_leaf"][:, :n_inner][empty].all()
    _, _, ref = _ref_forest(pts, 10)
    ref_empty = ref["forest"]["size"][:, :n_inner] == 0
    assert np.isnan(ref["forest"]["threshold"][:, :n_inner][ref_empty]).all()


def test_subsample_is_drawn_with_replacement():
    """ψ = n: a draw with replacement repeats points, so some leaves hold
    more than one copy of a point while the root still counts ψ."""
    pts, _ = _data(256, seed=7)
    st = tml.IsolationForest(n_trees=4, device="cpu").fit(pts)
    size, leaf = st["forest"]["size"], st["forest"]["is_leaf"]
    assert (size[:, 0] == 256).all()
    deep = size[:, 255:][leaf[:, 255:]]
    assert (deep > 1).any()


def test_fit_is_seeded():
    pts, _ = _data(500, seed=8)
    a = tml.IsolationForest(n_trees=5, seed=3, device="cpu").fit(pts)
    b = tml.IsolationForest(n_trees=5, seed=3, device="cpu").fit(pts)
    c = tml.IsolationForest(n_trees=5, seed=4, device="cpu").fit(pts)
    for k in a["forest"]:
        assert torch.equal(a["forest"][k].nan_to_num(),
                           b["forest"][k].nan_to_num())
    assert not torch.equal(a["forest"]["feature"], c["forest"]["feature"])


def test_processor_refits_each_message_and_flags_above_0_6():
    gen = jml.MiniAppGenerator(n_points=800, seed=12)
    msgs = [gen.sample() for _ in range(3)]
    ps = tcore.ParameterService()
    f = tml.IsolationForest(n_trees=20, device="cpu")
    proc = f.make_processor(ps, "iforest")
    for i, msg in enumerate(msgs):
        r = proc(None, data=msg)
        s = f.outlier_scores(f.fit(msg), msg).numpy()
        assert r["n_outliers"] == int((s > 0.6).sum())
        assert r["mean_score"] == pytest.approx(float(s.mean()), rel=1e-6)
        assert ps.version("iforest") == i + 1
    # inference from a forest the reference published
    ps_j = jcore.ParameterService()
    ref = jml.IsolationForest(n_trees=20)
    jproc = ref.make_processor(ps_j, "iforest")
    jproc(None, data=msgs[0])
    ps_t = tcore.ParameterService()
    _, tree = ps_j.fetch("iforest")
    ps_t.publish("iforest", tree)
    infer = f.make_processor(ps_t, "iforest", train=False)
    want = jml.IsolationForest(n_trees=20).make_processor(
        ps_j, "iforest", train=False)(None, data=msgs[1])
    got = infer(None, data=msgs[1])
    assert got["n_outliers"] == want["n_outliers"]
    assert got["mean_score"] == pytest.approx(want["mean_score"], abs=1e-6)
    assert ps_t.version("iforest") == 1


def test_needs_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tml.IsolationForest()
    assert tml.IsolationForest(device="cpu").device == torch.device("cpu")
