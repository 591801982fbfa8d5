"""``repro_torch.ml.autoencoder`` against ``repro.ml.autoencoder`` on the
CPU, on the same seeded numpy inputs and on weights the reference
initialised (``jax.random`` streams cannot be matched, so parity starts
from carried-across weights).

Tolerances:
* forward and reconstruction error: 1e-5 relative (the same fp32
  products; the backends sum the 32–64-wide dot products in other
  orders);
* ``update``: losses within 1e-5 relative and params within 5e-5
  absolute after ten steps.  Adam scales every element's step to about
  ``lr`` (1e-3) whatever the gradient's size, so a gradient that differs
  by a rounding moves the param where |g| is near sqrt(ν); that drift
  grows with the steps (1.7e-5 after ten on the 2,000-point batch).  A
  sign flip of an element's first step would show as a 2e-3 difference:
  none occurs here, and the bound would catch one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.ml as jml
import repro.ml.autoencoder as JA
import repro_torch.core as tcore
import repro_torch.ml as tml
import repro_torch.ml.autoencoder as TA

FWD_RTOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-5


def _ref_state_as_torch(state):
    return TA.load_reference_state(jax.tree.map(np.asarray, state), "cpu")


def _params_np(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _assert_params_close(got, want, atol):
    for g, w in zip(_params_np(got), _params_np(want)):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol)


def _batch(n=2_000, seed=2):
    return jml.MiniAppGenerator(n_points=n, outlier_frac=0.02,
                                seed=seed).sample_with_labels()


def test_ae_param_count_is_papers_11552():
    ae = tml.AutoEncoder(device="cpu")
    st = ae.init()
    assert TA.ae_param_count(st["params"]) == 11_552
    assert [tuple(p["w"].shape) for p in st["params"]] == [
        tuple(p["w"].shape) for p in jml.AutoEncoder().init()["params"]]
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()


def test_init_is_seeded_he_normal():
    a = tml.AutoEncoder(seed=5, device="cpu").init()["params"]
    b = tml.AutoEncoder(seed=5, device="cpu").init()["params"]
    c = tml.AutoEncoder(seed=6, device="cpu").init()["params"]
    assert all(torch.equal(x["w"], y["w"]) for x, y in zip(a, b))
    assert not torch.equal(a[0]["w"], c[0]["w"])
    for p in a:
        din = p["w"].shape[0]
        assert float(p["w"].std()) == pytest.approx(np.sqrt(2.0 / din),
                                                    rel=0.25)
        assert not p["b"].any()


@pytest.mark.parametrize("n", [1, 257, 2_000])
def test_forward_and_recon_error_match_reference(n):
    pts, _ = _batch(max(n, 2), seed=11)
    pts = pts[:n]
    ref = jml.AutoEncoder()
    st_j = ref.init()
    st_t = _ref_state_as_torch(st_j)
    x = np.asarray(np.random.default_rng(n).standard_normal((n, 32)),
                   np.float32)
    np.testing.assert_allclose(
        TA.ae_forward(st_t["params"], torch.from_numpy(x)).numpy(),
        np.asarray(JA.ae_forward(st_j["params"], x)),
        rtol=FWD_RTOL, atol=FWD_RTOL)
    np.testing.assert_allclose(
        TA.ae_loss(st_t["params"], torch.from_numpy(x)).item(),
        float(JA.ae_loss(st_j["params"], x)), rtol=FWD_RTOL)
    if n > 1:     # one point normalizes to 0/1e-6: nothing to compare
        np.testing.assert_allclose(
            tml.AutoEncoder(device="cpu").outlier_scores(st_t, pts).numpy(),
            np.asarray(ref.outlier_scores(st_j, pts)),
            rtol=FWD_RTOL, atol=FWD_RTOL)


def test_norm_uses_population_std():
    pts = np.random.default_rng(0).standard_normal((7, 32)) * 3 + 1
    got = tml.AutoEncoder(device="cpu")._norm(pts).numpy()
    want = np.asarray(jml.AutoEncoder._norm(pts))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    x = pts.astype(np.float32)
    np.testing.assert_allclose(
        got, (x - x.mean(0)) / (x.std(0, ddof=0) + 1e-6), rtol=1e-5)


@pytest.mark.parametrize("epochs", [1, 2])
def test_ten_updates_match_reference(epochs):
    pts, _ = _batch()
    ref = jml.AutoEncoder(epochs_per_batch=epochs)
    port = tml.AutoEncoder(epochs_per_batch=epochs, device="cpu")
    st_j = ref.init()
    st_t = _ref_state_as_torch(st_j)
    for _ in range(10):
        st_j, loss_j = ref.update(st_j, pts)
        st_t, loss_t = port.update(st_t, pts)
        # the loss after the step, as the reference reports it
        assert loss_t == pytest.approx(loss_j, rel=LOSS_RTOL)
        assert loss_t == pytest.approx(
            TA.ae_loss(st_t["params"], port._norm(pts)).item(), rel=1e-6)
    assert int(st_t["step"]) == int(st_j["step"]) == 10 * epochs
    _assert_params_close(st_t["params"], st_j["params"], PARAM_ATOL)
    for name in ("mu", "nu"):
        for g, w in zip(st_t["opt"][name], st_j["opt"][name]):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    g[k].numpy(), np.asarray(w[k]), rtol=1e-3,
                    atol=1e-3 * float(np.abs(np.asarray(w[k])).max()))


def test_processor_matches_reference_message_by_message():
    """Both processors fetch the same reference-initialised state from
    their parameter service, then score, train and publish on the same
    messages in order."""
    gen = jml.MiniAppGenerator(n_points=1_000, seed=21)
    msgs = [gen.sample() for _ in range(6)]
    init = jml.AutoEncoder().init()
    ps_j, ps_t = jcore.ParameterService(), tcore.ParameterService()
    ps_j.publish("ae", init)
    ps_t.publish("ae", jax.tree.map(np.asarray, init))
    proc_j = jml.AutoEncoder().make_processor(ps_j, "ae")
    proc_t = tml.AutoEncoder(device="cpu").make_processor(ps_t, "ae")
    for msg in msgs:
        rj, rt = proc_j(None, data=msg), proc_t(None, data=msg)
        assert rt["n_outliers"] == rj["n_outliers"]
        assert rt["mean_score"] == pytest.approx(rj["mean_score"],
                                                 rel=FWD_RTOL)
        assert ps_t.version("ae") == ps_j.version("ae")
    assert ps_t.version("ae") == len(msgs) + 1
    _, tree_j = ps_j.fetch("ae")
    _, tree_t = ps_t.fetch("ae")
    assert int(tree_t["step"]) == int(tree_j["step"]) == len(msgs)
    _assert_params_close(tree_t["params"], tree_j["params"], PARAM_ATOL)
    # inference: the published state, no further versions
    infer_t = tml.AutoEncoder(device="cpu").make_processor(ps_t, "ae",
                                                           train=False)
    infer_j = jml.AutoEncoder().make_processor(ps_j, "ae", train=False)
    rj, rt = infer_j(None, data=msgs[0]), infer_t(None, data=msgs[0])
    assert rt["n_outliers"] == rj["n_outliers"]
    assert rt["mean_score"] == pytest.approx(rj["mean_score"], rel=FWD_RTOL)
    assert ps_t.version("ae") == len(msgs) + 1


def test_carries_on_from_a_state_the_reference_published():
    """A state ``repro`` trained and published loads in the port, which
    carries on training it; and the port's published state loads back in
    the reference."""
    pts, _ = _batch(1_500, seed=9)
    ref = jml.AutoEncoder()
    ps_j = jcore.ParameterService()
    st = ref.init()
    for _ in range(3):
        st, _ = ref.update(st, pts)
    ps_j.publish("ae", st)
    _, tree = ps_j.fetch("ae")
    port = tml.AutoEncoder(device="cpu")
    st_t = TA.load_reference_state(tree, "cpu")
    assert int(st_t["step"]) == 3
    st_j = jax.tree.map(jnp.asarray, tree)
    st_t, loss_t = port.update(st_t, pts)
    st_j, loss_j = ref.update(st_j, pts)
    assert loss_t == pytest.approx(loss_j, rel=LOSS_RTOL)
    _assert_params_close(st_t["params"], st_j["params"], PARAM_ATOL)
    ps_t = tcore.ParameterService()
    ps_t.publish("ae", st_t)
    _, back = ps_t.fetch("ae")
    st_back = jax.tree.map(jnp.asarray, back)
    _, loss_back = ref.update(st_back, pts)
    _, loss_ref = ref.update(st_j, pts)
    assert loss_back == pytest.approx(loss_ref, rel=LOSS_RTOL)


@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_concurrent_workers_lose_updates_as_the_reference(n_workers):
    """Cloud workers share one processor's state without a lock, in both
    packages.  Held in lock step (every worker has read the state before
    any writes it back), ``n_workers`` workers publish a version a
    message but keep one step a round: step = messages / n_workers, the
    same in both packages."""
    import threading
    rounds = 3
    pts = [_batch(n=200, seed=40 + i)[0]
           for i in range(rounds * n_workers)]
    steps = {}
    for name, core, ae in (("ref", jcore, jml.AutoEncoder()),
                           ("port", tcore, tml.AutoEncoder(device="cpu"))):
        ps = core.ParameterService()
        ps.publish("ae", ae.init())
        barrier = threading.Barrier(n_workers, timeout=60)
        update = ae.update

        def lock_step(state, points, update=update, barrier=barrier):
            barrier.wait()
            return update(state, points)

        ae.update = lock_step
        proc = ae.make_processor(ps, "ae")
        out = []

        def worker(w, proc=proc, out=out):
            for r in range(rounds):
                out.append(proc(None, data=pts[r * n_workers + w]))

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        version, tree = ps.fetch("ae")
        assert len(out) == rounds * n_workers
        assert version == 1 + rounds * n_workers
        steps[name] = int(tree["step"])
    assert steps["port"] == steps["ref"] == rounds


def test_ae_learns_and_detects():
    """tests/test_ml.py's quality test on the port, from its own init."""
    pts, is_out = _batch()
    ae = tml.AutoEncoder(device="cpu")
    st = ae.init()
    losses = []
    for _ in range(40):
        st, loss = ae.update(st, pts)
        losses.append(loss)
    assert losses[-1] < losses[0] * 0.9
    s = ae.outlier_scores(st, pts).numpy()
    pred = s > s.mean() + 2 * s.std()
    tp = (pred & is_out).sum()
    assert tp / max(pred.sum(), 1) > 0.8          # precision
    assert tp / max(is_out.sum(), 1) > 0.5        # recall


def test_needs_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tml.AutoEncoder()
    assert tml.AutoEncoder(device="cpu").device == torch.device("cpu")
