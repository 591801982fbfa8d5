"""The port's streaming k-means (``repro_torch.ml.kmeans``) against the
reference's (``repro.ml.kmeans``) on the same numpy messages, on the CPU:
initialisation, streaming updates at every impl × precision, the
precision-agreement probe, the float64 cast, the CUDA default, and a
reference state carried across."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ParameterService as JParameterService
from repro.ml import KMeans as JKMeans
from repro.ml import MiniAppGenerator as JMiniAppGenerator
from repro_torch.core import ParameterService, PilotError, PilotManager
from repro_torch.ml import KMeans, MiniAppGenerator
from repro_torch.ml.kmeans import assignment_agreement, load_reference_state

PRECISIONS = ("fp32", "bf16", "int8")
CENT_TOL = dict(rtol=1e-5, atol=1e-4)


def test_datagen_samples_bit_identical_to_reference():
    a = MiniAppGenerator(n_points=1000, seed=5)
    b = JMiniAppGenerator(n_points=1000, seed=5)
    for _ in range(3):
        np.testing.assert_array_equal(a.sample(), b.sample())
    np.testing.assert_array_equal(a.centers, b.centers)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_init_from_sample_is_bit_identical(seed):
    pts = MiniAppGenerator(n_points=500, seed=seed).sample()
    t = KMeans(seed=seed, device="cpu").init(pts)
    j = JKMeans(seed=seed).init(pts)
    assert t["centroids"].dtype == torch.float32
    np.testing.assert_array_equal(t["centroids"].numpy(),
                                  np.asarray(j["centroids"]))
    np.testing.assert_array_equal(t["counts"].numpy(),
                                  np.asarray(j["counts"]))


def test_init_without_sample_shape_and_scale():
    """The reference draws from jax.random, which torch cannot reproduce:
    only the shape, the seed's determinism and the scale (σ = 5) hold."""
    km = KMeans(n_clusters=64, n_features=32, seed=4, device="cpu")
    a, b = km.init()["centroids"], km.init()["centroids"]
    assert a.shape == (64, 32) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert 4.5 < float(a.std()) < 5.5 and abs(float(a.mean())) < 0.5


@pytest.mark.parametrize("impl", ["kernel", "fused", "twopass"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_streaming_updates_match_reference(impl, precision):
    """Ten streaming updates from the same generator: counts exact,
    centroids to accumulation-order tolerance."""
    gt = MiniAppGenerator(n_points=2500, seed=1)
    gj = JMiniAppGenerator(n_points=2500, seed=1)
    kt = KMeans(impl=impl, precision=precision, device="cpu")
    kj = JKMeans(impl="fused", precision=precision)
    first = gt.sample()
    gj.sample()
    st, sj = kt.init(first), kj.init(first)
    for _ in range(10):
        msg = gt.sample()
        np.testing.assert_array_equal(msg, gj.sample())
        st = kt.update(st, msg)
        sj = kj.update(sj, msg)
    np.testing.assert_array_equal(st["counts"].numpy(),
                                  np.asarray(sj["counts"]))
    np.testing.assert_allclose(st["centroids"].numpy(),
                               np.asarray(sj["centroids"]), **CENT_TOL)


def test_assignment_agreement_on_probe():
    assert assignment_agreement("bf16") >= 0.99
    assert assignment_agreement("int8") >= 0.99
    assert assignment_agreement("fp32") == 1.0


def test_float64_message_is_cast_to_float32():
    gen = MiniAppGenerator(n_points=400, seed=2)
    msg = gen.sample()
    assert msg.dtype == np.float64
    km = KMeans(device="cpu")
    st = km.init(msg)
    ids64, d64 = km.assign(st, msg)
    ids32, d32 = km.assign(st, msg.astype(np.float32))
    assert d64.dtype == torch.float32
    assert torch.equal(ids64, ids32) and torch.equal(d64, d32)
    new, _, scores = km.assign_update(st, msg)
    assert new["centroids"].dtype == torch.float32
    assert scores.dtype == torch.float32


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KMeans()
    with pytest.raises(PilotError, match="devices=()"):
        PilotManager()
    assert KMeans(device="cpu").device == torch.device("cpu")


def test_rejects_unknown_impl_and_precision():
    with pytest.raises(ValueError, match="impl"):
        KMeans(impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        KMeans(precision="fp8", device="cpu")


def test_reference_state_gives_the_same_scores():
    """A state the reference's processor trained and published, loaded
    into the port, scores a new message as the reference does."""
    gen = JMiniAppGenerator(n_points=2500, seed=9)
    kj = JKMeans()
    ps = JParameterService()
    proc = kj.make_processor(ps, "kmeans")
    for _ in range(4):
        proc(None, data=gen.sample())
    version, tree = ps.fetch("kmeans")
    assert version == 4
    state = load_reference_state(tree, "cpu")
    assert state["centroids"].dtype == torch.float32
    msg = gen.sample()
    kt = KMeans(device="cpu")
    np.testing.assert_allclose(
        kt.outlier_scores(state, msg).numpy(),
        np.asarray(kj.outlier_scores(jax.tree.map(jnp.asarray, tree), msg)),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(state["counts"].numpy(), tree["counts"])


def test_parameter_service_publishes_numpy_snapshots():
    ps = ParameterService()
    state = {"centroids": torch.ones((3, 2)), "counts": torch.zeros(3)}
    assert ps.publish("kmeans", state) == 1
    state["centroids"].add_(1.0)             # later in-place mutation
    v, tree = ps.fetch("kmeans")
    assert v == 1 and isinstance(tree["centroids"], np.ndarray)
    np.testing.assert_array_equal(tree["centroids"], np.ones((3, 2)))
    _, placed = ps.place("kmeans", "cpu")
    assert isinstance(placed["counts"], torch.Tensor)
