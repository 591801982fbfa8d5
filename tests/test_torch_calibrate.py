"""The calibrator (``repro_torch.cost.calibrate``) against the reference's
(``repro.cost.calibrate``) on the CPU.

The service fit is the reference's arithmetic on the same inputs, so it
must be exact.  The kernel flops are a torch count of the plain versions,
not the reference's HLO cost, so they are held within stated bands of
the committed HLO figures, which stay the pricing source."""
import json
import math
import os

import numpy as np
import pytest

import repro.cost.calibrate as jcal
import repro_torch.cost.calibrate as tcal
from repro_torch.cost.model import CostModel

COMMITTED = tcal.load_calibration()
# torch count / committed HLO flops per point, measured here at 2,500 × 32:
# k-means 0.937 (fp32, bf16) and 0.899 (int8), the AE step 1.001, the
# forest 0.213 (its fit and walk are gathers and compares, which the
# torch count counts as moves or non-floating ops)
RATIO_BANDS = {"kmeans": (0.75, 1.33), "kmeans_bf16": (0.75, 1.33),
               "kmeans_int8": (0.75, 1.33), "autoencoder": (0.9, 1.1),
               "isoforest": (0.15, 0.3)}
SERVICE_FIELDS = ("invocations_per_message", "efficiency", "sigma",
                  "output_bytes", "hybrid_reduce",
                  "preprocess_flops_per_point", "source", "precision")


def _samples(seed, n, base, sigma):
    rng = np.random.default_rng(seed)
    return base * np.exp(rng.normal(-0.5 * sigma ** 2, sigma, size=n))


@pytest.mark.parametrize("seed,n,tier,workers", [
    (0, 500, "cloud", 1), (1, 2, "edge", 4), (2, 1, "cloud", 2),
    (3, 37, "device", 1)])
def test_fit_service_equals_reference(seed, n, tier, workers):
    flops = 1e9 * (seed + 1)
    samples = _samples(seed, n, 0.05 * (seed + 1), 0.3)
    got = tcal.Calibrator().fit_service(samples, flops_per_message=flops,
                                        tier=tier, n_workers=workers)
    want = jcal.Calibrator().fit_service(samples, flops_per_message=flops,
                                         tier=tier, n_workers=workers)
    assert got == want


def test_fit_service_round_trips_the_service_model():
    """Samples drawn by the port's ``CostModel.service_model`` (mean-one
    lognormal noise) refit to the efficiency and sigma they were drawn
    with, as in tests/test_cost.py::test_fit_service_recovers_known_
    lognormal, and the reference's fit of them is the same."""
    cal = tcal.Calibrator()
    true_eff, true_sigma, flops = 0.2, 0.3, 1e9
    peak = cal.profile.tier("cloud").device.peak_flops
    base = flops / (peak * true_eff)
    model = CostModel().service_model({"process_cloud": base},
                                      sigma=true_sigma, seed=7)
    samples = [model("process_cloud", None, None) for _ in range(2000)]
    eff, sigma = cal.fit_service(samples, flops_per_message=flops)
    assert eff == pytest.approx(true_eff, rel=0.05)
    assert sigma == pytest.approx(true_sigma, rel=0.1)
    assert (eff, sigma) == jcal.Calibrator().fit_service(
        samples, flops_per_message=flops)
    with pytest.raises(ValueError):
        cal.fit_service([0.0, -1.0], flops_per_message=flops)


def test_calibrate_service_fields_equal_reference(monkeypatch):
    """``calibrate(measure_service=False)``: every service field equals
    the reference's.  The reference's HLO measurement is replaced by the
    committed figures (compiling it takes seconds a model and does not
    touch these fields)."""
    monkeypatch.setattr(
        jcal.Calibrator, "measure_kernel",
        lambda self, name: (COMMITTED[name].kernel_flops_per_point,
                            COMMITTED[name].kernel_bytes_per_point))
    for n_features in (32, 7):
        got = tcal.Calibrator(n_points=500,
                              n_features=n_features).calibrate()
        want = jcal.Calibrator(n_points=500,
                               n_features=n_features).calibrate()
        assert sorted(got) == sorted(want) == sorted(COMMITTED)
        for name in got:
            for field in SERVICE_FIELDS:
                assert getattr(got[name], field) == \
                    getattr(want[name], field), (name, field)
            if n_features == 32:
                for field in SERVICE_FIELDS:
                    assert getattr(got[name], field) == \
                        getattr(COMMITTED[name], field), (name, field)
    assert tcal._PAPER_SERVICE_FIT == jcal._PAPER_SERVICE_FIT


@pytest.mark.parametrize("model", sorted(RATIO_BANDS))
def test_torch_count_against_committed_hlo(model):
    flops, nbytes = tcal.Calibrator().measure_kernel(model)
    ratio = flops / COMMITTED[model].kernel_flops_per_point
    lo, hi = RATIO_BANDS[model]
    assert lo <= ratio <= hi, ratio
    assert nbytes > 0 and math.isfinite(nbytes)


def test_count_rules():
    """Products 2·M·N·K, one flop per floating output element of other
    computing ops, none for views, copies and new buffers; bytes are the
    inputs read and outputs written."""
    import torch
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    flops, nbytes = tcal._count(lambda: (a @ b).relu())
    assert flops == 2 * 4 * 8 * 3 + 4 * 3
    assert nbytes == 4 * (4 * 8 + 8 * 3 + 4 * 3) + 4 * (4 * 3 + 4 * 3)
    flops, _ = tcal._count(lambda: a.T.contiguous().float().view(-1))
    assert flops == 0


def test_main_writes_only_an_explicit_out(tmp_path, capsys):
    committed = open(tcal.CALIBRATION_PATH, "rb").read()
    with pytest.raises(SystemExit):
        tcal.main([])                               # --out is required
    with pytest.raises(SystemExit):
        tcal.main(["--out", tcal.CALIBRATION_PATH])
    out = tmp_path / "cal.json"
    assert tcal.main(["--out", str(out), "--points", "500"]) == 0
    assert open(tcal.CALIBRATION_PATH, "rb").read() == committed
    costs = tcal.load_calibration(str(out))
    assert sorted(costs) == sorted(COMMITTED)
    assert json.load(open(out))["meta"]["n_points"] == 500
    printed = capsys.readouterr().out
    for name in COMMITTED:
        assert name in printed
    assert "HLO (ratio" in printed and os.fspath(out) in printed
