"""The port's calibration-drift tool (``repro_torch.tools.calibration_drift``)
against the reference's ``tools/calibration_drift.py`` on the CPU: the same
report layout (``torch_version`` and ``device`` in place of
``jax_version``), the k-means count within ``tests/test_torch_calibrate.py``'s
band, and the CLI's gate on the count over its pinned counting ratio."""
import importlib.util
import json
import os

import pytest

import repro.cost.calibrate as jcal
import repro_torch.cost.calibrate as tcal
from repro_torch.tools import calibration_drift as tdrift

ROOT = os.path.join(os.path.dirname(__file__), "..")
COMMITTED = tcal.load_calibration()
# tests/test_torch_calibrate.py's band for the k-means count
KMEANS_BAND = (0.75, 1.33)


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "calibration_drift", os.path.join(ROOT, "tools",
                                          "calibration_drift.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_report_has_the_reference_layout(monkeypatch):
    """The reference's report on the committed figures (its HLO count and
    its processors are replaced: compiling them takes seconds a model and
    only the layout is compared) against the port's, run for real."""
    monkeypatch.setattr(
        jcal.Calibrator, "measure_kernel",
        lambda self, name: (COMMITTED[name].kernel_flops_per_point,
                            COMMITTED[name].kernel_bytes_per_point))
    monkeypatch.setattr(
        jcal.Calibrator, "measure_service",
        lambda self, name, **kw: (COMMITTED[name].efficiency,
                                  COMMITTED[name].sigma))
    want = _reference_tool().drift_report(models=["kmeans"], n_messages=2)
    got = tdrift.drift_report(models=["kmeans"], n_messages=2,
                              device="cpu")
    assert set(got) == set(want) == {"meta", "models"}
    assert set(got["meta"]) == \
        (set(want["meta"]) - {"jax_version"}) | {"torch_version", "device"}
    assert got["meta"]["device"] == "cpu"
    assert got["meta"]["n_messages"] == 2 and got["meta"]["tier"] == "cloud"
    assert [set(r) for r in got["models"]] == \
        [set(r) for r in want["models"]]
    (row,) = got["models"]
    assert row["model"] == "kmeans"
    assert row["committed_kernel_flops_per_point"] == \
        COMMITTED["kmeans"].kernel_flops_per_point
    assert row["committed_efficiency"] == COMMITTED["kmeans"].efficiency
    assert row["committed_sigma"] == COMMITTED["kmeans"].sigma


def test_kmeans_ratio_within_the_calibrator_band():
    (row,) = tdrift.drift_report(models=["kmeans"], n_messages=2,
                                 device="cpu")["models"]
    lo, hi = KMEANS_BAND
    assert lo <= row["kernel_flops_ratio"] <= hi
    assert row["kernel_flops_ratio"] == pytest.approx(
        tdrift.COUNTING_RATIO["kmeans"], abs=5e-4)
    assert row["achieved_fraction_of_peak"] > 0.0 and row["sigma"] >= 0.0
    assert row["efficiency_ratio"] == pytest.approx(
        row["achieved_fraction_of_peak"] / row["committed_efficiency"])


def test_pinned_ratios_are_the_calibrator_tests_counts():
    """Every calibrated model has a pinned ratio, inside the band that
    tests/test_torch_calibrate.py holds its count to."""
    from test_torch_calibrate import RATIO_BANDS
    assert sorted(tdrift.COUNTING_RATIO) == sorted(COMMITTED)
    for name, ratio in tdrift.COUNTING_RATIO.items():
        lo, hi = RATIO_BANDS[name]
        assert lo <= ratio <= hi, name


def test_main_gates_the_drift_over_the_pinned_ratio(tmp_path, capsys):
    out = tmp_path / "drift.json"
    argv = ["--models", "kmeans", "autoencoder", "isoforest",
            "--messages", "2", "--max-kernel-drift", "2.0",
            "--device", "cpu"]
    assert tdrift.main(argv + ["--out", str(out)]) == 0
    report = json.load(open(out))
    assert [r["model"] for r in report["models"]] == \
        ["kmeans", "autoencoder", "isoforest"]
    # the forest's raw ratio, 0.213, would fail the reference's raw gate
    forest = report["models"][2]
    assert not 0.5 <= forest["kernel_flops_ratio"] <= 2.0
    printed = capsys.readouterr().out
    assert "device cpu" in printed and "KERNEL DRIFT" not in printed


def test_main_fails_a_model_past_the_gate(monkeypatch, capsys):
    """A count that moved by more than the factor fails the CLI."""
    monkeypatch.setitem(tdrift.COUNTING_RATIO, "kmeans", 0.3)
    assert tdrift.main(["--models", "kmeans", "--messages", "2",
                        "--max-kernel-drift", "2.0", "--device",
                        "cpu"]) == 1
    assert "KERNEL DRIFT: kmeans" in capsys.readouterr().out
