"""Per-model compute costs, ported from ``repro.cost.calibrate``.

``ModelCost`` and the committed ``calibration.json`` next to this module
(an exact copy of the reference package's file) are the pricing source
every consumer loads: :class:`~repro_torch.cost.model.CostModel`, the
placement engine and the DES service models.  Loading it is never a
measurement, so every consumer stays deterministic.

:class:`Calibrator` is the reference's, with one change of source:

1. **Counted flops.**  The reference compiles each workload's JAX kernels
   and costs the HLO.  The port counts the plain PyTorch version of each
   model's per-message work on the host instead, with the port's counter
   (:mod:`repro_torch.roofline.counter`): matrix products at 2·M·N·K, every
   other op that computes a floating output at one flop per output
   element (XLA's HLO cost does the same for elementwise ops; copies,
   type conversions, views and new buffers count none), and bytes as
   each op's inputs read plus its outputs written, with no fusion.  The
   counts therefore differ from the committed HLO figures, which stay the
   pricing source (ROADMAP A6); :func:`main` prints the two side by side.
2. **Measured wall-time samples**, as in the reference:
   :meth:`Calibrator.fit_service` fits the *efficiency* (achieved fraction
   of the tier device's peak) and the lognormal service-time noise
   ``sigma`` from per-message times of the port's real processors, which
   run on the card unless the calibrator is given ``device="cpu"``.

Deviation from the reference's CLI: ``python -m repro_torch.cost.calibrate``
writes only to an explicit ``--out`` and refuses the committed file's
path, because the counts it writes are torch counts, not the HLO figures
the committed file holds.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence

from repro_torch.cost.profiles import DEFAULT_PROFILE, ContinuumProfile

CALIBRATION_PATH = os.path.join(os.path.dirname(__file__),
                                "calibration.json")

# calibration reference shape: the paper's default message
CAL_N_POINTS = 2_500
CAL_N_FEATURES = 32

# analytic workload defaults shared with sim.scenarios (defined once,
# here in the cost subsystem): the hybrid edge pre-aggregation shrink
# factor, its per-point cost, and the Mini-App generation cost per point
DEFAULT_HYBRID_REDUCE = 10
DEFAULT_PREPROCESS_FLOPS_PER_POINT = 200.0
DEFAULT_GEN_S_PER_POINT = 2e-6


@dataclass(frozen=True)
class ModelCost:
    """Calibrated cost of one processing model.

    ``kernel_flops_per_point`` × ``invocations_per_message`` is the real
    work one message triggers; dividing by ``efficiency`` expresses it as
    peak-rate-equivalent flops so every consumer can price service time as
    ``effective_flops / (device.peak_flops × workers)``.
    """
    name: str
    kernel_flops_per_point: float      # HLO-measured, one invocation
    kernel_bytes_per_point: float      # HLO bytes (roofline memory term)
    invocations_per_message: float     # workload heaviness (e.g. AE epochs)
    efficiency: float                  # achieved fraction of device peak
    sigma: float                       # lognormal service-noise (log-space)
    output_bytes: int                  # serialized model output / message
    hybrid_reduce: int = DEFAULT_HYBRID_REDUCE
    preprocess_flops_per_point: float = DEFAULT_PREPROCESS_FLOPS_PER_POINT
    source: str = "roofline"           # roofline | measured | analytic
    precision: str = "fp32"            # fp32 | bf16 | int8 (kernel variant)

    @property
    def flops_per_point(self) -> float:
        """Real flops one message executes, per point."""
        return self.kernel_flops_per_point * self.invocations_per_message

    @property
    def effective_flops_per_point(self) -> float:
        """Peak-rate-equivalent flops per point (folds in efficiency)."""
        return self.flops_per_point / max(self.efficiency, 1e-9)


def load_calibration(path: Optional[str] = None) -> Dict[str, ModelCost]:
    """Load a calibration file (the committed one by default)."""
    with open(path or CALIBRATION_PATH) as f:
        doc = json.load(f)
    fields = {f.name for f in dataclasses.fields(ModelCost)}
    return {name: ModelCost(**{k: v for k, v in entry.items()
                               if k in fields})
            for name, entry in doc["models"].items()}


def save_calibration(costs: Mapping[str, ModelCost], path: str,
                     meta: Optional[dict] = None) -> None:
    doc = {"meta": dict(meta or {}),
           "models": {name: dataclasses.asdict(mc)
                      for name, mc in sorted(costs.items())}}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")


# ---------------------------------------------------------------------------
# counted flops and bytes of the plain torch versions
# ---------------------------------------------------------------------------


def _count(fn, *args):
    """(flops, bytes) of ``fn(*args)`` as run, by the port's one counter
    (:class:`repro_torch.roofline.counter.Counter`): products at
    2·M·N·K, one flop per floating output element of every other
    computing op, bytes as inputs read plus outputs written."""
    from repro_torch.roofline.counter import count
    _, c = count(fn, *args)
    return c.flops, c.bytes


def _message(n_points: int, n_features: int, seed: int = 0):
    """One Mini-App message as the processors see it (fp32, on the
    host)."""
    import torch

    from repro_torch.ml.datagen import MiniAppGenerator
    gen = MiniAppGenerator(n_points=n_points, n_features=n_features,
                           seed=seed)
    return torch.as_tensor(gen.sample(), dtype=torch.float32)


def _measure_kmeans(n_points: int, n_features: int, n_clusters: int = 25,
                    precision: str = "fp32"):
    """Per-message work: ONE fused assign+update pass, what
    ``KMeans.make_processor`` runs per message, through the plain
    ``impl="fused"`` version (the kernel's arithmetic)."""
    import torch

    from repro_torch.ml.kmeans import _assign_update
    pts = _message(n_points, n_features)
    cent = pts[:n_clusters].clone()
    cnts = torch.zeros(n_clusters)
    f, b = _count(lambda: _assign_update(cent, cnts, pts, impl="fused",
                                         precision=precision))
    return f / n_points, b / n_points


def _make_kmeans_variant_measurer(precision: str):
    def measure(n_points: int, n_features: int, n_clusters: int = 25):
        return _measure_kmeans(n_points, n_features, n_clusters,
                               precision=precision)
    return measure


def _measure_autoencoder(n_points: int, n_features: int):
    """Per-invocation work: one AdamW train step over the PyOD topology
    (the workload's ``invocations_per_message`` counts the epochs)."""
    from repro_torch.ml.autoencoder import AutoEncoder
    ae = AutoEncoder(n_features=n_features, device="cpu")
    st = ae.init()
    x = _message(n_points, n_features)
    f, b = _count(lambda: ae._step(st["params"], st["opt"], st["step"], x))
    return f / n_points, b / n_points


def _measure_isoforest(n_points: int, n_features: int):
    """Per-message work: refit the 100-tree forest + score the message
    (``IsolationForest.make_processor`` refits on every message)."""
    import torch

    from repro_torch.ml.isoforest import IsolationForest, _fit, _score
    isf = IsolationForest(device="cpu")
    pts = _message(n_points, n_features)
    psi = min(isf.psi, n_points)
    gen = torch.Generator().manual_seed(0)
    ff, bf = _count(lambda: _fit(gen, pts, isf.n_trees, psi,
                                 isf.max_depth))
    forest = _fit(torch.Generator().manual_seed(0), pts, isf.n_trees, psi,
                  isf.max_depth)
    fs, bs = _count(lambda: _score(forest, pts, torch.tensor(float(psi)),
                                   isf.max_depth))
    return (ff + fs) / n_points, (bf + bs) / n_points


_MEASURERS = {
    "kmeans": _measure_kmeans,
    "kmeans_bf16": _make_kmeans_variant_measurer("bf16"),
    "kmeans_int8": _make_kmeans_variant_measurer("int8"),
    "autoencoder": _measure_autoencoder,
    "isoforest": _measure_isoforest,
}

# Paper-testbed service fit (used when no wall-time samples are supplied),
# the reference's: invocations (PyOD's Keras AE trains its default 100
# epochs per batch; k-means/iforest run once per message), efficiency
# (fitted from the paper's Fig-2/3 wall times — small dense kernels
# achieve a small fraction of peak), and lognormal service noise fitted
# from measured per-message samples (lighter kernels jitter relatively
# more).
_PAPER_SERVICE_FIT = {
    "kmeans": dict(invocations_per_message=1.0, efficiency=0.65,
                   sigma=0.25, output_bytes=25 * CAL_N_FEATURES * 8),
    # precision variants of the same fused kernel: identical invocation
    # structure and noise; the narrower datapaths sustain a slightly
    # higher fraction of (their much higher) precision-scaled peak
    "kmeans_bf16": dict(invocations_per_message=1.0, efficiency=0.65,
                        sigma=0.25, output_bytes=25 * CAL_N_FEATURES * 8,
                        precision="bf16"),
    "kmeans_int8": dict(invocations_per_message=1.0, efficiency=0.70,
                        sigma=0.25, output_bytes=25 * CAL_N_FEATURES * 8,
                        precision="int8"),
    "autoencoder": dict(invocations_per_message=100.0, efficiency=0.15,
                        sigma=0.10, output_bytes=2_048),
    "isoforest": dict(invocations_per_message=1.0, efficiency=0.45,
                      sigma=0.20, output_bytes=2_048),
}


class Calibrator:
    """Fits :class:`ModelCost` entries from the two calibration sources.
    ``device`` is where :meth:`sample_service` runs the processors: the
    card unless ``"cpu"`` is given."""

    def __init__(self, profile: Optional[ContinuumProfile] = None,
                 n_points: int = CAL_N_POINTS,
                 n_features: int = CAL_N_FEATURES, device=None):
        self.profile = profile or DEFAULT_PROFILE
        self.n_points = n_points
        self.n_features = n_features
        self.device = device

    # -- source 1: counted flops of the plain versions ---------------------

    def measure_kernel(self, model: str):
        """(flops_per_point, bytes_per_point) of one invocation of
        ``model``, counted over its plain torch version on the host."""
        try:
            measure = _MEASURERS[model]
        except KeyError:
            raise KeyError(f"no kernel measurer for {model!r}; "
                           f"known: {sorted(_MEASURERS)}") from None
        return measure(self.n_points, self.n_features)

    # -- source 2: measured wall-time samples ------------------------------

    def fit_service(self, samples_s: Sequence[float], *,
                    flops_per_message: float, tier: str = "cloud",
                    n_workers: int = 1):
        """Fit (efficiency, sigma) from measured per-message service times.

        efficiency = flops / (peak × arithmetic-mean(t)), with the mean
        taken as the lognormal ``exp(μ + σ²/2)``; sigma is the std of log
        service time.  Together they define the *mean-one* lognormal
        service-time model ``t ~ eff_service × LogNormal(-σ²/2, σ)`` that
        :meth:`repro_torch.cost.model.CostModel.service_model` applies —
        fitting against the arithmetic mean makes the round trip exact.
        """
        ts = [float(t) for t in samples_s if t > 0]
        if not ts:
            raise ValueError("need at least one positive sample")
        logs = [math.log(t) for t in ts]
        mu = sum(logs) / len(logs)
        var = (sum((x - mu) ** 2 for x in logs) / (len(logs) - 1)
               if len(logs) > 1 else 0.0)
        peak = self.profile.tier(tier).device.peak_flops * n_workers
        efficiency = flops_per_message / (peak * math.exp(mu + var / 2.0))
        return min(efficiency, 1.0), math.sqrt(var)

    def sample_service(self, model: str, n_messages: int = 5):
        """Wall-time per-message samples of the real processor on
        ``self.device`` (one warm-up message first; on the card each
        sample ends in a synchronize) — input for :meth:`fit_service`."""
        import time

        import torch

        from repro_torch import ml
        dev = self.device
        maker = {
            "kmeans": lambda: ml.KMeans(device=dev),
            "kmeans_bf16": lambda: ml.KMeans(precision="bf16", device=dev),
            "kmeans_int8": lambda: ml.KMeans(precision="int8", device=dev),
            "autoencoder": lambda: ml.AutoEncoder(device=dev),
            "isoforest": lambda: ml.IsolationForest(device=dev),
        }[model]()
        process = maker.make_processor()
        gen = ml.MiniAppGenerator(n_points=self.n_points,
                                  n_features=self.n_features)
        ctx = type("Ctx", (), {"attempt": 0})()
        on_card = maker.device.type == "cuda"
        process(ctx, data=gen.sample())          # warm-up
        samples = []
        for _ in range(n_messages):
            data = gen.sample()
            t0 = time.perf_counter()
            process(ctx, data=data)
            if on_card:
                torch.cuda.synchronize(maker.device)
            samples.append(time.perf_counter() - t0)
        return samples

    def measure_service(self, model: str, *, n_messages: int = 5,
                        tier: str = "cloud",
                        kernel_flops_per_point: Optional[float] = None):
        """Run the real processor ``n_messages`` times and fit
        (efficiency, sigma) on this host — a *local* calibration, not the
        committed paper-testbed one.  Pass ``kernel_flops_per_point`` to
        skip the count when it was already made."""
        if kernel_flops_per_point is None:
            kernel_flops_per_point, _ = self.measure_kernel(model)
        fit = _PAPER_SERVICE_FIT[model]
        flops = (kernel_flops_per_point * fit["invocations_per_message"]
                 * self.n_points)
        return self.fit_service(self.sample_service(model, n_messages),
                                flops_per_message=flops, tier=tier)

    # -- assembly ----------------------------------------------------------

    def calibrate(self, *, measure_service: bool = False,
                  models: Optional[Sequence[str]] = None
                  ) -> Dict[str, ModelCost]:
        """Full calibration: counted flops always; efficiency/sigma from
        live wall-time samples when ``measure_service``, otherwise the
        committed paper-testbed service fit."""
        out: Dict[str, ModelCost] = {}
        for name in models or sorted(_MEASURERS):
            kf, kb = self.measure_kernel(name)
            fit = dict(_PAPER_SERVICE_FIT[name])
            if name.startswith("kmeans"):
                # the published output is the k x d centroid table — it
                # scales with the calibration's feature count
                fit["output_bytes"] = 25 * self.n_features * 8
            source = "roofline"
            if measure_service:
                eff, sigma = self.measure_service(
                    name, kernel_flops_per_point=kf)
                fit.update(efficiency=eff, sigma=sigma)
                source = "measured"
            out[name] = ModelCost(
                name=name, kernel_flops_per_point=round(kf, 3),
                kernel_bytes_per_point=round(kb, 3),
                invocations_per_message=fit["invocations_per_message"],
                efficiency=fit["efficiency"], sigma=fit["sigma"],
                output_bytes=fit["output_bytes"], source=source,
                precision=fit.get("precision", "fp32"))
        return out


def main(argv=None) -> int:
    """``python -m repro_torch.cost.calibrate --out FILE``: writes a
    calibration with torch-counted flops to FILE (never to the committed
    file) and prints each model's count beside the committed HLO figure
    and their ratio."""
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True,
                    help="where to write the calibration JSON (not the "
                         "committed calibration.json)")
    ap.add_argument("--points", type=int, default=CAL_N_POINTS)
    ap.add_argument("--features", type=int, default=CAL_N_FEATURES)
    ap.add_argument("--measure-service", action="store_true",
                    help="fit efficiency/noise from live wall-time samples "
                         "(default: keep the committed paper-testbed "
                         "service fit)")
    ap.add_argument("--device", default=None,
                    help="where --measure-service runs the processors "
                         "(default: the card)")
    args = ap.parse_args(argv)
    if os.path.realpath(args.out) == os.path.realpath(CALIBRATION_PATH):
        ap.error("--out names the committed calibration.json, which "
                 "stays the pricing source; write elsewhere")
    cal = Calibrator(n_points=args.points, n_features=args.features,
                     device=args.device)
    costs = cal.calibrate(measure_service=args.measure_service)
    save_calibration(costs, args.out, meta={
        "n_points": args.points, "n_features": args.features,
        "torch_version": torch.__version__,
        "generated_by": "python -m repro_torch.cost.calibrate",
        "kernel_flops": "torch count of the plain versions",
        "service_fit": ("measured on this host"
                        if args.measure_service else "paper testbed"),
    })
    committed = load_calibration()
    for name, mc in sorted(costs.items()):
        hlo = committed[name].kernel_flops_per_point
        print(f"{name:>12}: {mc.kernel_flops_per_point:>12.1f} torch "
              f"flops/pt vs {hlo:>10.1f} HLO (ratio "
              f"{mc.kernel_flops_per_point / hlo:.3f}); "
              f"{mc.kernel_bytes_per_point:.1f} B/pt; eff "
              f"{mc.efficiency:g}, sigma {mc.sigma:g}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
