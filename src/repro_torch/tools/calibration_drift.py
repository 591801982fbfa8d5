"""Calibration-drift report for the port: count each model's kernel flops
and refit its service efficiency and sigma live on this machine, beside
the committed ``calibration.json`` — the counterpart of the reference's
``tools/calibration_drift.py``.

    python -m repro_torch.tools.calibration_drift --messages 5 --out DRIFT.json
    python -m repro_torch.tools.calibration_drift --device cpu --max-kernel-drift 2.0

The engine is the port's :class:`~repro_torch.cost.calibrate.Calibrator`:
``measure_kernel`` counts the plain versions' flops on the host and
``measure_service`` times the real processors, on the card unless
``--device cpu`` is given.  The report has the reference's row keys; its
``meta`` carries ``torch_version`` and ``device`` where the reference's
carries ``jax_version``.

**The gate differs from the reference's.**  The reference costs XLA's HLO,
the port counts torch ops (:mod:`repro_torch.roofline.counter`), so the
raw ratio ``kernel_flops_ratio`` (count ÷ committed HLO figure) is not 1
by construction: at 2,500 × 32 it is 0.937 for k-means (0.899 in int8),
1.001 for the auto-encoder and 0.213 for the forest, whose fit and walk
are gathers and compares that the torch count does not count as flops.
The reference's gate of a factor of 2 on the raw ratio would fail the
forest on every machine.  The report keeps the raw ratio, and
``--max-kernel-drift R`` holds the raw ratio divided by the model's pinned
counting ratio (:data:`COUNTING_RATIO`) within a factor of R.  The
service fit is host-dependent and never gated, as in the reference.

Exit code 0 unless ``--max-kernel-drift`` is given and a model drifts
beyond it.
"""
from __future__ import annotations

import argparse
import json
import sys

# torch count ÷ committed HLO flops per point at 2,500 × 32, as
# tests/test_torch_calibrate.py pins them
COUNTING_RATIO = {"kmeans": 0.937, "kmeans_bf16": 0.937,
                  "kmeans_int8": 0.899, "autoencoder": 1.001,
                  "isoforest": 0.213}


def drift_report(models=None, n_messages: int = 5, tier: str = "cloud",
                 device=None):
    """Count and refit each model live and pair the numbers with the
    committed calibration; the processors run on ``device`` (the card
    unless given).  Returns ``{"meta": ..., "models": [row, ...]}``."""
    import torch

    from repro_torch.cost.calibrate import Calibrator, load_calibration
    from repro_torch.ml.kmeans import resolve_device
    device = resolve_device(device)
    committed = load_calibration()
    cal = Calibrator(device=device)
    rows = []
    for name in models or sorted(committed):
        c = committed[name]
        kf, kb = cal.measure_kernel(name)
        eff, sigma = cal.measure_service(
            name, n_messages=n_messages, tier=tier,
            kernel_flops_per_point=kf)
        rows.append({
            "model": name,
            "kernel_flops_per_point": round(kf, 3),
            "committed_kernel_flops_per_point": c.kernel_flops_per_point,
            "kernel_flops_ratio": kf / c.kernel_flops_per_point,
            "kernel_bytes_per_point": round(kb, 3),
            "achieved_fraction_of_peak": eff,
            "committed_efficiency": c.efficiency,
            "efficiency_ratio": eff / c.efficiency,
            "sigma": sigma,
            "committed_sigma": c.sigma,
        })
    return {
        "meta": {"n_messages": n_messages, "tier": tier,
                 "torch_version": torch.__version__, "device": str(device),
                 "generated_by": "python -m repro_torch.tools."
                                 "calibration_drift"},
        "models": rows,
    }


def drift(row) -> float:
    """A row's raw flops ratio over its model's pinned counting ratio:
    1 where the count has not moved since it was pinned."""
    return row["kernel_flops_ratio"] / COUNTING_RATIO[row["model"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None,
                    help="write the drift report as JSON")
    ap.add_argument("--messages", type=int, default=5,
                    help="live service samples per model")
    ap.add_argument("--models", nargs="+", default=None,
                    help="restrict to these calibrated models")
    ap.add_argument("--tier", default="cloud",
                    help="tier whose peak rate the efficiency is "
                         "measured against")
    ap.add_argument("--max-kernel-drift", type=float, default=None,
                    help="fail (exit 1) if any model's flops ratio, over "
                         "its pinned counting ratio, lies beyond this "
                         "factor of 1")
    ap.add_argument("--device", default=None,
                    help="where the processors run (default: the card)")
    args = ap.parse_args(argv)

    report = drift_report(models=args.models, n_messages=args.messages,
                          tier=args.tier, device=args.device)
    hdr = (f"{'model':>12} {'flops/pt':>12} {'committed':>12} "
           f"{'ratio':>6} {'pinned':>6} {'drift':>6} {'eff':>8} "
           f"{'committed':>9} {'sigma':>7}")
    print(f"device {report['meta']['device']}, torch "
          f"{report['meta']['torch_version']}")
    print(hdr)
    print("-" * len(hdr))
    for r in report["models"]:
        print(f"{r['model']:>12} {r['kernel_flops_per_point']:>12.1f} "
              f"{r['committed_kernel_flops_per_point']:>12.1f} "
              f"{r['kernel_flops_ratio']:>6.3f} "
              f"{COUNTING_RATIO[r['model']]:>6.3f} {drift(r):>6.3f} "
              f"{r['achieved_fraction_of_peak']:>8.5f} "
              f"{r['committed_efficiency']:>9.3f} {r['sigma']:>7.3f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=float)
            f.write("\n")
        print(f"wrote {args.out}")

    if args.max_kernel_drift is not None:
        limit = args.max_kernel_drift
        bad = [r for r in report["models"]
               if not 1.0 / limit <= drift(r) <= limit]
        if bad:
            for r in bad:
                print(f"KERNEL DRIFT: {r['model']} flops ratio "
                      f"{r['kernel_flops_ratio']:.3f} is {drift(r):.2f} "
                      f"times its pinned {COUNTING_RATIO[r['model']]}, "
                      f"beyond a factor of {limit}")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
