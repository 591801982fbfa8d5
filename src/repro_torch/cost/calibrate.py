"""Per-model compute costs: the data half of ``repro.cost.calibrate``.

``ModelCost`` and the committed ``calibration.json`` next to this module
(an exact copy of the reference package's file) are the pricing source
every consumer loads: :class:`~repro_torch.cost.model.CostModel`, the
placement engine and the DES service models.  The roofline measurers that
produced the file (HLO flops of the compiled JAX kernels, wall-time
efficiency and lognormal-noise fitting) are not ported yet; until they
are, the committed file is the only calibration, and it stays
deterministic because loading it is never a measurement.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

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
