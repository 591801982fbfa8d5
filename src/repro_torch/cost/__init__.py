"""Unified continuum cost subsystem, ported beside ``repro.cost``.

* :mod:`repro_torch.cost.profiles`  — devices / tiers / links (the one
  shared link table: ``WAN_BANDS``, ``DEFAULT_PROFILE``),
* :mod:`repro_torch.cost.calibrate` — per-model costs from the committed
  ``calibration.json`` (a copy of the reference's file),
* :mod:`repro_torch.cost.model`     — :class:`CostModel`, the single
  compute/transfer/service-time oracle the placement engine and the DES
  service models consume,
* :mod:`repro_torch.cost.advisor`   — :class:`PlacementAdvisor`, a
  DES-backed ranked placement recommendation on the genuine pipeline
  (re-exported lazily: it imports the sim/core stack, which imports this
  package),
* :mod:`repro_torch.cost.readvisor` — :class:`ReAdvisor`, the online
  re-advisor that hot-swaps a stage's placement under drift.
"""
from repro_torch.cost.calibrate import (CALIBRATION_PATH, ModelCost,
                                        load_calibration, save_calibration)
from repro_torch.cost.model import CostModel, default_cost_model
from repro_torch.cost.profiles import (DEFAULT_PROFILE, DEFAULT_WAN_BAND,
                                       WAN_BANDS, ContinuumProfile,
                                       DeviceProfile, Hop, LinkModel, Route,
                                       TierProfile, Topology)

_LAZY = ("PlacementAdvisor", "AdvisorReport", "Advice")

__all__ = [
    "LinkModel", "DeviceProfile", "TierProfile", "ContinuumProfile",
    "Topology", "Route", "Hop",
    "WAN_BANDS", "DEFAULT_WAN_BAND", "DEFAULT_PROFILE",
    "ModelCost", "load_calibration", "save_calibration",
    "CALIBRATION_PATH",
    "CostModel", "default_cost_model",
    *_LAZY,
]


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.cost import advisor
        return getattr(advisor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
