"""Unified continuum cost subsystem, ported beside ``repro.cost``.

* :mod:`repro_torch.cost.profiles`  — devices / tiers / links (the one
  shared link table: ``WAN_BANDS``, ``DEFAULT_PROFILE``),
* :mod:`repro_torch.cost.calibrate` — per-model costs from the committed
  ``calibration.json`` (a copy of the reference's file),
* :mod:`repro_torch.cost.model`     — :class:`CostModel`, the single
  compute/transfer/service-time oracle the placement engine and the DES
  service models consume.

The placement advisor and the re-advisor (``repro.cost.advisor``,
``repro.cost.readvisor``) are not ported yet.
"""
from repro_torch.cost.calibrate import (CALIBRATION_PATH, ModelCost,
                                        load_calibration, save_calibration)
from repro_torch.cost.model import CostModel, default_cost_model
from repro_torch.cost.profiles import (DEFAULT_PROFILE, DEFAULT_WAN_BAND,
                                       WAN_BANDS, ContinuumProfile,
                                       DeviceProfile, Hop, LinkModel, Route,
                                       TierProfile, Topology)

__all__ = [
    "LinkModel", "DeviceProfile", "TierProfile", "ContinuumProfile",
    "Topology", "Route", "Hop",
    "WAN_BANDS", "DEFAULT_WAN_BAND", "DEFAULT_PROFILE",
    "ModelCost", "load_calibration", "save_calibration",
    "CALIBRATION_PATH",
    "CostModel", "default_cost_model",
]
