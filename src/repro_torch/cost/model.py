"""The unified continuum cost model.

One object answers every "how long will this take" question in the repo —
the :class:`~repro_torch.core.placement.PlacementEngine` scores pilots through
it, :mod:`repro_torch.sim.scenarios` prices DES stage service times with it, and
the :class:`~repro_torch.cost.advisor.PlacementAdvisor` sweeps it under the real
pipeline.  All parameters flow from :mod:`repro_torch.cost.profiles` (devices /
tiers / links) and :mod:`repro_torch.cost.calibrate` (per-model costs measured
from the compiled ``repro_torch.ml`` kernels), never from per-module constants.

Service-time model: ``t = effective_flops / (peak_flops × workers)``,
optionally × a lognormal noise factor ``LogNormal(-σ²/2, σ)`` (mean 1)
whose σ comes from measured wall-time samples — the noise model the DES
straggler machinery needs.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

from repro_torch.cost.calibrate import ModelCost, load_calibration
from repro_torch.cost.profiles import (DEFAULT_PROFILE, ContinuumProfile,
                                 LinkModel, Route)

# cloud-side result ingest for edge-placed models: merging a published
# model output costs a few flops per serialized value (the only "analytic"
# constant left, and it lives here, in the cost subsystem)
INGEST_FLOPS_PER_VALUE = 50.0


class CostModel:
    """Predicts per-task compute / transfer / service time on a continuum.

    Parameters
    ----------
    profile: the hardware continuum (tiers/devices/links); defaults to the
        paper-testbed :data:`~repro_torch.cost.profiles.DEFAULT_PROFILE`.
    costs: per-model :class:`~repro_torch.cost.calibrate.ModelCost` entries;
        defaults to the committed kernel calibration.
    """

    def __init__(self, profile: Optional[ContinuumProfile] = None,
                 costs: Optional[Mapping[str, ModelCost]] = None):
        self.profile = profile or DEFAULT_PROFILE
        self.costs: Dict[str, ModelCost] = dict(
            costs if costs is not None else load_calibration())

    def with_wan(self, band: str) -> "CostModel":
        """The same costs priced over a named WAN band."""
        return CostModel(self.profile.with_wan(band), self.costs)

    def with_metro(self, band: str) -> "CostModel":
        """The same costs priced over a named metro (edge→fog) band."""
        return CostModel(self.profile.with_metro(band), self.costs)

    # -- lookups -----------------------------------------------------------

    @property
    def links(self) -> Dict[Tuple[str, str], LinkModel]:
        """Inter-tier link table (the PlacementEngine's view)."""
        return dict(self.profile.links)

    def model_cost(self, name: str) -> ModelCost:
        try:
            return self.costs[name]
        except KeyError:
            raise KeyError(f"no calibrated cost for model {name!r}; "
                           f"known: {sorted(self.costs)}") from None

    def link(self, a: str, b: str) -> LinkModel:
        return self.profile.link(a, b)

    def route(self, src: str, dst: str, nbytes: float = 0.0) -> Route:
        """Shortest-time multi-hop route between two tiers (see
        :meth:`~repro_torch.cost.profiles.ContinuumProfile.route`)."""
        return self.profile.route(src, dst, nbytes)

    def tier_flops(self, tier: str, n_workers: int = 1,
                   precision: str = "fp32") -> float:
        """Aggregate peak FLOP/s of ``n_workers`` devices of a tier, at a
        kernel precision (reduced-precision datapaths run at a multiple of
        the fp32 peak — see :meth:`DeviceProfile.speedup`)."""
        dev = self.profile.tier(tier).device
        return dev.peak_flops * dev.speedup(precision) * max(n_workers, 1)

    # -- primitive estimates ----------------------------------------------

    def compute_s(self, flops: float, tier: str, n_workers: int = 1,
                  precision: str = "fp32") -> float:
        """Seconds to execute ``flops`` (peak-rate-equivalent) on a tier."""
        return flops / max(self.tier_flops(tier, n_workers, precision), 1.0)

    def transfer_s(self, nbytes: float, src: str, dst: str) -> float:
        """Seconds to move ``nbytes`` between tiers (0 bytes = free),
        priced over the *routed* path: tiers without a direct link pay
        every hop's serialization plus the accumulated per-hop latency."""
        if not nbytes:
            return 0.0
        return self.route(src, dst, nbytes).transfer_s(nbytes)

    # -- per-model estimates ----------------------------------------------

    def model_compute_s(self, model: str, n_points: int, tier: str,
                        n_workers: int = 1) -> float:
        """Full-model service time for one ``n_points`` message, priced at
        the tier's peak for the model's calibrated kernel precision."""
        mc = self.model_cost(model)
        return self.compute_s(mc.effective_flops_per_point * n_points,
                              tier, n_workers, mc.precision)

    def preprocess_s(self, model: str, n_points: int, tier: str,
                     n_workers: int = 1) -> float:
        """Edge pre-aggregation time (the hybrid placement's edge stage)."""
        mc = self.model_cost(model)
        return self.compute_s(mc.preprocess_flops_per_point * n_points,
                              tier, n_workers)

    def ingest_bytes_s(self, output_bytes: float, tier: str,
                       n_workers: int = 1) -> float:
        """Cloud-side merge of ``output_bytes`` of published model output
        (priced at :data:`INGEST_FLOPS_PER_VALUE` per serialized value)."""
        values = output_bytes / 8.0
        return self.compute_s(values * INGEST_FLOPS_PER_VALUE, tier,
                              n_workers)

    def ingest_s(self, model: str, tier: str, n_workers: int = 1) -> float:
        """Cloud-side merge of an edge-placed model's published output."""
        return self.ingest_bytes_s(self.model_cost(model).output_bytes,
                                   tier, n_workers)

    # -- calibrated service model (what the executors consume) -------------

    def service_model(self, stage_times: Mapping[str, float], *,
                      sigma: float = 0.0, seed: int = 0
                      ) -> Callable[[str, object, object], float]:
        """Build a ``service_model(stage, ctx, payload)`` callable for
        :class:`~repro_torch.core.executor.SimExecutor` /
        :class:`~repro_torch.core.executor.ThreadedExecutor` from per-stage base
        times.

        With ``sigma > 0`` every charge is multiplied by a mean-1
        lognormal draw (the calibrated straggler noise) from a seeded rng
        — runs stay bit-reproducible for a given seed under the
        single-threaded SimExecutor.  The draw is lock-guarded so the
        noisy model is also safe (though no longer bit-ordered) under
        ThreadedExecutor's concurrent consumers.
        """
        base = dict(stage_times)
        if sigma <= 0.0:
            return lambda stage, ctx, payload: base.get(stage, 0.0)
        import threading

        import numpy as np
        rng = np.random.default_rng([seed & 0xFFFFFFFF, 0xC057])
        lock = threading.Lock()
        mu = -0.5 * sigma * sigma

        def model(stage, ctx, payload):
            t = base.get(stage, 0.0)
            if t <= 0.0:
                return t
            with lock:
                z = rng.normal(mu, sigma)
            return t * float(np.exp(z))

        return model

    def tier_service_model(self, stage_flops: Mapping[str, float], *,
                           resolve: Callable[[str], Tuple[str, int]],
                           sigma: float = 0.0, seed: int = 0,
                           stage_precision: Optional[Mapping[str, str]]
                           = None
                           ) -> Callable[[str, object, object], float]:
        """Like :meth:`service_model`, but per-stage *FLOPs* are priced at
        the tier a stage executes on **at charge time** — ``resolve(stage)``
        returns the live ``(tier, n_workers)`` binding.  This is what makes
        a mid-run placement hot-swap re-price service automatically: after
        the ReAdvisor rebinds a stage from cloud to fog, the very next
        charge runs at the fog device's peak rate, with no service-model
        rebuild.  Noise draws (``sigma > 0``) come from the same seeded
        stream as :meth:`service_model`, in charge order, so swapped runs
        stay bit-reproducible under the single-threaded SimExecutor.

        ``stage_precision`` names the kernel precision a stage's flops run
        at (default fp32) — a quantized model's compute stage is priced at
        the resolved tier's int8 peak, whatever tier it lands on."""
        flops = dict(stage_flops)
        precision = dict(stage_precision or {})
        if sigma > 0.0:
            import threading

            import numpy as np
            rng = np.random.default_rng([seed & 0xFFFFFFFF, 0xC057])
            lock = threading.Lock()
            mu = -0.5 * sigma * sigma
        else:
            rng = None

        def model(stage, ctx, payload):
            f = flops.get(stage, 0.0)
            if f <= 0.0:
                return 0.0
            tier, workers = resolve(stage)
            t = self.compute_s(f, tier, workers,
                               precision.get(stage, "fp32"))
            if rng is None:
                return t
            with lock:
                z = rng.normal(mu, sigma)
            return t * float(np.exp(z))

        return model


_DEFAULT: Optional[CostModel] = None


def default_cost_model() -> CostModel:
    """The shared default CostModel (committed calibration + paper-testbed
    profile) — cached, read-only by convention."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = CostModel()
    return _DEFAULT
