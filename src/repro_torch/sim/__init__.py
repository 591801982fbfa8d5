"""Deterministic virtual time for the edge-to-cloud continuum, ported
beside ``repro.sim``.

* :mod:`repro_torch.sim.clock` — the injected-clock API.  :class:`SimClock`
  is a virtual clock; :class:`SystemClock` is the wall-clock default.
  Every core layer (broker, runtime, pilot liveness, autoscaler,
  monitoring, pipeline) takes a ``clock=`` and never calls ``time.*``
  directly.
* :mod:`repro_torch.sim.scheduler` — :class:`EventScheduler`, a classic
  discrete-event loop over the virtual clock with deterministic
  (time, insertion-order) event ordering.

* :mod:`repro_torch.sim.scenarios` — the Fig-3 scenario harness:
  geo-distributed pipeline runs (k-means / autoencoder × edge / cloud /
  hybrid placement × WAN bands × failure schedules) replayed in
  milliseconds of wall time with bit-reproducible metrics.

* :mod:`repro_torch.sim.shard` — the sharded DES: conservative
  time-window parallel simulation across processes (device-partition,
  tier and drift cuts), bit-identical to the single-process run.

``scenarios`` is re-exported lazily (PEP 562) because it imports
``repro_torch.core`` which itself imports :mod:`repro_torch.sim.clock`;
``shard`` is imported by name (``from repro_torch.sim import shard``).
"""
from repro_torch.sim.clock import (SYSTEM_CLOCK, Clock, SimClock,
                                   SystemClock, as_clock)
from repro_torch.sim.scheduler import (PARK, Actor, ActorKilled,
                                       EventScheduler)

_SCENARIO_NAMES = ("ModelSpec", "Scenario", "ScenarioResult", "FailureSpec",
                   "WAN_BANDS", "KMEANS", "AUTOENCODER", "ISOFOREST",
                   "MODELS", "PLACEMENTS", "model_specs", "run_scenario",
                   "sweep", "format_table",
                   "ArrivalProcess", "PoissonArrivals", "DiurnalArrivals",
                   "FlashCrowdArrivals", "TraceArrivals", "arrival_plan")
# SimExecutor lives in repro_torch.core.executor (it drives the real
# pipeline); re-exported here lazily because repro_torch.core imports
# repro_torch.sim.clock.
_EXECUTOR_NAMES = ("SimExecutor", "ThreadedExecutor")

__all__ = ["Clock", "SystemClock", "SimClock", "SYSTEM_CLOCK", "as_clock",
           "EventScheduler", "Actor", "ActorKilled", "PARK",
           *_EXECUTOR_NAMES, *_SCENARIO_NAMES]


def __getattr__(name):
    if name in _SCENARIO_NAMES:
        from repro_torch.sim import scenarios
        return getattr(scenarios, name)
    if name in _EXECUTOR_NAMES:
        from repro_torch.core import executor
        return getattr(executor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
