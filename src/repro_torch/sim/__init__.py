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

The scenario harness and the sharded runner (``repro.sim.scenarios``,
``repro.sim.shard``) are not ported yet.
"""
from repro_torch.sim.clock import (SYSTEM_CLOCK, Clock, SimClock,
                                   SystemClock, as_clock)
from repro_torch.sim.scheduler import (PARK, Actor, ActorKilled,
                                       EventScheduler)

__all__ = ["Clock", "SystemClock", "SimClock", "SYSTEM_CLOCK", "as_clock",
           "EventScheduler", "Actor", "ActorKilled", "PARK"]
