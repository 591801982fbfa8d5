"""Elasticity + fault tolerance orchestration (paper §II-D, §V challenge ii).

"If supported by the resource, the allocated resources can be adapted, i.e.,
expanded and scaled-down, dynamically at runtime, e.g., if a bottleneck
arises due to increased data rates or in response to an application event."

Two mechanisms:

1. :class:`AutoScaler` — watches a pipeline's broker lag + per-hop latencies
   (the paper's bottleneck identification) and calls ``PilotManager.resize``
   when the consuming side falls behind (the paper's four-partition scenario
   where "the processing system becomes the bottleneck").

2. :func:`remesh_restart` — node-loss recovery for mesh pilots: given a
   checkpoint and a *smaller* surviving device set, rebuild the mesh, reshard
   the checkpointed train state onto it, and return a rebound step function.
   This is the multi-pod story: lose a pod → restart on the surviving pod
   from the last checkpoint (ckpt/ handles reshard-on-restore).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.core.monitoring import MetricsRegistry
from repro_torch.core.pilot import Pilot, PilotManager
from repro_torch.sim.clock import Clock, as_clock


@dataclass
class ScalePolicy:
    max_workers: int = 16
    min_workers: int = 1
    lag_high: int = 64            # scale up when broker lag exceeds this
    lag_low: int = 4              # scale down when lag stays below this
    cooldown_s: float = 1.0


class AutoScaler:
    """Lag-driven scaling of a consuming pilot's worker count."""

    def __init__(self, manager: PilotManager, pilot: Pilot,
                 lag_fn: Callable[[], int],
                 policy: Optional[ScalePolicy] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 interval_s: float = 0.2,
                 clock: Optional[Clock] = None):
        self.manager = manager
        self.pilot = pilot
        self.lag_fn = lag_fn
        self.policy = policy or ScalePolicy()
        self._clock = as_clock(clock)
        self.metrics = metrics or MetricsRegistry(clock=self._clock)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # cooldowns measured on the injected clock; emulated scenarios can
        # step through hours of scaling decisions in zero wall time
        self._last_action = -float("inf")
        # every resize, timestamped on the injected clock — under
        # SimExecutor this trace is bit-identical across repeated runs
        self.history: List[Dict[str, float]] = []

    def step_once(self) -> Optional[int]:
        """One scaling decision; returns the new worker count if changed."""
        lag = self.lag_fn()
        now = self._clock.now()
        if now - self._last_action < self.policy.cooldown_s:
            return None
        workers = self.pilot.resource.n_workers
        new = None
        if lag > self.policy.lag_high and workers < self.policy.max_workers:
            new = min(workers * 2, self.policy.max_workers)
        elif lag < self.policy.lag_low and workers > self.policy.min_workers:
            new = max(workers // 2, self.policy.min_workers)
        if new is not None and new != workers:
            self.manager.resize(self.pilot, n_workers=new)
            self._last_action = now
            self.history.append({"t": now, "from_workers": workers,
                                 "to_workers": new, "lag": lag})
            self.metrics.event("autoscale", pilot=self.pilot.pilot_id,
                               from_workers=workers, to_workers=new,
                               lag=lag)
            return new
        return None

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.step_once()
                except Exception:   # noqa: BLE001 — scaler must not die
                    self.metrics.incr("autoscaler.errors")
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)


def remesh_restart(manager: PilotManager, failed_pilot: Pilot,
                   n_devices: int, *,
                   restore_fn: Callable,
                   metrics: Optional[MetricsRegistry] = None):
    """Recover from a mesh-pilot failure.

    1. mark the failed pilot (its devices are gone),
    2. admit a replacement pilot over ``n_devices`` surviving devices,
    3. call ``restore_fn(new_pilot)`` — typically
       ``ckpt.restore(..., like=..., device=new_pilot.devices[0])``, which
       places the last checkpoint on the replacement pilot's card,
    4. return (new_pilot, restored_state).
    """
    import dataclasses as _dc
    if metrics:
        metrics.event("pilot_failed", pilot=failed_pilot.pilot_id)
    manager.mark_failed(failed_pilot)
    res = _dc.replace(failed_pilot.resource, n_devices=n_devices,
                      mesh_shape=None)
    new_pilot = manager.submit_pilot(res)
    state = restore_fn(new_pilot)
    if metrics:
        metrics.event("pilot_recovered", pilot=new_pilot.pilot_id,
                      devices=n_devices)
    return new_pilot, state
