"""The pilot abstraction (paper §II-A) adapted to a PyTorch/CUDA continuum.

A *pilot* is a placeholder resource container acquired once and multiplexed
by application tasks; resource management is decoupled from workload
management. On the original infrastructure a pilot is a VM / HPC partition /
RasPi. Here a pilot is a **named slice of compute**:

* ``tier='device'`` — sensor-class SoC slots right next to the data —
  generation only;
* ``tier='edge'``   — host CPU thread slots (the paper's RasPi-class Dask
  task: 1 core / ~4 GB) — data generation, light pre-processing;
* ``tier='fog'``    — metro gateway boxes between edge site and
  datacenter — aggregation along the path;
* ``tier='cloud'``  — a slice of the host's CUDA devices, arranged as a
  :class:`DeviceMesh` record — heavy processing, training, serving;
* ``tier='hpc'``    — like cloud, different accounting label.

The :class:`PilotManager` plays the paper's pilot framework: it owns the
global device inventory (one ``torch.device("cuda:i")`` per visible card),
performs admission (no oversubscription of devices across pilots), builds
per-pilot :class:`DeviceMesh` records, and can
``resize``/``release`` pilots at runtime (the paper's dynamism requirement —
see also core/elastic.py).

Plugin architecture (paper §II-B): resource *descriptions* say what backs a
pilot; new backends register via :func:`register_backend` the way
Pilot-Streaming registers OpenStack/AWS/SSH plugins.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.sim.clock import Clock, as_clock

# the default continuum's tier names (device → edge → fog → cloud, plus
# the hpc accounting tier). Custom topologies may use any non-empty tier
# name — tiers are continuum-profile keys, not a closed enum.
TIERS = ("device", "edge", "fog", "cloud", "hpc")


@dataclass(frozen=True)
class ComputeResource:
    """Paper's pilot_compute_description analog: what to allocate where."""
    tier: str                         # device | edge | fog | cloud | hpc | …
    n_devices: int = 0                # mesh devices (cloud/hpc pilots)
    n_workers: int = 1                # executor threads (edge pilots)
    mesh_axes: tuple = ("data",)      # axis names for the pilot's sub-mesh
    mesh_shape: Optional[tuple] = None
    memory_gb: float = 4.0            # admission accounting only
    backend: str = "local"            # plugin key (local | ssh | openstack…)
    label: str = ""

    def __post_init__(self):
        if not self.tier or not isinstance(self.tier, str):
            raise ValueError(f"tier must be a non-empty string (e.g. one "
                             f"of {TIERS}), got {self.tier!r}")


class PilotError(RuntimeError):
    pass


@dataclass(frozen=True, eq=False)
class DeviceMesh:
    """A pilot's devices laid out on named axes: an object ndarray of
    ``torch.device`` and one name per axis.  It records the layout only;
    collectives over it wait for the distributed launch stack."""
    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def cuda_devices() -> tuple:
    """Every visible CUDA device; raises :class:`PilotError` where there is
    none, so a manager never silently inventories the host CPU."""
    if not torch.cuda.is_available():
        raise PilotError(
            "no CUDA device is visible: PilotManager() inventories the "
            "host's cards; pass devices=() for a manager without devices")
    return tuple(torch.device(f"cuda:{i}")
                 for i in range(torch.cuda.device_count()))


_pilot_ids = itertools.count()


@dataclass
class Pilot:
    """An acquired resource container. Tasks bind to a pilot at submit time
    (late binding = the placement decision)."""
    pilot_id: str
    resource: ComputeResource
    devices: tuple = ()
    mesh: Optional[DeviceMesh] = None
    state: str = "active"             # active | draining | released | failed
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    @property
    def tier(self) -> str:
        return self.resource.tier

    @property
    def capacity(self) -> int:
        """Concurrent task slots: workers (edge) or 1 SPMD slot (mesh)."""
        if self.mesh is not None:
            return 1
        return self.resource.n_workers

    def require_active(self) -> None:
        if self.state != "active":
            raise PilotError(f"pilot {self.pilot_id} is {self.state}")

    def fail(self) -> None:
        with self._lock:
            self.state = "failed"

    def __hash__(self):
        return hash(self.pilot_id)


# -- backend plugins ----------------------------------------------------------

_BACKENDS: Dict[str, Callable] = {}


def register_backend(name: str):
    def deco(fn):
        _BACKENDS[name] = fn
        return fn
    return deco


@register_backend("local")
def _local_backend(resource: ComputeResource,
                   devices: Sequence) -> tuple:
    """Default backend: slice local CUDA devices for mesh pilots."""
    return tuple(devices)


class PilotManager:
    """Owns the device inventory; admits, resizes, releases pilots.

    The manager never runs workload code — that is the decoupling the paper's
    abstraction is built on. The FaaS layer (core/faas.py) binds functions to
    pilots *after* acquisition.
    """

    def __init__(self, devices: Optional[Sequence] = None,
                 clock: Optional[Clock] = None,
                 heartbeat_timeout_s: float = 30.0):
        self._lock = threading.Lock()
        self._clock = as_clock(clock)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self._all_devices = tuple(devices if devices is not None
                                  else cuda_devices())
        self._free = list(self._all_devices)
        self._pilots: Dict[str, Pilot] = {}
        self._heartbeats: Dict[str, float] = {}

    # -- inventory ---------------------------------------------------------

    @property
    def free_devices(self) -> int:
        with self._lock:
            return len(self._free)

    def pilots(self, tier: Optional[str] = None) -> List[Pilot]:
        with self._lock:
            ps = [p for p in self._pilots.values() if p.state == "active"]
        if tier:
            ps = [p for p in ps if p.tier == tier]
        return ps

    # -- lifecycle -----------------------------------------------------------

    def submit_pilot(self, resource: ComputeResource) -> Pilot:
        """Paper's step 1: allocate a placeholder resource container."""
        backend = _BACKENDS.get(resource.backend)
        if backend is None:
            raise PilotError(f"unknown backend {resource.backend!r}; "
                             f"registered: {sorted(_BACKENDS)}")
        with self._lock:
            devices: tuple = ()
            mesh = None
            if resource.n_devices > 0:
                if len(self._free) < resource.n_devices:
                    raise PilotError(
                        f"admission failed: want {resource.n_devices} "
                        f"devices, {len(self._free)} free")
                devices = backend(resource, self._free[:resource.n_devices])
                self._free = self._free[resource.n_devices:]
                mesh = self._make_mesh(devices, resource)
            pid = f"pilot-{resource.tier}-{next(_pilot_ids)}"
            pilot = Pilot(pilot_id=pid, resource=resource,
                          devices=devices, mesh=mesh)
            self._pilots[pid] = pilot
            self._heartbeats[pid] = self._clock.now()
            return pilot

    # -- liveness ------------------------------------------------------------

    def heartbeat(self, pilot: Pilot) -> None:
        """Pilot liveness beat (the paper's failure detection across the
        continuum); stamped on the injected clock so emulated scenarios can
        schedule silent node loss."""
        with self._lock:
            self._heartbeats[pilot.pilot_id] = self._clock.now()

    def last_heartbeat(self, pilot: Pilot) -> Optional[float]:
        with self._lock:
            return self._heartbeats.get(pilot.pilot_id)

    def check_liveness(self,
                       timeout_s: Optional[float] = None) -> List[Pilot]:
        """Mark active pilots whose last beat is older than the timeout as
        failed (their devices are gone — a node loss, not a release).
        Returns the newly failed pilots."""
        timeout = (self.heartbeat_timeout_s
                   if timeout_s is None else timeout_s)
        now = self._clock.now()
        lost: List[Pilot] = []
        with self._lock:
            for pid, p in self._pilots.items():
                if p.state != "active":
                    continue
                beat = self._heartbeats.get(pid)
                if beat is not None and now - beat > timeout:
                    p.fail()
                    lost.append(p)
        return lost

    @staticmethod
    def _make_mesh(devices: tuple, resource: ComputeResource):
        shape = resource.mesh_shape or (len(devices),)
        if int(np.prod(shape)) != len(devices):
            raise PilotError(f"mesh_shape {shape} != {len(devices)} devices")
        arr = np.array(devices, dtype=object).reshape(shape)
        return DeviceMesh(arr, tuple(resource.mesh_axes))

    def resize(self, pilot: Pilot, n_devices: Optional[int] = None,
               n_workers: Optional[int] = None) -> Pilot:
        """Elastic scale-up/down at runtime (paper §II-D). Returns a *new*
        Pilot object with the same id; in-flight SPMD tasks must be re-bound
        by the caller (core/elastic.py orchestrates re-mesh + reshard)."""
        pilot.require_active()
        res = pilot.resource
        with self._lock:
            if n_devices is not None and res.n_devices != n_devices:
                delta = n_devices - res.n_devices
                if delta > 0:
                    if len(self._free) < delta:
                        raise PilotError(
                            f"resize failed: want {delta} more devices, "
                            f"{len(self._free)} free")
                    new_devices = pilot.devices + tuple(self._free[:delta])
                    self._free = self._free[delta:]
                else:
                    new_devices = pilot.devices[:n_devices]
                    self._free.extend(pilot.devices[n_devices:])
                res = dataclasses.replace(res, n_devices=n_devices,
                                          mesh_shape=None)
                pilot.devices = new_devices
                pilot.mesh = (self._make_mesh(new_devices, res)
                              if new_devices else None)
            if n_workers is not None:
                res = dataclasses.replace(res, n_workers=n_workers)
            pilot.resource = res
            return pilot

    def release(self, pilot: Pilot) -> None:
        with self._lock:
            if pilot.state == "released":
                return
            pilot.state = "released"
            self._free.extend(pilot.devices)
            pilot.devices = ()
            pilot.mesh = None

    def mark_failed(self, pilot: Pilot) -> None:
        """Failure detector hook: devices of a failed pilot are *not*
        returned to the free pool (they are gone), matching a node loss."""
        with self._lock:
            pilot.fail()

    def release_all(self) -> None:
        for p in list(self._pilots.values()):
            if p.state == "active":
                self.release(p)
