"""Placement engine (paper §II-B step 2.1).

"Pilot-Edge automatically handles task placements, i.e., the binding of a
task to a pilot" — "considering application-defined preferences (e.g., data
dependencies and preferred placements)".

The engine scores candidate pilots for a task from:

* **preference** — the application's preferred tier(s) (the paper's
  cloud-centric vs edge-centric vs hybrid deployment modalities),
* **data locality** — estimated bytes that must cross the continuum if the
  task lands on this pilot, charged at per-hop bandwidth (edge↔cloud rides
  the WAN; within a tier rides local links),
* **compute cost** — task FLOPs at the pilot's effective FLOP/s (an edge
  pilot is RasPi-class; a cloud mesh pilot aggregates its devices),
* **load** — outstanding tasks on the pilot's runtime.

Score = estimated completion time; lowest wins. This is exactly the paper's
experiment-driven trade-off (Fig 3: k-means is transfer-bound so geo
placement halves throughput; autoencoders are compute-bound so the network
"is not the bottleneck") turned into a cost model, and it is what the
EdgeToCloudPipeline uses when the application passes ``placement='auto'``.

Every number the engine prices with flows from the unified cost subsystem
(:mod:`repro_torch.cost`): link bandwidths/latencies come from the shared
:data:`~repro_torch.cost.profiles.WAN_BANDS` table (``DEFAULT_LINKS`` below is an
import-time snapshot of it, pinned equal by a regression test) and tier
FLOP rates come from the continuum profile's device
specs — there are no module-level cost constants here any more.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.pilot import Pilot
from repro_torch.cost.model import CostModel, default_cost_model
from repro_torch.cost.profiles import DEFAULT_PROFILE, LinkModel  # noqa: F401

# the shared link table (edge↔cloud/hpc ride the paper's 10 Mbit/s iPerf
# WAN band, cloud↔hpc a fat datacenter link) — an import-time snapshot of
# the continuum profile, pinned equal to sim.scenarios' WAN table by a
# regression test
DEFAULT_LINKS: Dict[Tuple[str, str], LinkModel] = dict(
    DEFAULT_PROFILE.links)


def link_between(a: str, b: str,
                 links: Dict[Tuple[str, str], LinkModel],
                 profile=DEFAULT_PROFILE) -> LinkModel:
    """Resolve the link between two tiers: the explicit table first, then
    the profile's intra-tier / fallback links."""
    if a == b:
        return profile.link(a, a)
    return links.get((a, b)) or links.get((b, a)) or profile.link(a, b)


@dataclass(frozen=True)
class TaskProfile:
    """What the placement engine knows about a task. ``flops`` is
    peak-rate-equivalent work (a calibrated ``ModelCost`` folds kernel
    efficiency into its ``effective_flops_per_point``)."""
    flops: float = 0.0                 # estimated compute
    input_bytes: float = 0.0           # bytes it must pull
    input_tier: str = "edge"           # where the input currently lives
    output_bytes: float = 0.0
    output_tier: Optional[str] = None  # where the output must land
    preferred_tiers: Sequence[str] = ()
    memory_gb: float = 0.0
    precision: str = "fp32"            # kernel precision variant (fp32 |
    #                                    bf16 | int8): compute is priced at
    #                                    the pilot tier's precision peak


@dataclass
class PlacementDecision:
    pilot: Pilot
    est_time_s: float
    breakdown: Dict[str, float] = field(default_factory=dict)


class PlacementEngine:
    """Scores pilots through a :class:`~repro_torch.cost.model.CostModel`.

    Any tier in the continuum profile is scored at *its own* device rate
    — a fog pilot is priced as fog hardware, not silently as cloud (the
    historical edge-vs-everything-else branching mispriced every
    intermediate tier at cloud rates).

    ``links`` overrides the link table (e.g. one WAN band of the Fig-3
    sweep); ``edge_flops``/``device_flops`` override the edge and
    cloud/hpc rates (back-compat knobs — prefer passing a ``cost_model``
    built on a custom :class:`~repro_torch.cost.profiles.ContinuumProfile`)."""

    def __init__(self, links: Optional[Dict] = None,
                 edge_flops: Optional[float] = None,
                 device_flops: Optional[float] = None,
                 cost_model: Optional[CostModel] = None):
        self.cost = cost_model or default_cost_model()
        self.links = dict(self.cost.links if links is None else links)
        self._tier_overrides: Dict[str, float] = {}
        if edge_flops is not None:
            self._tier_overrides["edge"] = edge_flops
        if device_flops is not None:
            self._tier_overrides["cloud"] = device_flops
            self._tier_overrides["hpc"] = device_flops
        self.edge_flops = (edge_flops if edge_flops is not None
                           else self.cost.tier_flops("edge"))
        self.device_flops = (device_flops if device_flops is not None
                             else self.cost.tier_flops("cloud"))

    def tier_rate(self, tier: str, precision: str = "fp32") -> float:
        """Per-device peak FLOP/s of a tier at a kernel precision: the
        override when set (overrides are fp32 back-compat knobs and stay
        unscaled), else the profile's device rate × its precision
        speedup.  Tiers the profile doesn't know price conservatively at
        the *slowest* known tier's rate — an optimistic (fast) guess
        would bias auto-placement onto unmodeled tiers."""
        rate = self._tier_overrides.get(tier)
        if rate is not None:
            return rate
        try:
            return self.cost.tier_flops(tier, 1, precision)
        except KeyError:
            rates = [tp.device.peak_flops
                     for tp in self.cost.profile.tiers.values()]
            return min(rates) if rates else self.device_flops

    def pilot_flops(self, pilot: Pilot, precision: str = "fp32") -> float:
        if pilot.mesh is not None:
            # mesh pilots aggregate cloud-class accelerator devices
            return self.tier_rate(pilot.tier, precision) * len(pilot.devices)
        return self.tier_rate(pilot.tier, precision) \
            * pilot.resource.n_workers

    def estimate(self, task: TaskProfile, pilot: Pilot,
                 queue_depth: int = 0) -> PlacementDecision:
        profile = self.cost.profile
        move_in = link_between(task.input_tier, pilot.tier, self.links,
                               profile)
        t_in = (task.input_bytes / move_in.bandwidth + move_in.latency_s
                if task.input_bytes else 0.0)
        t_out = 0.0
        if task.output_bytes and task.output_tier:
            move_out = link_between(pilot.tier, task.output_tier,
                                    self.links, profile)
            t_out = (task.output_bytes / move_out.bandwidth
                     + move_out.latency_s)
        t_compute = task.flops / max(
            self.pilot_flops(pilot, task.precision), 1.0)
        t_queue = queue_depth * max(t_compute, 1e-6)
        penalty = 0.0
        if task.preferred_tiers and pilot.tier not in task.preferred_tiers:
            penalty = 10.0 * (t_in + t_compute + t_out + 1e-3)
        if (task.memory_gb and pilot.resource.memory_gb
                and task.memory_gb > pilot.resource.memory_gb):
            penalty += 1e6                     # doesn't fit — effectively veto
        total = t_in + t_compute + t_out + t_queue + penalty
        return PlacementDecision(
            pilot=pilot, est_time_s=total,
            breakdown={"t_in": t_in, "t_compute": t_compute, "t_out": t_out,
                       "t_queue": t_queue, "penalty": penalty})

    def place(self, task: TaskProfile, pilots: Sequence[Pilot],
              queue_depths: Optional[Dict[str, int]] = None
              ) -> PlacementDecision:
        if not pilots:
            raise ValueError("no candidate pilots")
        queue_depths = queue_depths or {}
        decisions = [
            self.estimate(task, p, queue_depths.get(p.pilot_id, 0))
            for p in pilots if p.state == "active"]
        if not decisions:
            raise ValueError("no active pilots")
        return min(decisions, key=lambda d: d.est_time_s)

    def compare_tiers(self, task: TaskProfile,
                      pilots: Sequence[Pilot]) -> Dict[str, float]:
        """Per-tier estimated times — the paper's Fig 3 style trade-off
        table, exposed to applications for placement evaluation."""
        out: Dict[str, float] = {}
        for p in pilots:
            d = self.estimate(task, p)
            if p.tier not in out or d.est_time_s < out[p.tier]:
                out[p.tier] = d.est_time_s
        return out
