"""DES-backed placement advisor (the paper's headline claim, §I:
applications "evaluate task placement based on multiple factors (e.g.,
model complexities, throughput, and latency)").

:class:`PlacementAdvisor` runs the *genuine* pipeline (the two-stage
:class:`~repro_torch.core.faas.EdgeToCloudPipeline` wrapper, or the 3-stage
edge→fog→cloud :class:`~repro_torch.core.faas.ContinuumPipeline` for the fog
placement) under :class:`~repro_torch.core.executor.SimExecutor` across
{placements over the full tier set} × {WAN bands} — real broker offsets,
consumer groups, dedup, WAN token bucket, only time is virtual — and
returns a ranked recommendation whose every cell carries its per-stage
tier vector (``Advice.tiers``).  The ranking is **multi-objective**: every cell reports
predicted throughput, the p50/p95/p99 latency tail, and exact WAN bytes;
``latency_budget=`` / ``wan_budget=`` constraints *filter-then-rank*
(feasible cells outrank infeasible ones, but infeasible cells stay in the
report, flagged — an impossible budget yields a ranked-but-flagged
recommendation, never an empty one).  ``hybrid_reduce=`` sweeps the hybrid
placement's edge pre-aggregation factor the same way placements are swept.

Tail fidelity: by default each cell runs with the workload's *calibrated*
lognormal service noise (``calibration.json``'s per-model sigma — pass
``service_sigma=0.0`` for the noise-free view) and can run the DES
straggler speculation (``speculative_factor=``), so p95/p99 and the
speculation win/loss counters reflect the straggler behaviour real edge
deployments rank placements by.  Because every cell is a deterministic
DES run, the recommendation is bit-identical across invocations.

Entry points::

    report = PlacementAdvisor().advise("kmeans")
    report.best("10mbit").placement          # 'edge' (transfer-bound)
    print(report.table())

    # budget-constrained, sweeping the hybrid pre-aggregation factor:
    report = PlacementAdvisor().advise(
        "kmeans", latency_budget=2.0, wan_budget=5.0,
        hybrid_reduce=(5, 10, 20))

    # or straight from a pipeline (reads model/n_points from its context):
    report = pipe.run(placement="advise", latency_budget=2.0)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.cost.model import CostModel, default_cost_model
from repro_torch.sim.scenarios import (PLACEMENTS, ModelSpec, Scenario,
                                 model_specs, run_scenario)


@dataclass(frozen=True)
class Advice:
    """One evaluated (placement, WAN band[, hybrid_reduce]) cell.
    ``tiers`` is the per-stage execution tier vector of the emulated
    pipeline (e.g. ``('edge', 'fog', 'cloud')`` for the 3-stage fog
    placement)."""
    model: str
    placement: str
    wan_band: str
    throughput_msgs_s: float
    latency_mean_s: float
    latency_p95_s: float
    wan_mbytes: float
    makespan_s: float
    tier_estimates: Dict[str, float] = field(default_factory=dict)
    latency_p50_s: float = 0.0
    latency_p99_s: float = 0.0
    wan_bytes: float = 0.0
    tiers: Tuple[str, ...] = ()           # per-stage tier vector
    hybrid_reduce: Optional[int] = None   # set on hybrid/fog cells only
    metro_band: Optional[str] = None      # fog cells: swept edge→fog band
    feasible: bool = True                 # meets the advise() budgets
    spec_launches: int = 0                # straggler speculation accounting
    spec_wins: int = 0
    spec_losses: int = 0
    spec_cancelled: int = 0
    # the precision placement axis: the model's kernel precision and its
    # assignment-agreement rate vs the fp32 reference on the fixed
    # MiniAppGenerator probe (1.0 for fp32 models; the accuracy half of
    # every accuracy-vs-latency precision cell)
    precision: str = "fp32"
    agreement_vs_fp32: float = 1.0

    def row(self) -> Dict[str, object]:
        return {"model": self.model, "placement": self.placement,
                "tiers": list(self.tiers),
                "wan": self.wan_band,
                "precision": self.precision,
                "agreement_vs_fp32": self.agreement_vs_fp32,
                "msgs_per_s": self.throughput_msgs_s,
                "lat_mean_s": self.latency_mean_s,
                "lat_p50_s": self.latency_p50_s,
                "lat_p95_s": self.latency_p95_s,
                "lat_p99_s": self.latency_p99_s,
                "wan_mb": self.wan_mbytes,
                "wan_bytes": self.wan_bytes,
                "makespan_s": self.makespan_s,
                "hybrid_reduce": self.hybrid_reduce,
                "metro": self.metro_band,
                "feasible": self.feasible,
                "spec_launches": self.spec_launches,
                "spec_wins": self.spec_wins,
                "spec_losses": self.spec_losses,
                "spec_cancelled": self.spec_cancelled}


@dataclass
class AdvisorReport:
    """Ranked recommendation across placements × WAN bands.

    ``latency_budget`` / ``wan_budget`` record the constraints the cells
    were judged against (None = unconstrained)."""
    model: str
    cells: List[Advice]
    latency_budget: Optional[float] = None
    wan_budget: Optional[float] = None

    def ranking(self, band: Optional[str] = None) -> List[Advice]:
        """Cells (optionally one band's), budget-feasible cells first,
        then by predicted throughput; ties broken by lower mean latency,
        then placement name and hybrid_reduce so the order is total and
        reproducible.  Infeasible cells are *ranked, not dropped* — an
        impossible budget still yields a full (flagged) ranking."""
        cells = [c for c in self.cells
                 if band is None or c.wan_band == band]
        return sorted(cells, key=lambda c: (not c.feasible,
                                            -c.throughput_msgs_s,
                                            c.latency_mean_s, c.placement,
                                            c.hybrid_reduce or 0,
                                            c.metro_band or ""))

    def best(self, band: str) -> Advice:
        rank = self.ranking(band)
        if not rank:
            raise ValueError(f"no advice for band {band!r}")
        return rank[0]

    def feasible_cells(self, band: Optional[str] = None) -> List[Advice]:
        """The cells that meet both budgets (may be empty — ``best`` then
        returns the least-bad infeasible cell, flagged)."""
        return [c for c in self.ranking(band) if c.feasible]

    def rows(self) -> List[Dict[str, object]]:
        """JSON-able rows with per-band rank and the recommendation flag
        (rank 1 in its band) — the BENCH_placement.json shape. Bands keep
        their evaluation order (ascending bandwidth by default)."""
        out = []
        for band in dict.fromkeys(c.wan_band for c in self.cells):
            for i, c in enumerate(self.ranking(band)):
                row = c.row()
                row["rank"] = i + 1
                row["recommended"] = i == 0
                out.append(row)
        return out

    def table(self) -> str:
        hdr = (f"{'model':>12} {'wan':>8} {'placement':>9} {'path':>5} "
               f"{'red':>4} {'rank':>4} {'msg/s':>9} {'lat-p50 s':>9} "
               f"{'lat-p95 s':>9} {'lat-p99 s':>9} {'WAN MB':>8}")
        lines = [hdr, "-" * len(hdr)]
        for r in self.rows():
            mark = " <- recommended" if r["recommended"] else ""
            if not r["feasible"]:
                mark += " [over budget]"
            red = "-" if r["hybrid_reduce"] is None else r["hybrid_reduce"]
            path = "-".join(t[0] for t in r["tiers"])
            lines.append(
                f"{r['model']:>12} {r['wan']:>8} {r['placement']:>9} "
                f"{path:>5} {red:>4} {r['rank']:>4} "
                f"{r['msgs_per_s']:>9.3f} "
                f"{r['lat_p50_s']:>9.3f} {r['lat_p95_s']:>9.3f} "
                f"{r['lat_p99_s']:>9.3f} {r['wan_mb']:>8.2f}{mark}")
        return "\n".join(lines)


class PlacementAdvisor:
    """Evaluate placements for a workload by emulating the real pipeline.

    ``n_messages`` trades prediction fidelity for advisory wall time (the
    whole default grid runs in well under a second).

    ``service_sigma=None`` (the default) applies each workload's
    *calibrated* lognormal service noise — tail-latency columns reflect
    the measured straggler behaviour, not a fiction of uniform service
    times; pass ``0.0`` to rank on noise-free service times.
    ``speculative_factor`` additionally runs the DES straggler
    speculation in every cell (0 = off)."""

    def __init__(self, cost_model: Optional[CostModel] = None, *,
                 n_messages: int = 32, n_devices: int = 4,
                 n_consumers: Optional[int] = None, n_points: int = 2_500,
                 seed: int = 0, service_sigma: Optional[float] = None,
                 speculative_factor: float = 0.0):
        self.cost = cost_model or default_cost_model()
        self.n_messages = n_messages
        self.n_devices = n_devices
        self.n_consumers = n_consumers
        self.n_points = n_points
        self.seed = seed
        self.service_sigma = service_sigma
        self.speculative_factor = speculative_factor

    @classmethod
    def from_pipeline(cls, pipe, *, n_messages: int = 32,
                      **kw) -> "PlacementAdvisor":
        """Build an advisor matching a pipeline's shape; the workload
        (``model``, ``n_points``) is read from its ``function_context``,
        the cost model from its placement engine (so the advisory and
        the engine's own scoring stay mutually consistent — note the
        engine's legacy ``edge_flops``/``device_flops``/``links``
        overrides are *not* part of its cost model and don't reach the
        advisory; customize via a ``CostModel`` on a custom profile
        instead) and the straggler knob from its ``speculative_factor``.
        ``n_points`` must be declared (there or via ``kw``) — silently
        assuming a message size would misprice the transfer side."""
        kw.setdefault("cost_model", pipe.placement_engine.cost)
        kw.setdefault("speculative_factor",
                      pipe._runtime_kw["speculative_factor"])
        if "n_points" not in kw:
            n_points = pipe.context.get("n_points")
            if n_points is None:
                raise ValueError(
                    "advising needs function_context['n_points'] (points "
                    "per message) — transfer costs scale with it")
            kw["n_points"] = int(n_points)
        return cls(n_messages=n_messages, n_devices=pipe.n_edge_devices,
                   n_consumers=pipe.cloud_consumers, **kw)

    def advise(self, model: Union[str, ModelSpec] = "kmeans", *,
               placements: Sequence[str] = PLACEMENTS,
               bands: Optional[Sequence[str]] = None,
               latency_budget: Optional[float] = None,
               wan_budget: Optional[float] = None,
               hybrid_reduce: Optional[Sequence[int]] = None,
               metro_bands: Optional[Sequence[str]] = None
               ) -> AdvisorReport:
        """Sweep {placements} × {bands} (× {hybrid_reduce} for the hybrid
        placement, × {metro_bands} for the fog placement) and rank
        multi-objectively.

        ``metro_bands`` sweeps the edge→fog metro link for fog cells the
        same way WAN bands sweep the cloud hop (names from the profile's
        ``metro_bands`` table); other placements never ride the metro
        hop and are evaluated once per WAN band.  ``latency_budget``
        caps predicted p95 end-to-end latency (seconds); ``wan_budget``
        caps megabytes through the WAN for the whole advisory run.
        Cells violating either are flagged infeasible and rank after
        every feasible cell."""
        # resolve string names against *this advisor's* calibration (a
        # custom cost_model re-prices the specs, not just the tier rates)
        if isinstance(model, str):
            self.cost.model_cost(model)    # unknown name → helpful KeyError
            spec = model_specs(self.cost)[model]
        else:
            spec = model
        # accuracy half of the precision axis: assignment agreement vs
        # the fp32 reference on the fixed probe (deterministic, cached;
        # the plain k-means path on the CPU, so advising needs no card)
        if spec.precision == "fp32":
            agreement = 1.0
        else:
            from repro_torch.ml.kmeans import assignment_agreement
            agreement = assignment_agreement(spec.precision)
        cells: List[Advice] = []
        if bands is None:
            # this cost model's own bands (a custom profile sweeps *its*
            # table), ascending bandwidth rather than lexicographic
            table = self.cost.profile.wan_bands
            bands = sorted(table, key=lambda b: table[b].bandwidth)
        reduces = tuple(int(x) for x in hybrid_reduce or ())
        metros = tuple(metro_bands or ())
        for m in metros:                   # unknown name → helpful error
            if m not in self.cost.profile.metro_bands:
                raise ValueError(
                    f"unknown metro band {m!r}; known: "
                    f"{sorted(self.cost.profile.metro_bands)}")
        # hybrid and fog both pre-aggregate (on the edge vs on the fog
        # tier), so the reduce-factor sweep applies to both placements
        reduced_placements = ("hybrid", "fog")
        for band in bands:
            for placement in placements:
                sweep = reduces if placement in reduced_placements \
                    and reduces else (None,)
                # only the fog placement rides the edge→fog metro hop
                msweep = metros if placement == "fog" and metros \
                    else (None,)
                for red, metro in ((r_, m_) for r_ in sweep
                                   for m_ in msweep):
                    mspec = (spec if red is None
                             else dataclasses.replace(spec,
                                                      hybrid_reduce=red))
                    sc = Scenario(
                        model=mspec, placement=placement, wan_band=band,
                        n_messages=self.n_messages,
                        n_devices=self.n_devices,
                        n_consumers=self.n_consumers,
                        n_points=self.n_points,
                        metro_band=metro,
                        seed=self.seed, service_sigma=self.service_sigma,
                        speculative_factor=self.speculative_factor,
                        cost=self.cost)
                    r = run_scenario(sc)
                    feasible = (
                        (latency_budget is None
                         or r.latency_p95_s <= latency_budget)
                        and (wan_budget is None
                             or r.wan_mbytes <= wan_budget))
                    cells.append(Advice(
                        model=spec.name, placement=placement,
                        tiers=r.tiers,
                        wan_band=band,
                        throughput_msgs_s=r.throughput_msgs_s,
                        latency_mean_s=r.latency_mean_s,
                        latency_p50_s=r.latency_p50_s,
                        latency_p95_s=r.latency_p95_s,
                        latency_p99_s=r.latency_p99_s,
                        wan_mbytes=r.wan_mbytes, wan_bytes=r.wan_bytes,
                        makespan_s=r.makespan_s,
                        hybrid_reduce=(mspec.hybrid_reduce
                                       if placement in reduced_placements
                                       else None),
                        metro_band=metro,
                        feasible=feasible,
                        spec_launches=r.spec_launches,
                        spec_wins=r.spec_wins,
                        spec_losses=r.spec_losses,
                        spec_cancelled=r.spec_cancelled,
                        precision=spec.precision,
                        agreement_vs_fp32=agreement,
                        tier_estimates=dict(r.placement_estimates)))
        return AdvisorReport(model=spec.name, cells=cells,
                             latency_budget=latency_budget,
                             wan_budget=wan_budget)
