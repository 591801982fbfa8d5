"""Fig-3 scenarios: emulated edge-to-cloud pipeline runs — on the *real*
pipeline.  Ported from ``repro.sim.scenarios``; only the import paths
differ.

Each scenario builds a genuine :class:`~repro_torch.core.faas.EdgeToCloudPipeline`
(real ``Broker``/``Topic``/``ConsumerGroup``/``WanShaper``/
``MetricsRegistry``/pilots) and runs it with
``run(scheduler=SimExecutor(...))`` — the single-threaded discrete-event
strategy from :mod:`repro_torch.core.executor`.  There is no harness replica of
the pipeline logic any more: broker offsets, at-least-once redelivery,
dedup, byte accounting, consumer-group rebalances and linked metrics are
the production code paths, only time is virtual.  A sweep of {model} ×
{placement} × {WAN band} that takes hours of real pipeline time (paper
Fig 2/3) replays in milliseconds with bit-reproducible metrics.

Placement modalities (the paper's deployment modalities, §II-C, plus the
continuum's intermediate tier):

* ``cloud``  — raw points cross the WAN; the model runs on the cloud tier.
* ``edge``   — the model runs next to the generator; only the (small)
  model output crosses the WAN.
* ``hybrid`` — an edge pre-aggregation stage shrinks each message by
  ``hybrid_reduce`` before the WAN hop; the model finishes on the cloud.
* ``fog``    — a genuine 3-stage :class:`~repro_torch.core.faas.ContinuumPipeline`:
  raw points ride the edge→fog metro link, the pre-aggregation runs *on
  the fog tier*, and only the reduced message crosses the WAN to the
  cloud model — the per-stage tier vector is ``(edge, fog, cloud)``.

Every scenario row carries its per-stage tier vector
(``ScenarioResult.row()["tiers"]``) so sweeps over arbitrary topologies
stay self-describing.

Cost model: everything is priced by the unified :mod:`repro_torch.cost`
subsystem. ``WAN_BANDS`` below is an import-time snapshot of the shared
:data:`repro_torch.cost.profiles.WAN_BANDS` link table (the same one
``PlacementEngine``'s ``DEFAULT_LINKS`` reads — pinned equal by a
regression test), and the built-in ``ModelSpec``s (``KMEANS`` /
``AUTOENCODER`` / ``ISOFOREST``) are derived from the committed kernel
calibration (:mod:`repro_torch.cost.calibrate`, a copy of the reference
package's measured file), not hand-tuned constants — so emulated
throughput, the engine's ``compare_tiers`` estimates and the
:class:`~repro_torch.cost.advisor.PlacementAdvisor` are all mutually consistent.

``Scenario(service_sigma=...)`` enables the calibrated lognormal
service-time noise (e.g. ``service_sigma=KMEANS.sigma``): stage charges
jitter straggler-realistically but remain bit-reproducible for a seed.

Dynamism scenarios: ``failures`` injects consumer crashes (or silent node
loss the heartbeat monitor must detect) mid-run; ``autoscale`` attaches a
lag-driven :class:`~repro_torch.core.elastic.AutoScaler` to the consuming pilot,
stepped inside the DES, with the consumer pool following its resizes.
"""
from __future__ import annotations

import time as _walltime
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.broker import WanShaper
from repro_torch.core.elastic import AutoScaler, ScalePolicy
from repro_torch.core.executor import SimExecutor
from repro_torch.core.faas import ContinuumPipeline, EdgeToCloudPipeline, StageSpec
from repro_torch.core.monitoring import MetricsRegistry
from repro_torch.core.pilot import ComputeResource, PilotManager
from repro_torch.core.placement import PlacementEngine, TaskProfile
from repro_torch.cost.calibrate import (DEFAULT_GEN_S_PER_POINT,
                                  DEFAULT_HYBRID_REDUCE,
                                  DEFAULT_PREPROCESS_FLOPS_PER_POINT)
from repro_torch.cost.model import INGEST_FLOPS_PER_VALUE, CostModel, \
    default_cost_model
from repro_torch.cost.profiles import WAN_BANDS as _WAN_LINKS
from repro_torch.cost.readvisor import ReAdvisor, ReAdviseSpec
from repro_torch.ml.datagen import N_FEATURES, message_nbytes

# the paper's iPerf band plus the constrained 10 Mbit/s point used for the
# placement-sensitivity experiments; (bandwidth bits/s, RTT seconds) —
# derived from the shared repro_torch.cost.profiles.WAN_BANDS link table
WAN_BANDS: Dict[str, Tuple[float, float]] = {
    name: (link.bandwidth_bps, link.latency_s)
    for name, link in _WAN_LINKS.items()
}

PLACEMENTS = ("edge", "cloud", "hybrid", "fog", "device")


@dataclass(frozen=True)
class ModelSpec:
    """Cost of one processing model, per data point.

    ``flops_per_point`` is *peak-rate-equivalent* work (kernel HLO flops ×
    per-message invocations / achieved efficiency) so service time is
    simply ``flops / tier peak rate``; ``sigma`` is the calibrated
    lognormal service-noise parameter (opt in via
    ``Scenario(service_sigma=spec.sigma)``).
    """
    name: str
    flops_per_point: float          # full model cost (peak-equivalent)
    output_bytes: int               # serialized model output per message
    # edge pre-aggregation defaults shared with ModelCost (defined once,
    # in the cost subsystem)
    hybrid_reduce: int = DEFAULT_HYBRID_REDUCE
    preprocess_flops_per_point: float = DEFAULT_PREPROCESS_FLOPS_PER_POINT
    sigma: float = 0.0              # lognormal service-noise (log-space)
    # kernel precision variant (fp32 | bf16 | int8): model compute is
    # priced at the executing tier's precision-scaled peak rate
    precision: str = "fp32"

    def task_profile(self, n_points: int) -> TaskProfile:
        """The what-the-placement-engine-sees view of one message."""
        return TaskProfile(
            flops=self.flops_per_point * n_points,
            input_bytes=float(message_nbytes(n_points)),
            input_tier="edge",
            output_bytes=float(self.output_bytes),
            output_tier="cloud",
            precision=self.precision)


def model_specs(cost: Optional[CostModel] = None) -> Dict[str, ModelSpec]:
    """Build the scenario ``ModelSpec`` table from a calibration — the
    committed kernel calibration by default."""
    cost = cost or default_cost_model()
    return {
        name: ModelSpec(
            name=name,
            flops_per_point=mc.effective_flops_per_point,
            output_bytes=mc.output_bytes,
            hybrid_reduce=mc.hybrid_reduce,
            preprocess_flops_per_point=mc.preprocess_flops_per_point,
            sigma=mc.sigma,
            precision=mc.precision)
        for name, mc in cost.costs.items()
    }


MODELS: Dict[str, ModelSpec] = model_specs()
# k-means assignment+update is cheap per byte — transfer-bound (paper
# Fig 3 left); the autoencoder (100 PyOD epochs per batch) is expensive
# per byte — compute-bound (Fig 3 right): even the 10 Mbit/s link feeds
# points faster than the cloud tier trains on them; the isolation forest
# sits in between (still transfer-bound).
KMEANS = MODELS["kmeans"]
AUTOENCODER = MODELS["autoencoder"]
ISOFOREST = MODELS["isoforest"]


class ArrivalProcess:
    """Open-loop traffic model: where closed-loop sources produce as fast
    as the pipeline drains (throughput measures the *pipeline*), an
    arrival process pre-draws the absolute times at which messages enter
    the system (traffic intensity is a property of the *workload* — the
    realistic shape for continuum orchestration studies, where bursts
    must genuinely queue).  ``times(n, seed)`` returns ``n`` sorted
    absolute arrival seconds, bit-reproducible for a seed."""

    def times(self, n: int, seed: int) -> np.ndarray:
        raise NotImplementedError

    # -- Lewis–Shedler thinning (shared by the nonhomogeneous processes) --

    def _thin(self, n: int, seed: int, lam_max: float, lam) -> np.ndarray:
        """Draw ``n`` arrivals of a nonhomogeneous Poisson process with
        intensity ``lam(t) <= lam_max`` by thinning a homogeneous
        ``lam_max`` process."""
        rng = np.random.default_rng(seed)
        out = np.empty(n, np.float64)
        t, i = 0.0, 0
        while i < n:
            # batched candidate draws: one rng round-trip per ~4n points
            gaps = rng.exponential(1.0 / lam_max, size=max(n, 1024))
            us = rng.random(size=gaps.shape[0])
            for g, u in zip(gaps, us):
                t += g
                if u * lam_max <= lam(t):
                    out[i] = t
                    i += 1
                    if i == n:
                        break
        return out


@dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson arrivals at ``rate_hz`` (aggregate, across all
    devices): i.i.d. exponential gaps."""
    rate_hz: float

    def __post_init__(self):
        if self.rate_hz <= 0.0:
            raise ValueError("rate_hz must be > 0")

    def times(self, n: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return np.cumsum(rng.exponential(1.0 / self.rate_hz, size=n))


@dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Day/night load curve: intensity swings sinusoidally between
    ``base_rate_hz`` (trough) and ``peak_rate_hz`` over ``period_s``,
    starting at the trough — the survey's canonical diurnal shape."""
    base_rate_hz: float
    peak_rate_hz: float
    period_s: float

    def __post_init__(self):
        if self.base_rate_hz <= 0.0 or self.period_s <= 0.0:
            raise ValueError("base_rate_hz and period_s must be > 0")
        if self.peak_rate_hz < self.base_rate_hz:
            raise ValueError("peak_rate_hz must be >= base_rate_hz")

    def times(self, n: int, seed: int) -> np.ndarray:
        base, peak = self.base_rate_hz, self.peak_rate_hz
        w = 2.0 * np.pi / self.period_s

        def lam(t):
            return base + (peak - base) * 0.5 * (1.0 - np.cos(w * t))

        return self._thin(n, seed, peak, lam)


@dataclass(frozen=True)
class FlashCrowdArrivals(ArrivalProcess):
    """Flash-crowd burst: steady ``base_rate_hz`` background with a
    ``burst_rate_hz`` spike in ``[burst_at_s, burst_at_s +
    burst_duration_s)`` — the traffic shape per-stage autoscaling exists
    for."""
    base_rate_hz: float
    burst_rate_hz: float
    burst_at_s: float
    burst_duration_s: float

    def __post_init__(self):
        if self.base_rate_hz <= 0.0 or self.burst_duration_s <= 0.0 \
                or self.burst_at_s < 0.0:
            raise ValueError("base_rate_hz and burst_duration_s must be "
                             "> 0, burst_at_s >= 0")
        if self.burst_rate_hz < self.base_rate_hz:
            raise ValueError("burst_rate_hz must be >= base_rate_hz")

    def times(self, n: int, seed: int) -> np.ndarray:
        base, burst = self.base_rate_hz, self.burst_rate_hz
        t0, t1 = self.burst_at_s, self.burst_at_s + self.burst_duration_s

        def lam(t):
            return burst if t0 <= t < t1 else base

        return self._thin(n, seed, burst, lam)


@dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Replay of a *recorded* arrival-timestamp trace — production-shaped
    load (Azure-Functions / Google-cluster-style) instead of a synthetic
    process.  File format: one float arrival timestamp (seconds, sorted
    or not) per line; blank lines and ``#`` header/comment lines are
    ignored (the committed example under ``benchmarks/traces/`` carries a
    ``# units=seconds seed=... n=...`` header).  Timestamps are sorted
    and re-based to start at 0.  When more arrivals are requested than
    the trace holds it is extended periodically — each repetition
    shifted by the trace period (last timestamp plus one mean gap) — so
    the recorded burst structure tiles instead of flat-lining.
    ``time_scale`` stretches (>1) or compresses (<1) the recorded
    timeline.  Replay is fully deterministic; ``seed`` is ignored."""
    path: str
    time_scale: float = 1.0

    def __post_init__(self):
        if self.time_scale <= 0.0:
            raise ValueError("time_scale must be > 0")

    def _load(self) -> np.ndarray:
        vals: List[float] = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                vals.append(float(line))
        if not vals:
            raise ValueError(f"trace {self.path!r} holds no timestamps")
        ts = np.sort(np.asarray(vals, np.float64))
        if not np.isfinite(ts).all():
            raise ValueError(f"trace {self.path!r} has non-finite "
                             f"timestamps")
        return ts - ts[0]

    def times(self, n: int, seed: int) -> np.ndarray:
        ts = self._load()
        m = ts.shape[0]
        if n <= m:
            out = ts[:n].copy()
        else:
            # periodic extension: tile the trace, each repetition shifted
            # by its period so the last recorded gap wraps to the first
            period = ts[-1] + (ts[-1] / max(m - 1, 1) if m > 1 else 1.0)
            reps = -(-n // m)
            out = np.concatenate([ts + k * period for k in range(reps)])[:n]
        return out * self.time_scale


def arrival_process(kind: str, rate_hz: float,
                    trace: Optional[str] = None) -> ArrivalProcess:
    """Shared open-loop arrival-process factory (the scale benchmarks,
    the geo benchmark and the sharded DES all build the same processes
    from the same knobs, so their deterministic draws agree): ``poisson``
    at ``rate_hz``; ``diurnal`` swinging rate_hz/4 ↔ rate_hz over a 20 s
    period; ``flash`` with a rate_hz/4 background and a 4×rate_hz burst
    in [2 s, 4 s); ``trace`` replaying the timestamp file at ``trace``."""
    if kind == "poisson":
        return PoissonArrivals(rate_hz=rate_hz)
    if kind == "diurnal":
        return DiurnalArrivals(base_rate_hz=rate_hz / 4.0,
                               peak_rate_hz=rate_hz, period_s=20.0)
    if kind == "flash":
        return FlashCrowdArrivals(base_rate_hz=rate_hz / 4.0,
                                  burst_rate_hz=rate_hz * 4.0,
                                  burst_at_s=2.0, burst_duration_s=2.0)
    if kind == "trace":
        if trace is None:
            raise ValueError("arrival_process('trace', ...) needs trace=")
        return TraceArrivals(path=trace)
    raise ValueError(f"unknown arrival kind {kind!r}")


def arrival_plan(sc: "Scenario") -> Optional[List[np.ndarray]]:
    """The scenario's per-device open-loop arrival plan (None when the
    scenario is closed-loop): one aggregate draw of ``n_messages``
    arrival times, dealt round-robin across the devices — each device's
    stream stays sorted, and the interleaved aggregate reproduces the
    process exactly."""
    if sc.arrival is None:
        return None
    times = sc.arrival.times(sc.n_messages, sc.seed)
    return [times[i::sc.n_devices] for i in range(sc.n_devices)]


@dataclass(frozen=True)
class FailureSpec:
    """Crash consumer ``consumer_idx`` at virtual time ``at_s``; a
    replacement (fresh member id, resuming from committed offsets) joins
    ``restart_after_s`` later unless None.  ``kind="crash"`` raises inside
    the consumer (immediate rebalance); ``kind="silent"`` makes the node
    go dark so only the heartbeat monitor can detect the loss."""
    at_s: float
    consumer_idx: int = 0
    restart_after_s: Optional[float] = 1.0
    kind: str = "crash"             # crash | silent


@dataclass(frozen=True)
class DriftSpec:
    """One mid-run environment drift event, scheduled as an ordinary DES
    event at virtual time ``at_s`` (drifted runs stay bit-identical).

    ``kind="band"``: re-price hop ``hop``'s live link (default: the last
    hop — the WAN crossing).  Name a band via ``band`` (looked up in the
    scenario profile's ``wan_bands``, or ``metro_bands`` when
    ``table="metro"``) or give explicit ``bandwidth_bps``/``rtt_s``.
    ``kind="churn"``: grow (``delta > 0``) or shrink (``delta < 0``)
    ``stage``'s consumer fleet (default: the final stage).
    ``kind="outage"``: every consumer of stages bound to ``tier`` dies
    at once.  ``restore_after_s`` undoes the drift that much later
    (band: old numbers back; churn: reverse delta; outage: same
    head-counts respawn as fresh members)."""
    at_s: float
    kind: str = "band"              # band | churn | outage
    hop: int = -1                   # band: which hop's shaper
    band: Optional[str] = None      # band: name into the band table
    table: str = "wan"              # band-name table: wan | metro
    bandwidth_bps: Optional[float] = None
    rtt_s: Optional[float] = None
    stage: Optional[str] = None     # churn: which consumer stage
    delta: int = 0                  # churn: consumers to add/remove
    tier: Optional[str] = None      # outage: which tier goes dark
    restore_after_s: Optional[float] = None


@dataclass(frozen=True)
class Scenario:
    """One Fig-3 cell.  ``cost`` re-prices tier rates and WAN links; it
    does *not* reach inside ``model`` — when sweeping a custom
    calibration, pair it with a matching spec
    (``model=model_specs(cost)[name]``), as the PlacementAdvisor does."""
    model: ModelSpec = KMEANS                 # calibrated k-means
    placement: str = "cloud"          # edge | cloud | hybrid | fog | device
    wan_band: str = "100mbit"                 # key into WAN_BANDS
    n_messages: int = 64
    n_devices: int = 4                        # edge devices == partitions
    n_consumers: Optional[int] = None         # default: n_devices
    n_fog: Optional[int] = None               # fog-stage tasks (fog only)
    n_points: int = 2_500                     # points per message
    gen_s_per_point: float = DEFAULT_GEN_S_PER_POINT  # Mini-App gen cost
    failures: Tuple[FailureSpec, ...] = ()
    autoscale: Optional[ScalePolicy] = None   # lag-driven resize in the DES
    # per-stage policies: ((stage_name, policy), ...) — every named
    # consumer stage gets its own lag-driven AutoScaler (the final stage
    # may instead/additionally use the legacy `autoscale` knob)
    autoscale_stages: Tuple[Tuple[str, ScalePolicy], ...] = ()
    autoscale_interval_s: float = 0.2
    # open-loop traffic: messages enter at the process's drawn times
    # instead of back-to-back (None = closed-loop; producer boot offsets
    # are then skipped — arrival times already carry the phases)
    arrival: Optional[ArrivalProcess] = None
    seed: int = 0
    t_max_s: float = 36_000.0                 # virtual-time safety cap
    # lognormal stage noise: 0 = off (the noise-free Fig-3 pins),
    # None = the model's *calibrated* sigma from calibration.json (what
    # the tail-aware PlacementAdvisor runs with)
    service_sigma: Optional[float] = 0.0
    # straggler speculation: a cloud/edge Service charge running past
    # factor × trailing median spawns a backup, first completion wins
    # (0 = off; mirrors TaskRuntime.speculative_factor under the DES)
    speculative_factor: float = 0.0
    cost: Optional[CostModel] = None          # default: shared calibration
    # mid-run environment drift (band degradation / churn / outage),
    # applied by the SimExecutor as ordinary scheduled events
    drift: Tuple[DriftSpec, ...] = ()
    # online re-advisory: watch the named stage's observed hop delay and
    # hot-swap its placement when the ranking flips beyond hysteresis
    readvise: Optional[ReAdviseSpec] = None
    # edge→fog metro band (key into the profile's metro_bands); None =
    # the profile default — makes the fog hop sweepable like WAN bands
    metro_band: Optional[str] = None

    @property
    def cost_model(self) -> CostModel:
        cm = self.cost or default_cost_model()
        if self.metro_band is not None:
            cm = cm.with_metro(self.metro_band)
        return cm

    @property
    def effective_service_sigma(self) -> float:
        """The sigma actually applied: explicit value, or the model's
        calibrated one when ``service_sigma`` is None."""
        return (self.model.sigma if self.service_sigma is None
                else self.service_sigma)

    def label(self) -> str:
        return (f"{self.model.name}/{self.placement}/{self.wan_band}"
                f"{'/fail' if self.failures else ''}"
                f"{'/autoscale' if self.autoscale or self.autoscale_stages else ''}"
                f"{'/open-loop' if self.arrival else ''}"
                f"{'/drift' if self.drift else ''}"
                f"{'/readvise' if self.readvise else ''}")


@dataclass
class ScenarioResult:
    scenario: Scenario
    n_processed: int
    n_duplicates: int
    makespan_s: float                 # virtual seconds, first gen → last done
    throughput_msgs_s: float
    latency_mean_s: float
    latency_p95_s: float
    wan_mbytes: float
    placement_estimates: Dict[str, float]     # PlacementEngine per-tier est.
    autoscale_events: List[dict] = field(default_factory=list)
    wall_ms: float = 0.0              # real milliseconds spent emulating
    metrics: MetricsRegistry = field(default=None, repr=False)
    latency_p50_s: float = 0.0        # tail decomposition (multi-objective)
    latency_p99_s: float = 0.0
    wan_bytes: float = 0.0            # exact bytes through the topic
    # per-stage execution tier vector, read off the *built* pipeline's
    # pilots (the one source of truth — never a per-placement literal)
    tiers: Tuple[str, ...] = ()
    spec_launches: int = 0            # straggler speculation accounting
    spec_wins: int = 0                # (wins + losses + cancelled == launches)
    spec_losses: int = 0
    spec_cancelled: int = 0
    # online re-advisory: one entry per applied hot-swap, with virtual
    # decision/apply timestamps (deterministic columns)
    swaps: List[dict] = field(default_factory=list)
    drift_events: int = 0             # drift events injected into the run

    def row(self) -> Dict[str, object]:
        """Deterministic summary — identical across runs at the same seed
        (``wall_ms`` is wall time and deliberately excluded)."""
        s = self.scenario
        return {
            "model": s.model.name, "placement": s.placement,
            "tiers": list(self.tiers),
            "wan": s.wan_band, "messages": s.n_messages,
            "processed": self.n_processed, "dups": self.n_duplicates,
            "makespan_s": self.makespan_s,
            "msgs_per_s": self.throughput_msgs_s,
            "lat_mean_s": self.latency_mean_s,
            "lat_p50_s": self.latency_p50_s,
            "lat_p95_s": self.latency_p95_s,
            "lat_p99_s": self.latency_p99_s,
            "wan_mb": self.wan_mbytes,
            "wan_bytes": self.wan_bytes,
            "autoscale_actions": len(self.autoscale_events),
            "spec_launches": self.spec_launches,
            "spec_wins": self.spec_wins,
            "spec_losses": self.spec_losses,
            "spec_cancelled": self.spec_cancelled,
            "drift_events": self.drift_events,
            "swaps": [dict(s) for s in self.swaps],
        }


def _edge_compute_s(sc: Scenario) -> float:
    """Per-message edge-stage service time for the scenario's placement."""
    m = sc.model
    if sc.placement == "edge":
        return sc.cost_model.compute_s(m.flops_per_point * sc.n_points,
                                       "edge", precision=m.precision)
    if sc.placement == "hybrid":
        return sc.cost_model.compute_s(
            m.preprocess_flops_per_point * sc.n_points, "edge")
    return 0.0


def _fog_compute_s(sc: Scenario) -> float:
    """Per-message fog-stage service time (pre-aggregation on the fog
    tier; fog placement only)."""
    return sc.cost_model.compute_s(
        sc.model.preprocess_flops_per_point * sc.n_points, "fog")


def _device_compute_s(sc: Scenario) -> float:
    """Per-message device-stage service time: the full model on the
    sensing SoC, priced at the SoC's peak for the model's kernel
    precision — the fp32-infeasible / int8-feasible split the precision
    placement axis exists for."""
    m = sc.model
    return sc.cost_model.compute_s(m.flops_per_point * sc.n_points,
                                   "device", precision=m.precision)


def _cloud_compute_s(sc: Scenario) -> float:
    """Per-message cloud-stage service time (one consumer slot)."""
    m = sc.model
    if sc.placement in ("edge", "device"):
        # results only need ingesting/merging on the cloud side
        return sc.cost_model.ingest_bytes_s(m.output_bytes, "cloud")
    points = sc.n_points if sc.placement == "cloud" \
        else max(sc.n_points // m.hybrid_reduce, 1)
    return sc.cost_model.compute_s(m.flops_per_point * points, "cloud",
                                   precision=m.precision)


def _reduced_payload(sc: Scenario) -> np.ndarray:
    return np.zeros((max(sc.n_points // sc.model.hybrid_reduce, 1),
                     N_FEATURES), np.float64)


def _output_payload(sc: Scenario) -> np.ndarray:
    return np.zeros(max(sc.model.output_bytes // 8, 1), np.float64)


def _payload(sc: Scenario) -> np.ndarray:
    """What the *source* stage puts on its first broker hop (real numpy
    serialization, so byte accounting is exact): edge placement publishes
    only the model output, hybrid the edge-reduced message, cloud and fog
    the raw points (fog reduces downstream, on the fog tier); device
    placement's first hop is the on-device handoff of the raw points to
    the SoC's model stage (the WAN only ever sees the model output)."""
    if sc.placement == "edge":
        return _output_payload(sc)
    if sc.placement == "hybrid":
        return _reduced_payload(sc)
    return np.zeros((sc.n_points, N_FEATURES), np.float64)


def _service_model(sc: Scenario):
    """Stage → virtual service seconds, priced by the shared CostModel
    (optionally with the calibrated lognormal noise)."""
    produce_s = sc.gen_s_per_point * sc.n_points + _edge_compute_s(sc)
    stages = {"produce": produce_s, "process_cloud": _cloud_compute_s(sc)}
    if sc.placement == "fog":
        stages["process_fog"] = _fog_compute_s(sc)
    if sc.placement == "device":
        stages["process_device"] = _device_compute_s(sc)
    return sc.cost_model.service_model(
        stages, sigma=sc.effective_service_sigma, seed=sc.seed)


def _stage_flops(sc: Scenario, stage: str) -> float:
    """Per-message FLOPs of a consumer stage, tier-independent — the
    tier-aware service model (and the ReAdvisor's scoring) price these at
    whatever tier the stage is bound to *at charge time*."""
    m = sc.model
    if stage == "process_fog":
        return m.preprocess_flops_per_point * sc.n_points
    if stage == "process_device":
        return m.flops_per_point * sc.n_points
    if stage != "process_cloud":
        raise ValueError(f"no per-message FLOPs known for stage {stage!r}")
    if sc.placement in ("edge", "device"):
        # only the published model output needs ingesting/merging
        return (m.output_bytes / 8.0) * INGEST_FLOPS_PER_VALUE
    points = sc.n_points if sc.placement == "cloud" \
        else max(sc.n_points // m.hybrid_reduce, 1)
    return m.flops_per_point * points


def _stage_precision(sc: Scenario, stage: str) -> str:
    """Kernel precision a stage's FLOPs run at: the model's calibrated
    precision wherever the stage executes the model itself; fp32 for
    pre-aggregation and output-ingest stages."""
    if stage == "process_device":
        return sc.model.precision
    if stage == "process_cloud" and sc.placement not in ("edge", "device"):
        return sc.model.precision
    return "fp32"


def _readvise_service_model(sc: Scenario, pipe):
    """Service model for re-advised runs: the watched stage's FLOPs are
    priced at its *live* pilot's tier at charge time, so a hot-swap
    re-prices service with no model rebuild; every other stage keeps its
    fixed pre-priced time from :func:`_service_model`."""
    name = sc.readvise.stage
    names = [s.name for s in pipe.stages]
    try:
        idx = names.index(name)
    except ValueError:
        raise ValueError(f"readvise stage {name!r} not in pipeline "
                         f"stages {names}") from None
    if idx == 0:
        raise ValueError("cannot re-advise stage 0 (the sources)")
    fixed = _service_model(sc)
    tiered = sc.cost_model.tier_service_model(
        {name: _stage_flops(sc, name)},
        resolve=lambda stage: (pipe.stages[idx].pilot.tier, 1),
        sigma=sc.effective_service_sigma, seed=sc.seed,
        stage_precision={name: _stage_precision(sc, name)})

    def model(stage, ctx, payload):
        if stage == name:
            return tiered(stage, ctx, payload)
        return fixed(stage, ctx, payload)

    return model


def _resolve_drift(sc: Scenario) -> Tuple[DriftSpec, ...]:
    """Fill band-name drift events with concrete numbers from the
    scenario profile's band tables (the executor applies numbers, not
    names) — unknown names/tables fail at build time, not mid-run."""
    out = []
    prof = sc.cost_model.profile
    for d in sc.drift:
        if d.kind == "band" and d.band is not None:
            if d.table == "wan":
                table = prof.wan_bands
            elif d.table == "metro":
                table = prof.metro_bands
            else:
                raise ValueError(f"unknown drift band table {d.table!r}; "
                                 f"known: wan, metro")
            if d.band not in table:
                raise ValueError(f"unknown {d.table} band {d.band!r}; "
                                 f"known: {sorted(table)}")
            link = table[d.band]
            d = _dc_replace(d, bandwidth_bps=link.bandwidth_bps,
                            rtt_s=link.latency_s)
        out.append(d)
    return tuple(out)


def _wan_link(sc: Scenario):
    """The scenario's WAN band from *its* cost model's profile (a custom
    ContinuumProfile re-prices the transfer side too, not just compute)."""
    bands = sc.cost_model.profile.wan_bands
    if sc.wan_band not in bands:
        raise ValueError(f"unknown wan_band {sc.wan_band!r}; "
                         f"known: {sorted(bands)}")
    return bands[sc.wan_band]


def placement_estimates(sc: Scenario) -> Dict[str, float]:
    """PlacementEngine per-tier completion-time estimates for one message
    of this scenario, priced over this scenario's WAN band — the full
    tier set (device, edge, fog, cloud), so the analytic view ranks the
    same candidates the DES sweeps.  The device estimate runs at the
    SoC's precision-scaled peak (``TaskProfile.precision``)."""
    wan = _wan_link(sc)
    links = {("edge", "cloud"): wan, ("edge", "hpc"): wan,
             ("fog", "cloud"): wan}
    eng = PlacementEngine(links=links, cost_model=sc.cost_model)
    mgr = PilotManager(devices=())
    device = mgr.submit_pilot(ComputeResource(tier="device",
                                              n_workers=sc.n_devices))
    edge = mgr.submit_pilot(ComputeResource(tier="edge",
                                            n_workers=sc.n_devices))
    fog = mgr.submit_pilot(ComputeResource(
        tier="fog", n_workers=sc.n_fog or sc.n_devices))
    n_cons = sc.n_consumers or sc.n_devices
    cloud = mgr.submit_pilot(ComputeResource(tier="cloud",
                                             n_workers=n_cons))
    return eng.compare_tiers(sc.model.task_profile(sc.n_points),
                             [device, edge, fog, cloud])


def build_pipeline(sc: Scenario):
    """Construct the genuine pipeline + SimExecutor for one scenario.
    Returns ``(pipeline, executor, manager)`` — run with
    ``pipeline.run(n_messages=sc.n_messages, scheduler=executor)``.

    ``edge``/``cloud``/``hybrid`` build the two-stage
    :class:`EdgeToCloudPipeline` wrapper; ``fog`` builds a genuine
    3-stage :class:`ContinuumPipeline` (edge → fog → cloud) whose first
    hop rides the edge→fog metro link and whose second hop rides the
    scenario's WAN band; ``device`` builds a 3-stage pipeline whose
    first hop is the on-device handoff (raw points over the device
    tier's intra link) into the SoC model stage, and whose second hop
    ships only the model output over the WAN."""
    from repro_torch.sim.clock import SimClock
    if sc.placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}")
    wan = _wan_link(sc)
    clock = SimClock()
    metrics = MetricsRegistry(clock=clock)
    mgr = PilotManager(devices=(), clock=clock)
    edge = mgr.submit_pilot(ComputeResource(tier="edge",
                                            n_workers=sc.n_devices))
    n_cons = sc.n_consumers or sc.n_devices
    cloud = mgr.submit_pilot(ComputeResource(tier="cloud",
                                             n_workers=n_cons))
    bw_bps, rtt = wan.bandwidth_bps, wan.latency_s
    payload = _payload(sc)
    # band-true pricing view: the pipeline's engine (what rebind_stage
    # re-prices hop shapers with) and the ReAdvisor's predictions both
    # route edge->cloud over *this scenario's* WAN band
    band_cost = sc.cost_model.with_wan(sc.wan_band)
    engine = PlacementEngine(cost_model=band_cost)
    # service times are priced by the service model, not heartbeats;
    # only explicit "silent" failure injection should trip the monitor
    heartbeat_s = (30.0 if any(f.kind == "silent" for f in sc.failures)
                   else sc.t_max_s)
    wan_shaper = WanShaper(bandwidth_bps=bw_bps, rtt_s=rtt, sleep=False)
    if sc.placement == "fog":
        fog = mgr.submit_pilot(ComputeResource(
            tier="fog", n_workers=sc.n_fog or sc.n_devices))
        metro = sc.cost_model.profile.link("edge", "fog")
        reduced = _reduced_payload(sc)
        pipe = ContinuumPipeline(
            stages=[
                StageSpec("produce", lambda ctx: payload,
                          pilot=edge, n_tasks=sc.n_devices),
                StageSpec("process_fog",
                          lambda ctx, data=None: reduced, pilot=fog,
                          n_tasks=sc.n_fog or sc.n_devices),
                StageSpec("process_cloud",
                          lambda ctx, data=None: None, pilot=cloud,
                          n_tasks=n_cons),
            ],
            n_partitions=sc.n_devices, topic_name="e2c",
            shapers=[WanShaper(bandwidth_bps=metro.bandwidth_bps,
                               rtt_s=metro.latency_s, sleep=False),
                     wan_shaper],
            metrics=metrics, clock=clock,
            placement_engine=engine,
            speculative_factor=sc.speculative_factor,
            heartbeat_timeout_s=heartbeat_s)
    elif sc.placement == "device":
        device = mgr.submit_pilot(ComputeResource(
            tier="device", n_workers=sc.n_devices))
        intra = sc.cost_model.profile.tier("device").intra_link
        out_payload = _output_payload(sc)
        pipe = ContinuumPipeline(
            stages=[
                StageSpec("produce", lambda ctx: payload,
                          pilot=device, n_tasks=sc.n_devices),
                StageSpec("process_device",
                          lambda ctx, data=None: out_payload,
                          pilot=device, n_tasks=sc.n_devices),
                StageSpec("process_cloud",
                          lambda ctx, data=None: None, pilot=cloud,
                          n_tasks=n_cons),
            ],
            n_partitions=sc.n_devices, topic_name="e2c",
            shapers=[WanShaper(bandwidth_bps=intra.bandwidth_bps,
                               rtt_s=intra.latency_s, sleep=False),
                     wan_shaper],
            metrics=metrics, clock=clock,
            placement_engine=engine,
            speculative_factor=sc.speculative_factor,
            heartbeat_timeout_s=heartbeat_s)
    else:
        pipe = EdgeToCloudPipeline(
            pilot_cloud_processing=cloud, pilot_edge=edge,
            produce_function_handler=lambda ctx: payload,
            process_cloud_function_handler=lambda ctx, data=None: None,
            n_edge_devices=sc.n_devices, n_partitions=sc.n_devices,
            cloud_consumers=n_cons, topic_name="e2c",
            wan_shaper=wan_shaper,
            metrics=metrics, clock=clock, placement_engine=engine,
            speculative_factor=sc.speculative_factor,
            heartbeat_timeout_s=heartbeat_s)
    scaler = None
    if sc.autoscale is not None:
        scaler = AutoScaler(mgr, cloud, lag_fn=pipe.current_lag,
                            policy=sc.autoscale, metrics=metrics,
                            interval_s=sc.autoscale_interval_s, clock=clock)
    # per-stage policies: each named consumer stage gets its own scaler
    # watching *its* group's lag and resizing *its* pilot
    stage_names = [s.name for s in pipe.stages]
    scalers = {}
    for name, policy in sc.autoscale_stages:
        si = stage_names.index(name)
        scalers[name] = AutoScaler(
            mgr, pipe.stages[si].pilot,
            lag_fn=(lambda i=si: pipe.stage_lag(i)),
            policy=policy, metrics=metrics,
            interval_s=sc.autoscale_interval_s, clock=clock)
    if sc.arrival is not None:
        # open loop: the drawn arrival times carry the device phases
        offsets = []
    else:
        # deterministic per-device phase offsets (devices don't boot in
        # lockstep), drawn in device order from the seeded rng
        rng = np.random.default_rng(sc.seed)
        gen_s = sc.gen_s_per_point * sc.n_points
        offsets = [float(rng.uniform(0.0, gen_s + 1e-9))
                   for _ in range(sc.n_devices)]
    # online re-advisory: build the watcher over the scenario's (band-
    # adjusted) cost model with one pilot per candidate tier — existing
    # pilots are reused, missing tiers get a fresh consumer-sized pilot
    rv = None
    if sc.readvise is not None:
        spec = sc.readvise
        pilots = {"edge": edge, "cloud": cloud}
        if sc.placement == "fog":
            pilots["fog"] = fog
        elif sc.placement == "device":
            pilots["device"] = device
        targets = {}
        for tier in spec.targets:
            if tier not in pilots:
                pilots[tier] = mgr.submit_pilot(ComputeResource(
                    tier=tier, n_workers=n_cons))
            targets[tier] = pilots[tier]
        rv = ReAdvisor(band_cost, stage=spec.stage,
                       flops=_stage_flops(sc, spec.stage),
                       targets=targets, interval_s=spec.interval_s,
                       hysteresis=spec.hysteresis,
                       min_samples=spec.min_samples,
                       cooldown_s=spec.cooldown_s,
                       max_swaps=spec.max_swaps,
                       apply_delay_s=spec.apply_delay_s)
    service = (_readvise_service_model(sc, pipe) if rv is not None
               else _service_model(sc))
    ex = SimExecutor(clock=clock, service_model=service,
                     producer_offsets=offsets, crash_plan=sc.failures,
                     autoscaler=scaler, autoscalers=scalers,
                     autoscale_interval_s=sc.autoscale_interval_s,
                     drift_plan=_resolve_drift(sc), readvisor=rv)
    return pipe, ex, mgr


def run_scenario(sc: Scenario) -> ScenarioResult:
    """Emulate one scenario to completion on the real pipeline; returns
    deterministic metrics."""
    t_wall = _walltime.perf_counter()
    pipe, ex, _ = build_pipeline(sc)
    plan = arrival_plan(sc)
    if plan is not None:
        res = pipe.run(timeout_s=sc.t_max_s, collect_results=False,
                       scheduler=ex, arrival_plan=plan)
    else:
        res = pipe.run(n_messages=sc.n_messages, timeout_s=sc.t_max_s,
                       collect_results=False, scheduler=ex)
    metrics = res.metrics

    lat = metrics.latencies("produced", "processed")
    lat.sort()
    first = metrics.first_stamp("produced") or 0.0
    last = metrics.last_stamp("processed") or 0.0
    makespan = max(last - first, 1e-9)
    n_done = res.n_processed
    histories: List[dict] = []
    if ex.autoscaler is not None:
        histories.extend(ex.autoscaler.history)
    for s in ex.autoscalers.values():
        histories.extend(s.history)

    def pct(q):
        return lat[min(len(lat) - 1, int(q * len(lat)))] if lat else 0.0

    # the hop that enters the cloud tier is the WAN crossing in every
    # placement (fog's first hop is the metro link, not WAN)
    wan_bytes = metrics.counter(f"topic.{pipe._topics[-1].name}.bytes_in")
    return ScenarioResult(
        scenario=sc,
        tiers=tuple(pipe.stage_tiers),
        n_processed=n_done,
        n_duplicates=int(metrics.counter("pipeline.duplicates_dropped")),
        makespan_s=makespan,
        throughput_msgs_s=n_done / makespan,
        latency_mean_s=float(np.mean(lat)) if lat else 0.0,
        latency_p50_s=pct(0.50),
        latency_p95_s=pct(0.95),
        latency_p99_s=pct(0.99),
        wan_mbytes=wan_bytes / 1e6,
        wan_bytes=wan_bytes,
        spec_launches=int(metrics.counter("runtime.speculative_launches")),
        spec_wins=int(metrics.counter("runtime.speculative_wins")),
        spec_losses=int(metrics.counter("runtime.speculative_losses")),
        spec_cancelled=int(metrics.counter("runtime.speculative_cancelled")),
        placement_estimates=placement_estimates(sc),
        autoscale_events=histories,
        swaps=(list(ex.readvisor.swap_log)
               if ex.readvisor is not None else []),
        drift_events=len(sc.drift),
        wall_ms=(_walltime.perf_counter() - t_wall) * 1e3,
        metrics=metrics)


def sweep(models: Sequence[ModelSpec] = (KMEANS, AUTOENCODER),
          placements: Sequence[str] = PLACEMENTS,
          bands: Sequence[str] = ("10mbit", "50mbit", "100mbit"),
          *, n_messages: int = 64, n_devices: int = 4,
          n_points: int = 2_500, seed: int = 0,
          failures: Tuple[FailureSpec, ...] = (),
          service_sigma: Optional[float] = 0.0,
          speculative_factor: float = 0.0) -> List[ScenarioResult]:
    """The Fig-3 grid: {models} × {placements} × {WAN bands}."""
    out = []
    for m in models:
        for p in placements:
            for b in bands:
                out.append(run_scenario(Scenario(
                    model=m, placement=p, wan_band=b,
                    n_messages=n_messages, n_devices=n_devices,
                    n_points=n_points, seed=seed, failures=failures,
                    service_sigma=service_sigma,
                    speculative_factor=speculative_factor)))
    return out


def format_table(results: Sequence[ScenarioResult]) -> str:
    """The paper's throughput/latency trade-off table."""
    hdr = (f"{'model':>12} {'placement':>9} {'wan':>8} {'done':>5} "
           f"{'dups':>4} {'msg/s':>9} {'lat-mean s':>10} {'lat-p95 s':>9} "
           f"{'WAN MB':>8} {'wall ms':>8}")
    lines = [hdr, "-" * len(hdr)]
    for r in results:
        s = r.scenario
        lines.append(
            f"{s.model.name:>12} {s.placement:>9} {s.wan_band:>8} "
            f"{r.n_processed:>5} {r.n_duplicates:>4} "
            f"{r.throughput_msgs_s:>9.3f} {r.latency_mean_s:>10.3f} "
            f"{r.latency_p95_s:>9.3f} {r.wan_mbytes:>8.2f} "
            f"{r.wall_ms:>8.1f}")
    return "\n".join(lines)
