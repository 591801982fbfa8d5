"""Online re-advisory: watch a live run, hot-swap placement under drift.

The :class:`~repro_torch.cost.advisor.PlacementAdvisor` ranks placements
*before* a run; this module closes the loop **during** one (ROADMAP item
3's dynamic half).  A :class:`ReAdvisor` periodically compares the
*observed* shaped-hop delay of a watched stage — the
``topic.<name>.wan_delay_s`` / ``msgs_in`` counters the broker stamps on
every shaped produce — against the :class:`~repro_torch.cost.model.CostModel`
prediction for every candidate tier, and when the observed ranking flips
beyond a hysteresis tolerance it emits a swap decision.  The executors
apply it live: :meth:`~repro_torch.core.faas.ContinuumPipeline.rebind_stage`
re-binds the stage's pilot and re-prices the adjacent hop shapers, then
the stage's consumer fleet migrates epoch-wise (old members drain out at
their next loop top, a same-size replacement fleet spawns on the new
pilot), with the hop's at-least-once + dedup machinery covering the
hand-off window.

Scoring (per candidate tier ``T``, all per-message means over the last
tick window)::

    pred(T) = serialize(mean_bytes, src->T) + latency(src->T)/2
              + compute(flops, T, fleet_workers)
    score(current) uses max(observed_hop_delay, predicted_hop) instead
    of the predicted hop — observation only ever *raises* the current
    tier's cost (queueing under a degraded band), never lowers it below
    the physical floor.

A swap fires only when ``score(current) > hysteresis × score(best)`` —
within tolerance the advisor stays quiet (the hysteresis property the
chaos suite pins), and ``cooldown_s`` / ``max_swaps`` stop flapping.
Under the single-threaded SimExecutor every tick reads deterministic
counters at deterministic virtual times, so decision and swap timestamps
are bit-identical run to run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple


@dataclass(frozen=True)
class ReAdviseSpec:
    """Scenario-level re-advisory knobs (what ``Scenario.readvise``
    carries); :func:`repro_torch.sim.scenarios.build_pipeline` turns it into a
    live :class:`ReAdvisor` with the scenario's cost model and pilots.

    ``targets`` are candidate tiers for the watched stage (the current
    tier is always scored, listed or not).  ``min_samples`` is the
    per-window observation floor — fewer shaped messages than that in a
    tick window and the advisor abstains (no decision from noise).
    """
    stage: str = "process_cloud"
    targets: Tuple[str, ...] = ("cloud", "fog")
    interval_s: float = 0.25
    hysteresis: float = 1.5
    min_samples: int = 8
    cooldown_s: float = 1.0
    max_swaps: int = 1
    apply_delay_s: float = 0.05


@dataclass
class SwapDecision:
    """One re-advisory verdict: move ``stage`` from ``from_tier`` to
    ``to_tier``.  ``scores`` holds the per-tier effective seconds the
    ranking was decided on; ``t_applied`` is stamped by the executor
    when the migration actually lands (``apply_delay_s`` later)."""
    stage: str
    from_tier: str
    to_tier: str
    t_decided: float
    observed_hop_s: float
    scores: Dict[str, float] = field(default_factory=dict)
    t_applied: Optional[float] = None


class ReAdvisor:
    """Watch one stage's observed hop delay; decide placement hot-swaps.

    Parameters
    ----------
    cost: the :class:`~repro_torch.cost.model.CostModel` predictions are priced
        against (band-adjusted — the same model the run's service pricing
        uses).
    stage: name of the watched (consumer) stage.
    flops: per-message work of the watched stage, priced per candidate
        tier at that tier's fleet rate.
    targets: candidate tier -> :class:`~repro_torch.core.pilot.Pilot` to re-bind
        onto; the decision's ``pilot_for(to_tier)`` hands it to
        ``rebind_stage``.
    Remaining knobs match :class:`ReAdviseSpec`.
    """

    def __init__(self, cost, *, stage: str, flops: float,
                 targets: Mapping[str, Any],
                 interval_s: float = 0.25, hysteresis: float = 1.5,
                 min_samples: int = 8, cooldown_s: float = 1.0,
                 max_swaps: int = 1, apply_delay_s: float = 0.05):
        if hysteresis < 1.0:
            raise ValueError(f"hysteresis must be >= 1.0 (a factor), "
                             f"got {hysteresis}")
        if not targets:
            raise ValueError("readvisor needs at least one target tier")
        self.cost = cost
        self.stage = stage
        self.flops = float(flops)
        self.targets: Dict[str, Any] = dict(targets)
        self.interval_s = float(interval_s)
        self.hysteresis = float(hysteresis)
        self.min_samples = int(min_samples)
        self.cooldown_s = float(cooldown_s)
        self.max_swaps = int(max_swaps)
        self.apply_delay_s = float(apply_delay_s)
        self.swap_log: List[dict] = []
        self.decisions: List[SwapDecision] = []
        self._last: Dict[str, float] = {}
        self._cooldown_until = 0.0
        self._swaps = 0

    # -- lifecycle ---------------------------------------------------------

    def begin(self, t0: float) -> None:
        """Reset window state at run start (executors call this)."""
        self._last = {"msgs": 0.0, "delay": 0.0, "bytes": 0.0}
        self._cooldown_until = t0
        self._swaps = 0
        self.swap_log = []
        self.decisions = []

    def pilot_for(self, tier: str):
        return self.targets[tier]

    def applied(self, dec: SwapDecision, t: float) -> None:
        """Executor callback: the migration landed at clock time ``t``."""
        dec.t_applied = t
        self._cooldown_until = t + self.cooldown_s
        self.swap_log.append({
            "stage": dec.stage, "from": dec.from_tier, "to": dec.to_tier,
            "t_decided": dec.t_decided, "t_applied": t,
            "observed_hop_s": dec.observed_hop_s,
        })

    # -- scoring -----------------------------------------------------------

    def _hop_pred_s(self, src_tier: str, tier: str,
                    mean_bytes: float) -> float:
        """Predicted per-message shaped-hop delay src->tier: serialization
        at the routed link's bandwidth plus half the round trip — exactly
        what :class:`~repro_torch.core.broker.WanShaper` charges (sans queueing,
        which only observation can reveal)."""
        if src_tier == tier:
            return 0.0
        link = self.cost.route(src_tier, tier).as_link()
        return mean_bytes * 8.0 / link.bandwidth_bps + link.latency_s / 2.0

    def scores(self, *, src_tier: str, current_tier: str,
               mean_bytes: float, observed_hop_s: float
               ) -> Dict[str, float]:
        """Effective per-message seconds for every candidate tier (and
        the current one).  The current tier is scored on
        ``max(observed, predicted)`` — a degraded band shows up as
        queueing the prediction can't see; an unshaped or warming-up hop
        falls back to the physical prediction."""
        out: Dict[str, float] = {}
        for tier, pilot in self.targets.items():
            workers = pilot.resource.n_workers
            pred = self._hop_pred_s(src_tier, tier, mean_bytes)
            if tier == current_tier:
                pred = max(observed_hop_s, pred)
            out[tier] = pred + self.cost.compute_s(self.flops, tier,
                                                   workers)
        if current_tier not in out:
            # the current binding is always in the ranking, even when it
            # is not a re-bind candidate
            pred = max(observed_hop_s,
                       self._hop_pred_s(src_tier, current_tier,
                                        mean_bytes))
            out[current_tier] = pred + self.cost.compute_s(
                self.flops, current_tier, 1)
        return out

    def step(self, *, now: float, metrics, topic: str, current_tier: str,
             src_tier: str) -> Optional[SwapDecision]:
        """One observation tick.  Reads the watched hop topic's produce
        counters, diffs them against the previous tick (the window), and
        returns a :class:`SwapDecision` when the ranking flips beyond
        hysteresis — else ``None``.  Counters advance every tick whether
        or not a decision fires, so each window is disjoint."""
        msgs = metrics.counter(f"topic.{topic}.msgs_in")
        delay = metrics.counter(f"topic.{topic}.wan_delay_s")
        nbytes = metrics.counter(f"topic.{topic}.bytes_in")
        last = self._last
        d_msgs = msgs - last["msgs"]
        d_delay = delay - last["delay"]
        d_bytes = nbytes - last["bytes"]
        last["msgs"], last["delay"], last["bytes"] = msgs, delay, nbytes
        if d_msgs < self.min_samples:
            return None
        if self._swaps >= self.max_swaps or now < self._cooldown_until:
            return None
        mean_delay = d_delay / d_msgs
        mean_bytes = d_bytes / d_msgs
        sc = self.scores(src_tier=src_tier, current_tier=current_tier,
                         mean_bytes=mean_bytes,
                         observed_hop_s=mean_delay)
        best = min(sc, key=lambda t: (sc[t], t))
        if best == current_tier or best not in self.targets:
            return None
        if sc[current_tier] <= self.hysteresis * sc[best]:
            return None                      # within tolerance: stay put
        dec = SwapDecision(stage=self.stage, from_tier=current_tier,
                           to_tier=best, t_decided=now,
                           observed_hop_s=mean_delay, scores=sc)
        # the budget is spent at decision time (not apply time) so ticks
        # landing inside the apply delay can't emit duplicate decisions
        self._swaps += 1
        self._cooldown_until = now + self.cooldown_s
        self.decisions.append(dec)
        return dec
