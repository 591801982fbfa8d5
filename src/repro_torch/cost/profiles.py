"""Continuum hardware profiles — the single source of truth for every
device / tier / link parameter in the repo.

Before this subsystem existed the cost knowledge was triplicated:
``core/placement.py`` hardcoded ``EDGE_FLOPS``/``DEVICE_FLOPS``/
``DEFAULT_LINKS``, ``sim/scenarios.py`` hardcoded its own ``WAN_BANDS``
(with drifted latencies), and ``roofline/`` measured real HLO costs that
nothing consumed.  Now:

* :class:`DeviceProfile` — one device's sustained peak rates (the paper's
  testbed: sensor-class devices, RasPi-4-class edge nodes, fog gateways,
  EC2-class cloud workers),
* :class:`TierProfile` — a continuum tier (device / edge / fog / cloud /
  hpc) backed by a device profile plus its intra-tier link,
* :class:`LinkModel`  — bandwidth (bytes/s) + latency between tiers,
* :class:`Topology`   — the tier *graph*: tiers as nodes, links as edges,
  deterministic shortest-time multi-hop routing (:class:`Route`) with
  per-hop latency accumulation,
* :data:`WAN_BANDS`   — the paper's iPerf bands as the one shared link
  table (``sim.scenarios.WAN_BANDS`` and ``core.placement.DEFAULT_LINKS``
  are both import-time snapshots of the default continuum instance —
  pinned equal by a regression test),
* :class:`ContinuumProfile` — the assembled continuum the
  :class:`~repro_torch.cost.model.CostModel` prices against.  The default
  instance is the 4-tier device/edge/fog/cloud continuum (plus the hpc
  accounting tier): transfers between tiers without a direct link ride
  the topology's routed multi-hop path.

Per-model compute costs (FLOPs/point, efficiencies, service-time noise)
live next door in :mod:`repro_torch.cost.calibrate` — measured from the compiled
``repro_torch.ml`` kernels, not asserted.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Mapping, Optional, Tuple


@dataclass(frozen=True)
class LinkModel:
    """Bandwidth (bytes/s) + latency between tiers."""
    bandwidth: float
    latency_s: float = 0.0

    @property
    def bandwidth_bps(self) -> float:
        """Bandwidth in bits/s (the WanShaper's unit)."""
        return self.bandwidth * 8.0


# The paper's iPerf WAN bands (§III, Fig 2/3): bandwidth is stored in
# bytes/s (LinkModel's unit); ``.bandwidth_bps`` recovers the bits/s the
# WanShaper wants. The constrained 10 Mbit/s point is the band the
# placement-sensitivity experiments run at.
WAN_BANDS: Dict[str, LinkModel] = {
    "10mbit": LinkModel(bandwidth=10e6 / 8.0, latency_s=0.150),
    "50mbit": LinkModel(bandwidth=50e6 / 8.0, latency_s=0.150),
    "100mbit": LinkModel(bandwidth=100e6 / 8.0, latency_s=0.140),
}
DEFAULT_WAN_BAND = "10mbit"


@dataclass(frozen=True)
class Hop:
    """One directed traversal of a link along a route."""
    src: str
    dst: str
    link: LinkModel


@dataclass(frozen=True)
class Route:
    """A multi-hop path through the continuum topology.

    Transfer time is store-and-forward: every hop serializes the full
    message (``nbytes / bandwidth``) and adds its own latency — per-hop
    latency *accumulates*, it is not collapsed to the slowest hop.
    """
    src: str
    dst: str
    hops: Tuple[Hop, ...]

    @property
    def tiers(self) -> Tuple[str, ...]:
        """The tier sequence the route visits (src first)."""
        return (self.src,) + tuple(h.dst for h in self.hops)

    @property
    def latency_s(self) -> float:
        return sum(h.link.latency_s for h in self.hops)

    def transfer_s(self, nbytes: float) -> float:
        """Seconds to move ``nbytes`` end to end (store-and-forward)."""
        return sum(nbytes / h.link.bandwidth + h.link.latency_s
                   for h in self.hops)

    def as_link(self) -> LinkModel:
        """The serialized-equivalent single link: store-and-forward over
        the hops equals one link with the harmonic-sum bandwidth and the
        accumulated latency, for *any* message size."""
        if not self.hops:
            return LinkModel(bandwidth=float("inf"), latency_s=0.0)
        inv_bw = sum(1.0 / h.link.bandwidth for h in self.hops)
        return LinkModel(bandwidth=1.0 / inv_bw, latency_s=self.latency_s)


class Topology:
    """The continuum tier graph: tiers as nodes, links as undirected
    edges, Dijkstra shortest-*time* routing.

    Edge weight for a transfer of ``nbytes`` is the store-and-forward hop
    time ``nbytes / bandwidth + latency_s``; with ``nbytes=0`` routing
    minimizes accumulated latency.  Ties break on (hop count, tier name)
    so routes are deterministic — a run is a pure function of the profile.
    """

    def __init__(self, links: Mapping[Tuple[str, str], LinkModel],
                 tiers: Iterable[str] = ()):
        self._adj: Dict[str, Dict[str, LinkModel]] = {t: {} for t in tiers}
        for (a, b), link in links.items():
            self._adj.setdefault(a, {})[b] = link
            self._adj.setdefault(b, {})[a] = link

    @property
    def tiers(self) -> Tuple[str, ...]:
        return tuple(sorted(self._adj))

    def neighbors(self, tier: str) -> Dict[str, LinkModel]:
        return dict(self._adj.get(tier, {}))

    def link(self, a: str, b: str) -> Optional[LinkModel]:
        """The direct link between two tiers, or None."""
        return self._adj.get(a, {}).get(b)

    def route(self, src: str, dst: str,
              nbytes: float = 0.0) -> Optional[Route]:
        """Shortest-time route ``src → dst`` for an ``nbytes`` message, or
        None when the tiers are disconnected.  ``route(a, a)`` is the
        empty route (zero hops, zero time)."""
        if src == dst:
            return Route(src, dst, ())
        if src not in self._adj or dst not in self._adj:
            return None
        # (total_time, hop_count, tier) keys: deterministic and
        # latency-accumulating; hop count then name break exact ties
        best: Dict[str, Tuple[float, int]] = {src: (0.0, 0)}
        prev: Dict[str, Tuple[str, LinkModel]] = {}
        heap: List[Tuple[float, int, str]] = [(0.0, 0, src)]
        done = set()
        while heap:
            t, n, tier = heapq.heappop(heap)
            if tier in done:
                continue
            done.add(tier)
            if tier == dst:
                break
            for nxt in sorted(self._adj[tier]):
                if nxt in done:
                    continue
                link = self._adj[tier][nxt]
                cost = t + nbytes / link.bandwidth + link.latency_s
                cand = (cost, n + 1)
                if nxt not in best or cand < best[nxt]:
                    best[nxt] = cand
                    prev[nxt] = (tier, link)
                    heapq.heappush(heap, (cost, n + 1, nxt))
        if dst not in prev:
            return None
        hops: List[Hop] = []
        at = dst
        while at != src:
            frm, link = prev[at]
            hops.append(Hop(frm, at, link))
            at = frm
        return Route(src, dst, tuple(reversed(hops)))


@dataclass(frozen=True)
class DeviceProfile:
    """Sustained peak rates of one device class.

    ``bf16_speedup``/``int8_speedup`` are the peak-rate multipliers a
    reduced-precision kernel variant enjoys on this device class — the
    hardware half of the precision placement axis.  Narrow-datapath SIMD
    roughly doubles per precision halving on general-purpose cores; the
    sensing SoC carries an NPU-class int8 path (the usual edge-accelerator
    story: int8 MACs are an order of magnitude denser than fp32).
    """
    name: str
    peak_flops: float              # FLOP/s at full efficiency (fp32)
    mem_bw: float = 0.0            # bytes/s (roofline memory term)
    memory_gb: float = 4.0
    bf16_speedup: float = 2.0
    int8_speedup: float = 4.0

    def speedup(self, precision: str = "fp32") -> float:
        """Peak-rate multiplier for a kernel precision variant."""
        if precision == "fp32":
            return 1.0
        if precision == "bf16":
            return self.bf16_speedup
        if precision == "int8":
            return self.int8_speedup
        raise ValueError(f"unknown precision {precision!r}")


# The continuum's device classes, sensor to datacenter. Device = the
# sensing SoC next to the data; edge = RasPi-class (1 core / 4 GB Dask
# task); fog = a metro gateway box between edge site and datacenter;
# cloud/hpc = one EC2-class worker core-set per Dask worker.
#
# The sensing SoC is the precision story's extreme point: an FPU-less
# MCU core does *software-emulated* fp32 at ~10 MFLOP/s, but carries a
# micro-NPU/DSP int8 path (Coral/K210-class) two orders of magnitude
# denser — fp32 models are infeasible where their int8 variants are not.
DEVICE_SOC = DeviceProfile("device-soc", peak_flops=1e7, mem_bw=1e9,
                           memory_gb=0.5, bf16_speedup=4.0,
                           int8_speedup=100.0)
RASPI_4B = DeviceProfile("raspi-4b", peak_flops=5e9, mem_bw=4e9,
                         memory_gb=4.0)
FOG_NODE = DeviceProfile("fog-node", peak_flops=20e9, mem_bw=10e9,
                         memory_gb=8.0)
CLOUD_CPU = DeviceProfile("cloud-cpu", peak_flops=50e9, mem_bw=20e9,
                          memory_gb=16.0)

# non-WAN continuum links of the default topology: the device→edge local
# hop (wireless/LAN) and the edge→fog metro hop. Distinct latency values
# from every WAN band so ``with_wan`` re-pricing never touches them.
DEVICE_EDGE_LINK = LinkModel(bandwidth=100e6 / 8.0, latency_s=0.005)
EDGE_FOG_LINK = LinkModel(bandwidth=100e6 / 8.0, latency_s=0.020)
CLOUD_HPC_LINK = LinkModel(bandwidth=1e9, latency_s=0.020)

# Metro (edge→fog) bands, sweepable exactly like the WAN bands.  All
# share the 20 ms metro latency — distinct from every WAN band's 140+ ms
# and from the 5 ms device hop, so ``with_wan`` / ``with_metro``
# re-pricing never cross-match each other's links.  The default
# ``100mbit`` band *is* :data:`EDGE_FOG_LINK`, so profiles that never
# sweep the metro hop are unchanged.
METRO_BANDS: Dict[str, LinkModel] = {
    "10mbit": LinkModel(bandwidth=10e6 / 8.0, latency_s=0.020),
    "50mbit": LinkModel(bandwidth=50e6 / 8.0, latency_s=0.020),
    "100mbit": EDGE_FOG_LINK,
}
DEFAULT_METRO_BAND = "100mbit"


@dataclass(frozen=True)
class TierProfile:
    """One continuum tier: which device backs it + its intra-tier link."""
    tier: str
    device: DeviceProfile
    # within a tier messages ride local links (LAN / host loopback)
    intra_link: LinkModel = LinkModel(bandwidth=10e9, latency_s=0.0)


@dataclass(frozen=True)
class ContinuumProfile:
    """The assembled continuum: tiers + inter-tier links + WAN bands."""
    name: str
    tiers: Mapping[str, TierProfile]
    links: Mapping[Tuple[str, str], LinkModel]
    wan_bands: Mapping[str, LinkModel] = field(
        default_factory=lambda: dict(WAN_BANDS))
    default_wan: str = DEFAULT_WAN_BAND
    metro_bands: Mapping[str, LinkModel] = field(
        default_factory=lambda: dict(METRO_BANDS))
    default_metro: str = DEFAULT_METRO_BAND

    def tier(self, name: str) -> TierProfile:
        try:
            return self.tiers[name]
        except KeyError:
            raise KeyError(f"unknown tier {name!r}; "
                           f"known: {sorted(self.tiers)}") from None

    def wan(self, band: Optional[str] = None) -> LinkModel:
        return self.wan_bands[band or self.default_wan]

    def metro(self, band: Optional[str] = None) -> LinkModel:
        return self.metro_bands[band or self.default_metro]

    @property
    def topology(self) -> Topology:
        """The tier graph (links as undirected edges) this profile routes
        multi-hop transfers over — built once per profile (the profile is
        frozen, so the graph is a pure function of it)."""
        topo = self.__dict__.get("_topology")
        if topo is None:
            topo = Topology(self.links, tiers=self.tiers)
            object.__setattr__(self, "_topology", topo)
        return topo

    def _fallback_link(self) -> LinkModel:
        """Disconnected tier pairs price at the default WAN band with a
        conservative doubled latency (the historical unknown-pair rule)."""
        wan = self.wan()
        return LinkModel(bandwidth=wan.bandwidth,
                         latency_s=2.0 * max(wan.latency_s, 0.1))

    def route(self, a: str, b: str, nbytes: float = 0.0) -> Route:
        """Shortest-time route between two tiers.  Same-tier traffic rides
        the intra-tier link as a single hop; cross-tier traffic takes the
        topology's routed path (one hop when a direct link exists — a
        detour is never picked unless it is strictly faster); tiers the
        topology cannot connect fall back to a single synthetic
        default-WAN hop so pricing never dead-ends."""
        if a == b:
            tp = self.tiers.get(a)
            intra = tp.intra_link if tp else LinkModel(10e9, 0.0)
            return Route(a, b, (Hop(a, b, intra),))
        r = self.topology.route(a, b, nbytes)
        if r is not None:
            return r
        return Route(a, b, (Hop(a, b, self._fallback_link()),))

    def link(self, a: str, b: str) -> LinkModel:
        """Effective link between two tiers: the direct link when one
        exists, otherwise the routed path's serialized-equivalent link
        (harmonic-sum bandwidth, accumulated latency)."""
        if a == b:
            tp = self.tiers.get(a)
            return tp.intra_link if tp else LinkModel(10e9, 0.0)
        link = self.links.get((a, b)) or self.links.get((b, a))
        if link is not None:
            return link
        return self.route(a, b).as_link()

    def with_wan(self, band: str) -> "ContinuumProfile":
        """The same continuum with every WAN link re-priced at a named
        band (the Fig-3 sweep's knob).  A link counts as WAN when it
        currently carries one of this profile's band prices — tier names
        don't matter, so custom continuums re-price correctly too."""
        wan = self.wan(band)
        band_links = set(self.wan_bands.values())
        links = {pair: (wan if link in band_links else link)
                 for pair, link in self.links.items()}
        return replace(self, links=links, default_wan=band)

    def with_metro(self, band: str) -> "ContinuumProfile":
        """The same continuum with every metro (edge→fog) link re-priced
        at a named metro band — the fog-placement analog of
        :meth:`with_wan`.  A link counts as metro when it currently
        carries one of this profile's metro band prices."""
        metro = self.metro(band)
        band_links = set(self.metro_bands.values())
        links = {pair: (metro if link in band_links else link)
                 for pair, link in self.links.items()}
        return replace(self, links=links, default_metro=band)


def _default_profile() -> ContinuumProfile:
    wan = WAN_BANDS[DEFAULT_WAN_BAND]
    return ContinuumProfile(
        name="paper-testbed",
        tiers={
            "device": TierProfile("device", DEVICE_SOC),
            "edge": TierProfile("edge", RASPI_4B),
            "fog": TierProfile("fog", FOG_NODE),
            "cloud": TierProfile("cloud", CLOUD_CPU),
            "hpc": TierProfile("hpc", CLOUD_CPU),
        },
        links={
            ("device", "edge"): DEVICE_EDGE_LINK,
            ("edge", "fog"): EDGE_FOG_LINK,
            ("fog", "cloud"): wan,
            ("edge", "cloud"): wan,
            ("edge", "hpc"): wan,
            ("cloud", "hpc"): CLOUD_HPC_LINK,
        })


# the profile everything defaults to: the 4-tier device/edge/fog/cloud
# continuum (plus the hpc accounting tier) built on the paper's RasPi +
# EC2 testbed, with the constrained 10 Mbit/s WAN between edge/fog and
# cloud/hpc. Tiers without a direct link (e.g. device→cloud) route
# multi-hop through the topology.
DEFAULT_PROFILE = _default_profile()
