"""Geo-latency planet model: region-aware WAN delay over any transport — a
copy of handel_tpu/network/geo.py.

`ChaosNetwork` injects *faults* — uniform, link-agnostic drop/corrupt/delay
rates. A planet is not uniform: Frankfurt<->Zurich is 8 ms while
Sydney<->Sao Paulo is 320 ms, and Handel's level schedule interacts with
that asymmetry (close peers complete low levels long before far peers can
contribute). `GeoNetwork` generalizes the chaos wrapper with a
region-to-region RTT matrix:

  - every node is assigned a region (round-robin by id unless the scenario
    pins an explicit assignment),
  - every outbound packet samples a one-way delay from the (src region,
    dst region) entry — RTT/2 plus Gaussian jitter — on the same
    per-(seed, destination) `random.Random` discipline ChaosNetwork uses,
    so a seed reproduces the same planet run over run,
  - chaos faults COMPOSE on top: GeoNetwork subclasses ChaosNetwork and
    adds its WAN delay at the `_deliver` stage, after the fault pipeline
    (a chaos-delayed packet pays chaos delay, then WAN delay).

Sampled delays ride the shared `net_delayMs` histogram plus a `geoDelayed`
counter, so `sim watch` and trace reports see the injected WAN latency.
The node's own region is tagged onto every trace span via Config.region
(core/handel.py), which is what lets the critical-path analyzer attribute
hops to region pairs (sim/trace_cli.py).

Presets ("planet-3region", "planet-5region") live in
scenario/planets.py; this module is pure mechanism.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

from handel_tpu_torch.core.identity import Identity
from handel_tpu_torch.core.logging import DEFAULT_LOGGER, Logger
from handel_tpu_torch.core.net import Packet
from handel_tpu_torch.network.chaos import ChaosConfig, ChaosNetwork


@dataclass
class GeoConfig:
    """Planet model: named regions, a symmetric RTT matrix between them,
    and this node's own placement."""

    # region names, indexing rtt_ms rows/cols
    regions: Sequence[str] = ()
    # rtt_ms[i][j] = round-trip ms between regions i and j (0 on diagonal)
    rtt_ms: Sequence[Sequence[float]] = ()
    # Gaussian jitter (std dev, ms) added to each sampled one-way delay
    jitter_ms: float = 0.0
    seed: int = 0
    # this node's id — picks its region
    node_id: int = 0
    # explicit node-id -> region-index pinning; ids not present fall back
    # to round-robin (id % len(regions))
    assignment: dict[int, int] = field(default_factory=dict)

    def region_index(self, node_id: int) -> int:
        idx = self.assignment.get(node_id)
        if idx is None:
            idx = node_id % len(self.regions)
        return idx

    def region_of(self, node_id: int) -> str:
        return self.regions[self.region_index(node_id)]

    def _resolve_region(self, r: "str | int") -> int:
        if isinstance(r, str):
            try:
                return list(self.regions).index(r)
            except ValueError:
                raise ValueError(
                    f"unknown region {r!r} "
                    f"(known: {', '.join(self.regions)})"
                ) from None
        if not 0 <= r < len(self.regions):
            raise ValueError(
                f"region index {r} out of range "
                f"(0..{len(self.regions) - 1})"
            )
        return int(r)

    def rtt(self, a: "str | int", b: "str | int") -> float:
        """Region-to-region round-trip ms, by name or index — the public
        lookup the front door (service/federation.py) routes by, so
        callers never index the matrix representation directly."""
        return float(self.rtt_ms[self._resolve_region(a)][self._resolve_region(b)])

    def validate(self) -> "GeoConfig":
        n = len(self.regions)
        if n == 0:
            raise ValueError("geo config needs at least one region")
        if len(self.rtt_ms) != n or any(len(row) != n for row in self.rtt_ms):
            raise ValueError(
                f"geo rtt_ms must be a {n}x{n} matrix matching regions"
            )
        for i, row in enumerate(self.rtt_ms):
            for j, v in enumerate(row):
                if v < 0:
                    raise ValueError(f"geo rtt_ms[{i}][{j}] negative: {v}")
        if self.jitter_ms < 0:
            raise ValueError("geo jitter_ms must be >= 0")
        for nid, idx in self.assignment.items():
            if not 0 <= idx < n:
                raise ValueError(
                    f"geo assignment pins node {nid} to region {idx}, "
                    f"but only {n} regions exist"
                )
        return self

    def for_node(self, node_id: int) -> "GeoConfig":
        """Node-local view: same planet, this node's placement, and a
        node-unique seed (same derivation as ChaosConfig.for_node)."""
        return replace(
            self, node_id=node_id, seed=self.seed * 1_000_003 + node_id
        )


class GeoNetwork(ChaosNetwork):
    """ChaosNetwork + region-pair WAN delay on every delivery."""

    def __init__(
        self,
        inner,
        geo: GeoConfig,
        chaos: Optional[ChaosConfig] = None,
        logger: Logger = DEFAULT_LOGGER,
    ):
        super().__init__(inner, chaos or ChaosConfig(), logger=logger)
        self.geo = geo.validate()
        self._src_region = geo.region_index(geo.node_id)
        # geo draws get their own rng streams so enabling the planet model
        # never perturbs the chaos fault placement for a given seed
        self._geo_rngs: dict[str, random.Random] = {}
        self.geo_delayed = 0

    @property
    def region(self) -> str:
        return self.geo.regions[self._src_region]

    # -- delay model ---------------------------------------------------------

    def _geo_rng(self, addr: str) -> random.Random:
        rng = self._geo_rngs.get(addr)
        if rng is None:
            rng = random.Random(f"geo|{self.geo.seed}|{addr}")
            self._geo_rngs[addr] = rng
        return rng

    def sample_delay_ms(self, ident: Identity) -> float:
        dst = self.geo.region_index(ident.id)
        one_way = self.geo.rtt_ms[self._src_region][dst] / 2.0
        if self.geo.jitter_ms:
            one_way += self._geo_rng(ident.address).gauss(
                0.0, self.geo.jitter_ms
            )
        return max(0.0, one_way)

    # -- delivery override ---------------------------------------------------

    def _deliver(self, ident: Identity, packet: Packet) -> None:
        """Every delivery — direct, chaos-delayed, or reorder-flushed —
        funnels through here, so WAN delay composes after any fault."""
        delay_ms = self.sample_delay_ms(ident)
        if delay_ms <= 0.0:
            self.inner.send([ident], packet)
            return
        self.geo_delayed += 1
        self.hist_delay.add(delay_ms)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:  # no loop (sync test caller): deliver now
            self.inner.send([ident], packet)
            return
        # schedule inner.send directly — NOT self._later, which would
        # re-enter this override and sample the delay twice
        loop.call_later(delay_ms / 1000.0, self.inner.send, [ident], packet)

    # -- reporter -------------------------------------------------------------

    def values(self) -> dict[str, float]:
        out = {"geoDelayed": float(self.geo_delayed)}
        out.update(super().values())
        return out
