"""Geo-federated verify planes behind an RTT-routing front door — a copy of
handel_tpu/service/federation.py.

One `MultiSessionCluster` (service/driver.py) per region of a planet
preset (scenario/planets.py) makes a *federation*: the service no longer
lives or dies with one cluster. Arrivals enter through a `FrontDoor`
that routes each session to the nearest healthy region by the planet's
RTT matrix (`GeoConfig.rtt`), with three defenses layered in order:

- **spill-over** — when the nearest region refuses (its SLO shed bound,
  fairness.py `shed_at` against the global queue depth; its live-session
  cap; or it is dead), the arrival immediately tries the next region by
  RTT. A spilled session pays the extra WAN leg but completes.
- **health probes** — the front door routes on its own learned health
  map, refreshed every `probe_interval_s`; a routing attempt that finds
  a region dead marks it down passively (no full probe interval of
  misroutes after a kill).
- **capped-exponential-backoff retry** — when EVERY region refuses, the
  arrival waits `min(retry_cap_ms, retry_base_ms * 2^attempt)` and
  re-routes, up to `retry_budget` attempts; only then does it fail, and
  the failure is attributed (shed vs dead) — never a silent drop.

Chaos rides at this level too: `Federation.kill_region` stops a region's
cluster mid-flight (its live sessions are handed back for re-routing),
and `Federation.recover_region` rebuilds it and rejoins it via the
existing epoch path — the fresh cluster stages the current validator
set, quiesces, and flips (lifecycle/epoch.py over `quiesce_and`), so
re-admission is a registry rotation, not a cold restart. Every
transition is traced with region-tagged spans (`args={"region": ...}`),
which is what lets `sim trace --critical-path` attribute which leg a
late session waited on.

Driven open-loop by sim/load.py (`python -m handel_tpu_torch.sim load`);
configured by the `[federation]` TOML section (sim/config.py).
"""

from __future__ import annotations

import asyncio
import time

from handel_tpu_torch.core.logging import DEFAULT_LOGGER, Logger
from handel_tpu_torch.core.test_harness import FakeScheme
from handel_tpu_torch.core.trace import SERVICE_TID, trace_now
from handel_tpu_torch.network.geo import GeoConfig
from handel_tpu_torch.scenario.planets import planet_preset
from handel_tpu_torch.service.fairness import DEFAULT_TIER, TIERS
from handel_tpu_torch.service.session import AdmissionRefused, Session


class RegionShedding(RuntimeError):
    """Region refused an arrival at its SLO shed bound: spill it."""


class RegionDead(RuntimeError):
    """Region's cluster is stopped (killed, not yet recovered)."""


class RegionPlane:
    """One geo region's service plane: a MultiSessionCluster plus the
    admission/health surface the front door routes against.

    The cluster is rebuilt wholesale on recovery, so the counters a
    report needs cumulatively (completions, sheds, queue offers) are
    banked here across rebuilds — `stats()` is always lifetime totals.
    """

    def __init__(self, name: str, index: int, p, *, scheme=None,
                 recorder=None, logger: Logger = DEFAULT_LOGGER):
        self.name = name
        self.index = index
        self.p = p
        self.scheme = scheme or FakeScheme()
        self.recorder = recorder
        self.log = logger
        self.killed = False
        # front-door attribution counters (lifetime, never rebuilt)
        self.arrivals = 0  # arrivals whose nearest region is this one
        self.admitted = 0
        self.spill_in = 0  # admitted here after a nearer region refused
        self.sheds = 0  # session-level refusals at the shed bound
        self.refusals = 0  # refusals at the live-session cap
        self.kills = 0
        self.recoveries = 0
        self._banked = {
            "completed": 0, "expired": 0, "evicted": 0, "spawned": 0,
            "pushed": 0, "refused": 0, "shed": 0,
        }
        self.cluster: MultiSessionCluster | None = None
        self._build()

    def _build(self) -> None:
        # deferred: driver -> parallel -> mesh_plane -> service would
        # otherwise close an import cycle through this module
        from handel_tpu_torch.service.driver import MultiSessionCluster

        p = self.p
        self.cluster = MultiSessionCluster(
            sessions=0,  # open-loop arrivals drive it, not cluster.run()
            nodes=0,
            scheme=self.scheme,
            devices=p.devices,
            batch_size=p.batch_size,
            max_sessions=p.max_sessions,
            session_ttl_s=p.session_ttl_s,
            queue_capacity=p.queue_capacity,
            recorder=self.recorder,
        )

    def start(self) -> None:
        self.cluster.service.start()

    @property
    def healthy(self) -> bool:
        """Ground truth (what a probe reaching the region would see) —
        the front door routes on its own learned view, not this."""
        return not self.killed

    def live_count(self) -> int:
        return self.cluster.manager.live_count()

    def shedding(self, tier: str | None) -> bool:
        """Session-level mirror of the queue's candidate-level shed door
        (fairness.py push): admitting a session whose tier would shed
        every candidate it enqueues only wastes its committee's work."""
        q = self.cluster.service.queue
        if q.capacity <= 0:
            return False
        t = TIERS.get(tier or "", DEFAULT_TIER)
        return len(q) >= q.capacity * t.shed_at

    def admit(self, *, nodes: int, tier: str | None, seed: int,
              on_done=None) -> Session:
        """One arrival: spawn + start a session here, or refuse with
        attribution (RegionDead / RegionShedding / AdmissionRefused)."""
        if self.killed:
            raise RegionDead(self.name)
        if self.shedding(tier):
            self.sheds += 1
            raise RegionShedding(f"{self.name} at shed bound")

        def tweak(node_cfg, i):
            node_cfg.update_period = self.p.period_ms / 1000.0
            # region-tagged spans end to end (core/handel.py _sargs):
            # the critical-path walk attributes hops to region pairs
            node_cfg.region = self.name

        m = self.cluster.manager
        try:
            s = m.spawn(nodes, seed=seed, tier=tier, config_tweak=tweak)
        except AdmissionRefused:
            self.refusals += 1
            raise
        self.admitted += 1
        m.start(s.sid, on_done=on_done)
        return s

    def kill(self) -> list[str]:
        """Chaos: stop this region's whole cluster mid-flight. Returns the
        sids that were live — the caller (sim/load.py) re-routes those
        arrivals through the front door, so a region loss is latency, not
        loss."""
        live = [
            sid for sid, s in self.cluster.manager.sessions.items()
            if not s.finished
        ]
        self.killed = True
        self.kills += 1
        self._bank()
        self.cluster.stop()
        if self.recorder is not None:
            self.recorder.instant(
                "region_kill", tid=SERVICE_TID, cat="federation",
                args={"region": self.name},
            )
        return live

    def revive(self) -> None:
        """Rebuild a fresh cluster for this region. The caller owns the
        rejoin choreography (epoch staging + front-door re-admission) —
        this only restores the machinery."""
        self._build()
        self.cluster.service.start()
        self.killed = False
        self.recoveries += 1
        if self.recorder is not None:
            self.recorder.instant(
                "region_recover", tid=SERVICE_TID, cat="federation",
                args={"region": self.name},
            )

    def _bank(self) -> None:
        """Fold the dying cluster's counters into the lifetime totals
        before the rebuild discards them."""
        m = self.cluster.manager
        q = self.cluster.service.queue
        b = self._banked
        b["completed"] += m.completed_ct
        b["expired"] += m.expired_ct
        b["evicted"] += m.evicted_ct
        b["spawned"] += m.spawned_ct
        b["pushed"] += q.pushed
        b["refused"] += q.refused
        b["shed"] += q.shed

    def stats(self) -> dict[str, float]:
        """Lifetime per-region sample set (the `region`-labeled metrics
        plane: handel_federation_*{region="..."})."""
        m = self.cluster.manager
        q = self.cluster.service.queue
        b = self._banked
        shed = b["shed"] + q.shed
        offered = shed + b["pushed"] + q.pushed + b["refused"] + q.refused
        return {
            "regionHealthy": 0.0 if self.killed else 1.0,
            "arrivals": float(self.arrivals),
            "admitted": float(self.admitted),
            "spillIn": float(self.spill_in),
            "shed": float(self.sheds),
            "refused": float(self.refusals),
            "sessionsLive": float(0 if self.killed else m.live_count()),
            "completed": float(b["completed"] + m.completed_ct),
            "expired": float(b["expired"] + m.expired_ct),
            "evicted": float(b["evicted"] + m.evicted_ct),
            # candidate-level shed rate of this region's verify plane
            "shedRate": shed / offered if offered else 0.0,
            "epoch": float(m.epoch),
            "kills": float(self.kills),
        }


class FrontDoor:
    """Routes each arriving session to the nearest healthy region by RTT.

    Routing is deterministic: per-origin region orders are precomputed
    from the RTT matrix with a name tie-break, and health transitions are
    the only routing state — same seed, same planet, same kills means
    the same region choice for every arrival.
    """

    def __init__(self, geo: GeoConfig, planes: list[RegionPlane], p, *,
                 recorder=None, logger: Logger = DEFAULT_LOGGER):
        self.geo = geo
        self.planes = {r.name: r for r in planes}
        self.p = p
        self.recorder = recorder
        self.log = logger
        self.health: dict[str, bool] = {r.name: True for r in planes}
        self.unhealthy_at: dict[str, float] = {}  # detection timestamps
        self.rehealthy_at: dict[str, float] = {}
        self.retries = 0
        self.spillovers = 0
        self.sheds = 0  # arrivals that exhausted the budget on shed doors
        self.failures = 0  # arrivals that exhausted it on dead regions
        self.probe_rounds = 0
        self.markdowns = 0  # monotonic healthy->down transitions
        self._probe_task: asyncio.Task | None = None
        # nearest-first routing tables, one per origin region
        self._order = {
            o: sorted(self.planes, key=lambda r: (geo.rtt(o, r), r))
            for o in self.planes
        }

    # -- health -------------------------------------------------------------

    def backoff_ms(self, attempt: int) -> float:
        """Capped exponential retry delay for 0-based `attempt`."""
        return min(
            self.p.retry_cap_ms, self.p.retry_base_ms * (2.0 ** attempt)
        )

    def mark(self, name: str, healthy: bool) -> None:
        if self.health[name] == healthy:
            return
        self.health[name] = healthy
        if not healthy:
            self.markdowns += 1
        (self.rehealthy_at if healthy else self.unhealthy_at)[name] = (
            time.monotonic()
        )
        if self.recorder is not None:
            self.recorder.instant(
                "frontdoor_mark_" + ("up" if healthy else "down"),
                tid=SERVICE_TID, cat="federation", args={"region": name},
            )
        self.log.info(
            "federation",
            f"front door marks {name} {'healthy' if healthy else 'DOWN'}",
        )

    def probe_now(self) -> None:
        """One health-probe round (the background loop's body; tests call
        it directly for deterministic transitions)."""
        self.probe_rounds += 1
        for name, plane in self.planes.items():
            self.mark(name, plane.healthy)

    async def _probe_loop(self) -> None:
        while True:
            await asyncio.sleep(self.p.probe_interval_s)
            self.probe_now()

    def start(self) -> None:
        self._probe_task = asyncio.get_running_loop().create_task(
            self._probe_loop()
        )

    async def stop(self) -> None:
        if self._probe_task is None:
            return
        self._probe_task.cancel()
        try:
            await self._probe_task
        except asyncio.CancelledError:
            pass
        self._probe_task = None

    # -- routing ------------------------------------------------------------

    def route_order(self, origin: str) -> list[str]:
        """Healthy regions nearest-first by RTT from `origin`."""
        return [r for r in self._order[origin] if self.health[r]]

    async def submit(self, origin: str, *, nodes: int, tier: str | None,
                     seed: int, on_done=None):
        """Route one arrival. Returns (outcome, session, region, attempts)
        with outcome "admitted" | "shed" | "failed" — an arrival NEVER
        vanishes: it lands, sheds with attribution, or fails its traced
        retry budget."""
        p = self.p
        primary = self._order[origin][0]
        self.planes[primary].arrivals += 1
        t0 = trace_now()
        attempts = 0
        shed_seen = False
        while True:
            for name in self.route_order(origin):
                plane = self.planes[name]
                # the WAN leg: the front door sits with the arrival's
                # origin, so reaching a farther region costs its RTT/2
                rtt = self.geo.rtt(origin, name)
                if rtt > 0:
                    await asyncio.sleep(rtt / 2.0 / 1000.0)
                try:
                    s = plane.admit(
                        nodes=nodes, tier=tier, seed=seed, on_done=on_done
                    )
                except RegionDead:
                    self.mark(name, False)  # passive detection
                    continue
                except RegionShedding:
                    shed_seen = True
                    continue
                except AdmissionRefused:
                    shed_seen = True  # cap-full is shed-shaped backpressure
                    continue
                if name != primary:
                    self.spillovers += 1
                    plane.spill_in += 1
                if self.recorder is not None:
                    self.recorder.span(
                        "frontdoor_route", t0, trace_now(),
                        tid=SERVICE_TID, cat="federation",
                        args={"region": name, "origin": origin,
                              "attempts": attempts,
                              "spilled": name != primary},
                    )
                return "admitted", s, plane, attempts
            if attempts >= p.retry_budget:
                break
            delay_ms = self.backoff_ms(attempts)
            attempts += 1
            self.retries += 1
            await asyncio.sleep(delay_ms / 1000.0)
        outcome = "shed" if shed_seen else "failed"
        if outcome == "shed":
            self.sheds += 1
        else:
            self.failures += 1
        if self.recorder is not None:
            self.recorder.span(
                "frontdoor_route", t0, trace_now(),
                tid=SERVICE_TID, cat="federation",
                args={"region": "", "origin": origin,
                      "attempts": attempts, "outcome": outcome},
            )
        return outcome, None, None, attempts


class Federation:
    """The whole geo plane: per-region clusters, the front door, and the
    cross-region epoch path. Build it, `start()` it inside a running
    loop, `submit()` arrivals, `kill_region`/`recover_region` for chaos,
    `stop()` when drained."""

    def __init__(self, p, *, scheme=None, recorder=None,
                 logger: Logger = DEFAULT_LOGGER):
        regions, rtt = planet_preset(p.planet)
        self.geo = GeoConfig(
            regions=regions, rtt_ms=rtt, seed=p.geo_seed
        ).validate()
        self.p = p
        self.scheme = scheme or FakeScheme()
        self.recorder = recorder
        self.log = logger
        self.planes = [
            RegionPlane(name, i, p, scheme=self.scheme,
                        recorder=recorder, logger=logger)
            for i, name in enumerate(regions)
        ]
        self.by_name = {r.name: r for r in self.planes}
        self.front_door = FrontDoor(
            self.geo, self.planes, p, recorder=recorder, logger=logger
        )
        # federation-wide validator-set epoch (every healthy region's
        # cluster rotates together through quiesce_and)
        self.epoch = 0
        self.last_rotation_stall_s: dict[str, float] = {}

    def start(self) -> None:
        for r in self.planes:
            r.start()
        self.front_door.start()

    async def stop(self) -> None:
        await self.front_door.stop()
        for r in self.planes:
            if not r.killed:
                r.cluster.stop()

    def region_names(self) -> list[str]:
        return [r.name for r in self.planes]

    async def submit(self, origin: str, *, nodes: int, tier: str | None,
                     seed: int, on_done=None):
        return await self.front_door.submit(
            origin, nodes=nodes, tier=tier, seed=seed, on_done=on_done
        )

    # -- chaos: region kill + epoch-path recovery ---------------------------

    def kill_region(self, name: str) -> list[str]:
        """Stop `name`'s cluster mid-flight; returns the interrupted live
        sids for the caller to re-route. The front door learns of the
        death from its next probe or the first misrouted arrival."""
        return self.by_name[name].kill()

    async def recover_region(self, name: str) -> float:
        """Rebuild `name` and rejoin it via the epoch path: the fresh
        cluster plus every surviving region stage the next validator set
        and flip under quiesce_and (cross-region epoch rotation), so the
        rejoined region re-enters at the federation's new epoch rather
        than cold-starting at 0. Returns the worst per-region stall."""
        self.by_name[name].revive()
        return await self.rotate_epochs()

    async def rotate_epochs(self) -> float:
        """One federation-wide epoch rotation riding the existing
        stage -> quiesce -> flip choreography (lifecycle/epoch.py) on
        every healthy region; returns the worst gate-closed stall."""
        from handel_tpu_torch.lifecycle.epoch import EpochManager

        pubkeys = [
            self.scheme.keygen(i)[1] for i in range(self.p.registry)
        ]
        worst = 0.0
        for plane in self.planes:
            if plane.killed:
                continue
            em = EpochManager(
                plane.cluster.service, plane.cluster.manager,
                logger=self.log,
            )
            await em.begin_rotation(pubkeys)
            stall = await em.commit_rotation()
            self.last_rotation_stall_s[plane.name] = stall
            worst = max(worst, stall)
        self.epoch += 1
        if self.recorder is not None:
            self.recorder.instant(
                "federation_epoch", tid=SERVICE_TID, cat="federation",
                args={"epoch": self.epoch},
            )
        return worst

    # -- reporters ----------------------------------------------------------

    def values(self) -> dict[str, float]:
        fd = self.front_door
        return {
            "regionsTotal": float(len(self.planes)),
            "regionsHealthy": float(
                sum(1 for r in self.planes if not r.killed)
            ),
            "frontDoorRetries": float(fd.retries),
            "spilloverCt": float(fd.spillovers),
            "frontDoorSheds": float(fd.sheds),
            "frontDoorFailures": float(fd.failures),
            # monotonic healthy->down mark-downs (passive + probe) so the
            # alert plane can difference mark-down bursts between scrapes
            "markdownCt": float(fd.markdowns),
            "probeRounds": float(fd.probe_rounds),
            "regionKills": float(sum(r.kills for r in self.planes)),
            "regionRecoveries": float(
                sum(r.recoveries for r in self.planes)
            ),
            "epoch": float(self.epoch),
        }

    def gauge_keys(self) -> set[str]:
        return {"regionsTotal", "regionsHealthy", "epoch"}

    def labeled_values(self) -> dict[str, dict[str, float]]:
        """{region name: per-region stats} for the `region`-labeled plane
        (handel_federation_*{region="..."}; `sim watch` federation rows)."""
        return {r.name: r.stats() for r in self.planes}

    def labeled_gauge_keys(self) -> set[str]:
        return {"regionHealthy", "sessionsLive", "shedRate", "epoch"}
