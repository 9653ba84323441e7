"""`python -m handel_tpu_torch.sim load`, open-loop production traffic: a
copy of handel_tpu/sim/load.py.

Everything before this measured closed-loop: batches arrived when the
harness felt like it (cluster.run spawns, the soak back-fills on
completion). A production verify plane faces OPEN-LOOP arrivals — a
seeded Poisson/diurnal/burst clock fires sessions at the federation
(service/federation.py) whether or not it keeps up — so the first-class
metrics change shape: arrival→verdict p50/p99 (routing + backoff +
queueing + aggregation, not just service time), goodput against a
per-session deadline, and the spill/shed/retry attribution of every
arrival that didn't complete where it was born.

Arrival models (all exact under a fixed seed, via Lewis-Shedler thinning
against the model's peak rate):

- **poisson** — homogeneous at `rate_sps`.
- **diurnal** — rate * (1 + amplitude * sin(2πt/period)): a compressed
  day, peak and trough traffic in one run.
- **burst**  — rate * burst_x inside each `burst_len_s` window every
  `burst_every_s`: flash-crowd spikes over a steady floor.

The chaos drill rides mid-run when `[federation] kill_region` is set:
the named region's cluster stops cold at `kill_at_frac` (its live
sessions re-enter the front door and spill), recovery at
`recover_at_frac` rebuilds it and rejoins via a federation-wide epoch
rotation, and the report's `kill` block carries the full timeline —
killed_at → unhealthy_detected (probe/passive) → recover_started →
readmitted → first post-recovery completion (`region_recovery_s`).

The report (`<workdir>/federation_report.json`) extends the soak_report
schema: bench-record shaped, SIDE_METRICS flat on the record
(`open_loop_p99_s`, `region_recovery_s`, `spillover_rate`), `checks`
stamped by the shared specs in sim/report_checks.py.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import random
import time

from handel_tpu_torch.core.logging import DEFAULT_LOGGER, Logger
from handel_tpu_torch.core.test_harness import FakeScheme
from handel_tpu_torch.core.trace import FlightRecorder
from handel_tpu_torch.obs import AlertPlane, BurnRule, EwmaDetector, MadDetector
from handel_tpu_torch.service.fairness import DEFAULT_TIER, TIERS
from handel_tpu_torch.service.federation import Federation
from handel_tpu_torch.service.session import STATE_DONE
from handel_tpu_torch.sim.report_checks import FEDERATION_CHECKS, attach


def _quantile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


# -- arrival models -----------------------------------------------------------


def rate_at(p, t: float) -> float:
    """Instantaneous arrival rate (sessions/s) of model `p` at offset t."""
    if p.model == "diurnal":
        return p.rate_sps * (
            1.0
            + p.diurnal_amplitude
            * math.sin(2.0 * math.pi * t / p.diurnal_period_s)
        )
    if p.model == "burst":
        in_burst = (t % p.burst_every_s) < p.burst_len_s
        return p.rate_sps * (p.burst_x if in_burst else 1.0)
    return p.rate_sps  # poisson


def peak_rate(p) -> float:
    if p.model == "diurnal":
        return p.rate_sps * (1.0 + p.diurnal_amplitude)
    if p.model == "burst":
        return p.rate_sps * max(1.0, p.burst_x)
    return p.rate_sps


def arrival_offsets(p) -> list[float]:
    """Seeded arrival clock: offsets (s) into the load window.

    Lewis-Shedler thinning — candidate arrivals at the peak rate, each
    accepted with probability rate(t)/peak — keeps the nonhomogeneous
    models exact, and one `random.Random(seed)` stream keeps the whole
    trace reproducible run over run."""
    rng = random.Random(p.seed * 1_000_003 + 17)
    peak = peak_rate(p)
    out: list[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= p.duration_s:
            return out
        if rng.random() * peak <= rate_at(p, t):
            out.append(t)


# -- per-arrival record -------------------------------------------------------


class SessionRecord:
    """One open-loop arrival, from its clock tick to its attributed end.

    outcome: None while in flight, then exactly one of "completed",
    "shed" (every region at its shed bound through the retry budget),
    "failed" (every region dead through the budget), or "expired"
    (admitted but hit the region's session TTL). The report's
    zero-dropped check is precisely `sum(outcomes) == arrivals`."""

    __slots__ = ("idx", "origin", "tier", "t_arrival", "t_done", "outcome",
                 "region", "attempts", "spilled", "rerouted")

    def __init__(self, idx: int, origin: str, tier: str | None,
                 t_arrival: float):
        self.idx = idx
        self.origin = origin
        self.tier = tier
        self.t_arrival = t_arrival
        self.t_done: float | None = None
        self.outcome: str | None = None
        self.region: str | None = None
        self.attempts = 0
        self.spilled = False
        self.rerouted = 0  # times a region kill handed it back

    def latency_s(self) -> float | None:
        if self.t_done is None:
            return None
        return self.t_done - self.t_arrival


class LoadRun:
    """One open-loop run: build the federation, replay the arrival trace,
    drive the chaos timeline, emit the report. Split from the CLI so
    tests and the bench can run short traces in-process."""

    def __init__(self, load_p, fed_p, alert_p=None,
                 logger: Logger = DEFAULT_LOGGER):
        self.lp = load_p
        self.fp = fed_p
        self.ap = alert_p
        self.log = logger
        self.rec = FlightRecorder(capacity=fed_p.trace_capacity)
        self.scheme = FakeScheme()
        self.fed = Federation(
            fed_p, scheme=self.scheme, recorder=self.rec, logger=logger
        )
        if fed_p.kill_region and fed_p.kill_region not in self.fed.by_name:
            raise ValueError(
                f"federation.kill_region {fed_p.kill_region!r} not in "
                f"planet {fed_p.planet!r} "
                f"(regions: {', '.join(self.fed.region_names())})"
            )
        self.records: list[SessionRecord] = []
        self._live: dict[tuple[str, str], SessionRecord] = {}
        self._tiers = [
            t.strip() for t in load_p.tiers.split(",") if t.strip()
        ]
        # origin sampling gets its own stream so adding a region never
        # perturbs the arrival clock for a given seed
        self._origin_rng = random.Random(load_p.seed * 1_000_003 + 29)
        self._tasks: set[asyncio.Task] = set()
        self.interrupted_ct = 0
        # chaos timeline (monotonic timestamps)
        self.kill_t: float | None = None
        self.recover_start_t: float | None = None
        self.recovery_first_completion_t: float | None = None
        self.rotation_stall_s = 0.0
        self.t0 = 0.0
        # detection-and-incident plane (obs/): burn rules over
        # the tier/goodput/shed planes + the region-health detector the
        # chaos drill validates
        self.alerts: AlertPlane | None = (
            self._build_alert_plane() if alert_p is not None
            and alert_p.enabled else None
        )
        # hierarchical roll-ups (obs/rollup.py): one HostRollup per
        # region "host", one FleetRollup on this master — the fleet's
        # hosts-up series joins the SAME alert plane, so a region kill
        # correlates into the one region-health incident with the lost
        # host named in the attribution
        self.host_rollups, self.fleet = self._build_rollups()
        self._last_rollup_emit = 0.0
        if self.alerts is not None:
            self.fleet.attach_alerts(
                self.alerts,
                z_threshold=alert_p.z_threshold,
                ewma_alpha=alert_p.ewma_alpha,
                min_consecutive=alert_p.min_consecutive,
            )

    def _build_rollups(self):
        from handel_tpu_torch.obs.rollup import FleetRollup, HostRollup

        top_k = self.ap.rollup_top_k if self.ap is not None else 8
        stale = self.ap.rollup_stale_s if self.ap is not None else 5.0
        hosts: dict[str, HostRollup] = {}
        for name, region in self.fed.by_name.items():
            hr = HostRollup(name, top_k=top_k)

            def region_fold(region=region):
                return [(region.stats(), self.fed.labeled_gauge_keys())]

            hr.attach_fold("region", region_fold)

            def session_fold(region=region):
                m = region.cluster.manager
                return ((vals, m.labeled_gauge_keys())
                        for vals in m.labeled_values().values())

            hr.attach_fold("sessions", session_fold)

            def device_fold(region=region):
                plane = region.cluster.service.plane
                return ((vals, plane.labeled_gauge_keys())
                        for vals in plane.labeled_values().values())

            hr.attach_fold("device", device_fold)
            hr.watch(
                f"{name}-queue-depth",
                lambda region=region: float(
                    region.cluster.service.queue_depth()
                ),
            )
            hosts[name] = hr
        return hosts, FleetRollup(top_k=top_k, stale_after_s=stale)

    def _rollup_emit(self, now: float) -> None:
        """Per-region digest deltas -> chunked wire form -> the fleet.
        A killed region stops emitting (its process would be gone), so
        the fleet marks it lost and the hosts-up series pages."""
        self._last_rollup_emit = now
        for name, hr in self.host_rollups.items():
            if self.fed.by_name[name].killed:
                self.fleet.mark_lost(name)
                continue
            hr.emit(self.fleet.ingest)

    # -- the alert plane ----------------------------------------------------

    def _tier_counts(self, tier: str) -> tuple[float, float]:
        """Cumulative (good, bad) for one tier's burn rule: a resolved
        arrival is good iff it completed inside the tier's p99 target —
        sheds/failures/expiries burn the tier's budget too (an arrival the
        service turned away is an SLO miss the user saw)."""
        target = TIERS.get(tier, DEFAULT_TIER).p99_target_s
        good = bad = 0
        for r in self.records:
            if r.outcome is None or (r.tier or "standard") != tier:
                continue
            if r.outcome == "completed" and r.latency_s() <= target:
                good += 1
            else:
                bad += 1
        return float(good), float(bad)

    def _goodput_counts(self) -> tuple[float, float]:
        good = bad = 0
        for r in self.records:
            if r.outcome is None:
                continue
            if (
                r.outcome == "completed"
                and r.latency_s() <= self.lp.deadline_s
            ):
                good += 1
            else:
                bad += 1
        return float(good), float(bad)

    def _shed_counts(self) -> tuple[float, float]:
        shed = sum(1 for r in self.records if r.outcome == "shed")
        other = sum(
            1 for r in self.records
            if r.outcome is not None and r.outcome != "shed"
        )
        return float(other), float(shed)

    def _unhealthy_regions(self) -> list[str]:
        return [
            name for name, vals in self.fed.labeled_values().items()
            if vals.get("regionHealthy", 1.0) < 1.0
        ]

    def _build_alert_plane(self) -> AlertPlane:
        ap = self.ap
        plane = AlertPlane.from_params(
            ap, recorder=self.rec,
            trace_source=lambda: self.rec.export()["traceEvents"],
        )
        ev = plane.evaluator
        for tier in dict.fromkeys(self._tiers or ["standard"]):
            ev.add_rule(
                BurnRule(f"tier-{tier}-p99", budget=0.01,
                         page_x=ap.page_x, warn_x=ap.warn_x,
                         description=f"99% of {tier} arrivals inside "
                                     "the tier p99 target"),
                lambda t=tier: self._tier_counts(t),
            )
        ev.add_rule(
            BurnRule("goodput", budget=1.0 - ap.goodput_slo,
                     page_x=ap.page_x, warn_x=ap.warn_x,
                     description="deadline-met fraction of all arrivals"),
            self._goodput_counts,
        )
        ev.add_rule(
            BurnRule("shed", budget=self.fp.shed_ceiling,
                     page_x=ap.page_x, warn_x=ap.warn_x,
                     description="attributed sheds under the federation "
                                 "shed ceiling"),
            self._shed_counts,
        )
        # the drill signal: a region dropping out of the healthy count is
        # a step the EWMA catches in one tick; hold_while keeps the
        # detection (and its incident) open until the region is back
        plane.detectors.attach(
            "region-health",
            lambda: self.fed.values()["regionsHealthy"],
            EwmaDetector(alpha=ap.ewma_alpha, z_threshold=ap.z_threshold),
            min_consecutive=ap.min_consecutive,
            opens_incident=True,
            direction="down",
            hold_while=lambda: bool(self._unhealthy_regions()),
        )
        # context series: anomalous values land in attribution snapshots
        # but never open incidents on their own
        plane.detectors.attach(
            "open-loop-p99",
            lambda: self.values()["openLoopP99S"] or None,
            MadDetector(z_threshold=ap.z_threshold, seed=ap.seed),
            min_consecutive=max(2, ap.min_consecutive),
            direction="up",
        )
        plane.detectors.attach(
            "frontdoor-markdowns",
            lambda: self.fed.values()["markdownCt"],
            EwmaDetector(alpha=ap.ewma_alpha, z_threshold=ap.z_threshold),
            min_consecutive=ap.min_consecutive,
            direction="up",
        )
        plane.add_context("unhealthy_regions", self._unhealthy_regions)
        plane.add_context(
            "front_door",
            lambda: {
                "markdowns": self.fed.front_door.markdowns,
                "retries": self.fed.front_door.retries,
                "spillovers": self.fed.front_door.spillovers,
            },
        )
        # region incident -> front-door mark-down: the incident plane is
        # a health signal beside the probes (FrontDoor.mark dedups, so a
        # probe-detected death just makes this a no-op)
        def on_incident(event: str, inc) -> None:
            if event != "open":
                return
            for name in inc.attribution.get("unhealthy_regions", []):
                self.fed.front_door.mark(name, False)

        plane.incidents.add_listener(on_incident)
        return plane

    async def _alert_loop(self) -> None:
        while True:
            await asyncio.sleep(self.ap.tick_interval_s)
            now = time.monotonic()
            for hr in self.host_rollups.values():
                hr.tick(now)
            if now - self._last_rollup_emit >= self.ap.rollup_interval_s:
                self._rollup_emit(now)
            self.alerts.tick()

    # -- arrival path -------------------------------------------------------

    def _spawn(self, coro) -> None:
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def _on_done(self, rec: SessionRecord):
        def cb(sess) -> None:
            now = time.monotonic()
            rec.t_done = now
            rec.outcome = (
                "completed" if sess.state == STATE_DONE else "expired"
            )
            self._live.pop((rec.region, sess.sid), None)
            if (
                rec.outcome == "completed"
                and rec.region == self.fp.kill_region
                and self.recover_start_t is not None
                and self.recovery_first_completion_t is None
            ):
                # the recovery check's evidence: the rejoined region is
                # not just marked healthy, it is COMPLETING work again
                self.recovery_first_completion_t = now
        return cb

    async def _arrive(self, rec: SessionRecord) -> None:
        outcome, sess, plane, attempts = await self.fed.submit(
            rec.origin, nodes=self.lp.nodes, tier=rec.tier,
            seed=rec.idx, on_done=self._on_done(rec),
        )
        rec.attempts += attempts
        if outcome == "admitted":
            rec.region = plane.name
            if plane.name != self.fed.front_door._order[rec.origin][0]:
                rec.spilled = True
            self._live[(plane.name, sess.sid)] = rec
        else:  # "shed" | "failed" — attributed, never silent
            rec.outcome = outcome
            rec.t_done = time.monotonic()

    # -- chaos timeline -----------------------------------------------------

    def _kill_and_reroute(self) -> None:
        region = self.fp.kill_region
        self.kill_t = time.monotonic()
        live_sids = self.fed.kill_region(region)
        # sessions the kill interrupted mid-flight re-enter the front
        # door: their arrival clock does NOT reset, so their open-loop
        # latency carries the disruption they lived through
        for sid in live_sids:
            rec = self._live.pop((region, sid), None)
            if rec is None:
                continue
            rec.region = None
            rec.rerouted += 1
            self.interrupted_ct += 1
            self._spawn(self._arrive(rec))
        self.log.info(
            "load",
            f"killed {region}: {len(live_sids)} live sessions re-routed",
        )

    async def _chaos(self, duration_s: float) -> None:
        fp = self.fp
        await asyncio.sleep(fp.kill_at_frac * duration_s)
        self._kill_and_reroute()
        await asyncio.sleep(
            (fp.recover_at_frac - fp.kill_at_frac) * duration_s
        )
        self.recover_start_t = time.monotonic()
        self.rotation_stall_s = await self.fed.recover_region(
            fp.kill_region
        )
        self.log.info(
            "load",
            f"recovered {fp.kill_region} "
            f"(epoch {self.fed.epoch}, worst stall "
            f"{self.rotation_stall_s * 1e3:.1f}ms)",
        )

    # -- the run ------------------------------------------------------------

    async def run(self) -> dict:
        lp, fp = self.lp, self.fp
        offsets = arrival_offsets(lp)
        regions = self.fed.region_names()
        self.t0 = t0 = time.monotonic()
        self.fed.start()
        chaos = (
            asyncio.ensure_future(self._chaos(lp.duration_s))
            if fp.kill_region
            else None
        )
        alert_task = (
            asyncio.ensure_future(self._alert_loop())
            if self.alerts is not None
            else None
        )
        try:
            for i, off in enumerate(offsets):
                ahead = off - (time.monotonic() - t0)
                if ahead > 0:
                    await asyncio.sleep(ahead)
                tier = (
                    self._tiers[i % len(self._tiers)]
                    if self._tiers
                    else None
                )
                rec = SessionRecord(
                    i, self._origin_rng.choice(regions), tier,
                    time.monotonic(),
                )
                self.records.append(rec)
                self._spawn(self._arrive(rec))
            if chaos is not None:
                await chaos
            await self._drain()
            await self._await_incident_close()
        finally:
            if chaos is not None:
                chaos.cancel()
            if alert_task is not None:
                alert_task.cancel()
            await self.fed.stop()
        wall = time.monotonic() - t0
        return self._report(wall)

    async def _await_incident_close(self) -> None:
        """After drain, give an open incident its min-hold of quiet so a
        recovered drill run reports closed incidents, not a snapshot taken
        mid-hold (bounded — a genuinely stuck condition still reports)."""
        if self.alerts is None or self.alerts.incidents.current is None:
            return
        deadline = (
            time.monotonic() + self.ap.min_hold_s
            + 20.0 * self.ap.tick_interval_s
        )
        while (
            self.alerts.incidents.current is not None
            and time.monotonic() < deadline
        ):
            await asyncio.sleep(self.ap.tick_interval_s)

    async def _drain(self) -> None:
        """Let in-flight routing finish and every admitted session reach
        its verdict (TTL bounds the tail)."""
        while self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
        deadline = time.monotonic() + self.fp.session_ttl_s + 30.0
        while self._live and time.monotonic() < deadline:
            await asyncio.sleep(0.05)

    # -- live telemetry (register_values plane "load") ----------------------

    def values(self) -> dict[str, float]:
        done = sorted(
            r.latency_s() for r in self.records if r.outcome == "completed"
        )
        arrivals = len(self.records)
        met = sum(
            1 for r in self.records
            if r.outcome == "completed"
            and r.latency_s() <= self.lp.deadline_s
        )
        return {
            "arrivals": float(arrivals),
            "arrivalSps": float(self.lp.rate_sps),
            "completed": float(len(done)),
            "shed": float(
                sum(1 for r in self.records if r.outcome == "shed")
            ),
            "failed": float(
                sum(1 for r in self.records if r.outcome == "failed")
            ),
            "openLoopP50S": _quantile(done, 0.50),
            "openLoopP99S": _quantile(done, 0.99),
            "goodput": met / arrivals if arrivals else 0.0,
        }

    def gauge_keys(self) -> set[str]:
        return {"arrivalSps", "openLoopP50S", "openLoopP99S", "goodput"}

    # -- the report ---------------------------------------------------------

    def _tier_quantiles(self) -> dict[str, dict[str, float]]:
        """Per-SLO-tier OPEN-LOOP latency (arrival→verdict — strictly
        harsher than the manager's start→verdict buckets) against the
        tier's p99 target."""
        buckets: dict[str, list[float]] = {}
        for r in self.records:
            if r.outcome == "completed":
                buckets.setdefault(r.tier or "standard", []).append(
                    r.latency_s()
                )
        out: dict[str, dict[str, float]] = {}
        for tier, vals in buckets.items():
            done = sorted(vals)
            target = TIERS.get(tier, DEFAULT_TIER).p99_target_s
            p99 = _quantile(done, 0.99)
            out[tier] = {
                "completed": float(len(done)),
                "p50_s": _quantile(done, 0.50),
                "p99_s": p99,
                "target_s": target,
                "met": 1.0 if p99 <= target else 0.0,
            }
        return out

    def _kill_block(self) -> dict | None:
        if not self.fp.kill_region:
            return None
        fd = self.fed.front_door
        region = self.fp.kill_region

        def rel(t: float | None) -> float | None:
            return round(t - self.t0, 3) if t is not None else None

        recovery_s = None
        if (
            self.recover_start_t is not None
            and self.recovery_first_completion_t is not None
        ):
            recovery_s = round(
                self.recovery_first_completion_t - self.recover_start_t, 3
            )
        post = sum(
            1 for r in self.records
            if r.outcome == "completed" and r.region == region
            and self.recover_start_t is not None
            and r.t_done >= self.recover_start_t
        )
        return {
            "region": region,
            "killed_at_s": rel(self.kill_t),
            "unhealthy_detected_s": rel(fd.unhealthy_at.get(region)),
            "recover_started_s": rel(self.recover_start_t),
            "readmitted_s": rel(fd.rehealthy_at.get(region)),
            "recovery_s": recovery_s,
            "post_recovery_completed": post,
            "interrupted_rerouted": self.interrupted_ct,
            "rotation_stall_ms": round(self.rotation_stall_s * 1e3, 3),
        }

    def _alert_block(self) -> tuple[dict | None, float, float]:
        """(nested alerts block, detection_latency_ms,
        false_positive_rate). Detection latency is first-incident-open
        minus region-kill time; an open with no kill in flight (or before
        it) is a false positive — clean control runs must report 0.0 by
        opening nothing at all."""
        if self.alerts is None:
            return None, 0.0, 0.0
        log = self.alerts.incidents
        expected = 0
        latency_ms = 0.0
        for inc in log.incidents:
            if self.kill_t is not None and inc.opened_at >= self.kill_t:
                expected += 1
                if expected == 1:
                    latency_ms = round(
                        (inc.opened_at - self.kill_t) * 1e3, 3
                    )
        total = len(log.incidents)
        fp_rate = (total - expected) / total if total else 0.0
        ev = self.alerts.evaluator
        block = {
            "rules": {
                name: {
                    "state": state,
                    "burn_fast": round(ev.burns(name)[0], 4),
                    "burn_slow": round(ev.burns(name)[1], 4),
                }
                for name, state in ev.states().items()
            },
            "report": log.to_report(self.t0),
        }
        return block, latency_ms, round(fp_rate, 4)

    def _fleet_block(self, wall_s: float) -> dict:
        """The hierarchical roll-up summary: each region is one host, the
        master's FleetRollup merged their digests over the run. Series
        count is O(key-union across hosts) — the flatness of
        `series_total` across load sweeps is the O(hosts) contract."""
        series = self.fleet.series_count()  # merges -> fresh lastMergeMs
        fv = self.fleet.values()
        bytes_total = fv["ingestBytesCt"]
        hosts = max(1, len(self.host_rollups))
        return {
            "hosts": sorted(self.host_rollups),
            "hosts_up": self.fleet.hosts_up(),
            "lost_hosts": self.fleet.lost_hosts(),
            "series_total": series,
            "ingests": fv["ingestsCt"],
            "ingest_bytes": bytes_total,
            "rollup_bytes_per_host_s": round(
                bytes_total / hosts / max(wall_s, 1e-9), 1
            ),
            "fleet_eval_ms": fv["lastMergeMs"],
        }

    def _report(self, wall_s: float) -> dict:
        lp, fp = self.lp, self.fp
        fd = self.fed.front_door
        arrivals = len(self.records)
        by_outcome = {"completed": 0, "shed": 0, "failed": 0, "expired": 0}
        unresolved = 0
        for r in self.records:
            if r.outcome is None:
                unresolved += 1
            else:
                by_outcome[r.outcome] += 1
        accounted = sum(by_outcome.values()) + unresolved
        done = sorted(
            r.latency_s() for r in self.records if r.outcome == "completed"
        )
        met = sum(
            1 for r in self.records
            if r.outcome == "completed"
            and r.latency_s() <= lp.deadline_s
        )
        tiers = self._tier_quantiles()
        # the headline is the GOLD tier's open-loop p99 — the strictest
        # promise — falling back to the all-tier p99 on untiered runs
        p99 = (
            tiers["gold"]["p99_s"] if "gold" in tiers
            else _quantile(done, 0.99)
        )
        kill = self._kill_block()
        alerts, detect_ms, fp_rate = self._alert_block()
        report = {
            # bench-record shape (scripts/bench_check.py): headline +
            # SIDE_METRICS keys flat on the record, detail nested
            "metric": "open_loop_p99_s",
            "value": p99,
            "backend": "cpu",
            "captured_at": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            "open_loop_p99_s": p99,
            "open_loop_p50_s": _quantile(done, 0.50),
            # session-level shed rate: attributed shed arrivals over all
            # arrivals (the candidate-level rate is per-region in stats)
            "shed_rate": round(
                by_outcome["shed"] / arrivals, 4
            ) if arrivals else 0.0,
            "region_recovery_s": (kill or {}).get("recovery_s") or 0.0,
            "spillover_rate": round(
                fd.spillovers / arrivals, 4
            ) if arrivals else 0.0,
            "goodput": round(met / arrivals, 4) if arrivals else 0.0,
            "detection_latency_ms": detect_ms,
            "false_positive_rate": fp_rate,
            "alerts": alerts,
            "federation": {
                "planet": fp.planet,
                "model": lp.model,
                "rate_sps": lp.rate_sps,
                "duration_s": lp.duration_s,
                "wall_s": round(wall_s, 3),
                "deadline_s": lp.deadline_s,
                "arrivals": arrivals,
                "completed": by_outcome["completed"],
                "shed": by_outcome["shed"],
                "failed": by_outcome["failed"],
                "expired": by_outcome["expired"],
                "unresolved": unresolved,
                "unaccounted": arrivals - accounted,
                "deadline_met": met,
                "spillovers": fd.spillovers,
                "front_door_retries": fd.retries,
                "probe_rounds": fd.probe_rounds,
                "shed_ceiling": fp.shed_ceiling,
                "tiers": tiers,
                "kill": kill,
                "epoch": self.fed.epoch,
                "regions": {
                    name: vals
                    for name, vals in self.fed.labeled_values().items()
                },
            },
            "fleet": self._fleet_block(wall_s),
        }
        # shared invariant specs (sim/report_checks.py): the same
        # predicates load_smoke re-asserts stamp `checks` + `ok`
        return attach(report, FEDERATION_CHECKS)


async def run_load(load_p, fed_p, workdir: str,
                   logger: Logger = DEFAULT_LOGGER,
                   metrics_port: int | None = None,
                   alert_p=None) -> dict:
    """Run one open-loop trace and persist
    `<workdir>/federation_report.json` (+ the region-tagged trace dump
    beside it for `sim trace --critical-path`, and
    `incident_report.json` when the alert plane is on)."""
    os.makedirs(workdir, exist_ok=True)
    run = LoadRun(load_p, fed_p, alert_p=alert_p, logger=logger)
    server = None
    if metrics_port is not None:
        from handel_tpu_torch.core.metrics import MetricsRegistry, MetricsServer

        reg = MetricsRegistry(
            series_cap=alert_p.series_cap if alert_p is not None else 0,
        )
        reg.register_values("federation", run.fed)
        reg.register_labeled_values(
            "federation", run.fed, label="region",
            gauges=run.fed.labeled_gauge_keys(),
        )
        reg.register_values("load", run)
        # handel_fleet_* families + the /fleet JSON endpoint, fed by the
        # per-region HostRollup digests the alert loop emits
        run.fleet.register_metrics(reg)
        if run.alerts is not None:
            run.alerts.register_metrics(reg)
        reg.add_readiness("federation_up", lambda: True)
        server = MetricsServer(reg, port=metrics_port).start()
    try:
        report = await run.run()
    finally:
        if server is not None:
            server.stop()
    path = os.path.join(workdir, "federation_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
    if report.get("alerts") is not None:
        incident_path = os.path.join(workdir, "incident_report.json")
        with open(incident_path, "w") as f:
            json.dump(
                {
                    "detection_latency_ms": report["detection_latency_ms"],
                    "false_positive_rate": report["false_positive_rate"],
                    "kill": report["federation"]["kill"],
                    **report["alerts"],
                },
                f, indent=1,
            )
            f.write("\n")
    # trace_* naming so `sim trace <workdir> --critical-path` resolves it
    run.rec.dump(os.path.join(workdir, "trace_federation.json"))
    fed = report["federation"]
    logger.info(
        "load",
        f"{'OK' if report['ok'] else 'FAILED'} "
        f"{fed['completed']}/{fed['arrivals']} arrivals completed "
        f"p99={report['open_loop_p99_s']:.3f}s "
        f"goodput={report['goodput']:.4f} "
        f"spill={report['spillover_rate']:.4f} "
        f"shed={report['shed_rate']:.4f} -> {path}",
    )
    return report
