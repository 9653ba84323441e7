"""`python -m handel_tpu_torch.sim soak`, the lifecycle plane's CI proof: a
copy of handel_tpu/sim/soak.py.

A ~90 s continuously-loaded service run that exercises every production
lifecycle mechanism (lifecycle/) mid-flight and writes a
bench-record-shaped `soak_report.json`:

- **sustained load** — a spawner keeps `concurrency` tiered sessions live
  for `duration_s`; every completion immediately back-fills, so the shared
  verify plane never idles.
- **mid-run epoch swap** — at `swap_at_frac` the EpochManager stages an
  identically-sized registry on every lane engine, quiesces, and flips.
  The registry CONTENT is unchanged (correctness trivially holds under the
  fake scheme); what the soak measures is the mechanics: the gate-closed
  stall, and that no launch gap around the swap exceeds twice the
  steady-state inter-launch p50 (+ a small timer-jitter floor).
- **forced lane loss** — at `lane_loss_at_frac` lane 0's breaker is
  tripped open; the LifecycleController's next autoscaler tick must
  replace it (attach first, drain second) with per-tenant p99 still
  inside every tier's SLO target.
- **zero dropped work** — every spawned session must reach a terminal
  verdict; `sessions_expired == 0` and nothing left live at exit.

Launch times are measured by tapping each lane engine's `dispatch_multi`
(exact, immune to flight-recorder ring eviction); the autotuner is fed
the causal tracer's real `stages_ms` attribution recomputed from the live
recorder every `autotune_every_s`.
"""

from __future__ import annotations

import asyncio
import json
import os
import time

from handel_tpu_torch.core.logging import DEFAULT_LOGGER
from handel_tpu_torch.core.trace import FlightRecorder
from handel_tpu_torch.lifecycle import (
    CriticalPathAutotuner,
    EpochManager,
    LaneAutoscaler,
    LifecycleController,
)
from handel_tpu_torch.models.fake import FakeScheme
from handel_tpu_torch.obs import AlertPlane, EwmaDetector
from handel_tpu_torch.service.driver import HostDevice, MultiSessionCluster
from handel_tpu_torch.sim.report_checks import SOAK_CHECKS, attach

# scheduling-jitter floor for the swap-gap bound: a CI hypervisor can
# stretch any 2 ms sleep past 2x p50 with no swap involved at all
JITTER_FLOOR_MS = 10.0


def _tap_engine(engine, times: list, clock=time.monotonic):
    """Record a wall timestamp per dispatch — the exact launch times the
    gap analysis runs over."""
    orig = engine.dispatch_multi

    def wrapped(items, _orig=orig):
        times.append(clock())
        return _orig(items)

    engine.dispatch_multi = wrapped
    return engine


def _quantile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


def _gap_analysis(times: list[float], swap_t: float | None) -> dict:
    """Inter-launch gaps (ms): steady-state p50/p99/max plus the single
    gap straddling the epoch swap. The swap gap is EXCLUDED from the
    steady-state stats — it is the thing being compared against them."""
    ts = sorted(times)
    gaps = [
        (b - a) * 1e3 for a, b in zip(ts, ts[1:])
    ]
    swap_gap_ms = 0.0
    if swap_t is not None:
        for i, (a, b) in enumerate(zip(ts, ts[1:])):
            if a <= swap_t <= b:
                swap_gap_ms = gaps.pop(i)
                break
    gaps.sort()
    return {
        "launches": len(ts),
        "gap_p50_ms": round(_quantile(gaps, 0.50), 3),
        "gap_p99_ms": round(_quantile(gaps, 0.99), 3),
        "gap_max_ms": round(gaps[-1], 3) if gaps else 0.0,
        "swap_gap_ms": round(swap_gap_ms, 3),
    }


class SoakRun:
    """One soak: build the cluster + lifecycle plane, drive the timeline,
    emit the report. Split from the CLI so tests can run short soaks
    in-process with deterministic knobs."""

    def __init__(self, p, alert_p=None, logger=DEFAULT_LOGGER):
        self.p = p
        self.ap = alert_p
        self.log = logger
        self.launch_times: list[float] = []
        self.scheme = FakeScheme()
        self.rec = FlightRecorder(capacity=p.trace_capacity)
        self.cluster = MultiSessionCluster(
            sessions=0,  # the spawner drives arrivals, not cluster.run()
            nodes=p.nodes,
            scheme=self.scheme,
            devices=p.devices,
            batch_size=p.batch_size,
            max_sessions=max(2 * p.concurrency, 4),
            session_ttl_s=p.session_ttl_s,
            queue_capacity=p.queue_capacity,
            recorder=self.rec,
        )
        for lane in self.cluster.service.plane.lanes:
            _tap_engine(lane.engine, self.launch_times)
        self.epochs = EpochManager(
            self.cluster.service, self.cluster.manager, logger=logger
        )
        self.autoscaler = LaneAutoscaler(
            self.cluster.service,
            engine_factory=self._new_engine,
            # floor at the starting plane size: the lane-loss drill needs a
            # surviving lane while the replacement spins up
            min_lanes=p.devices,
            max_lanes=p.max_lanes,
            drain_timeout_s=5.0,  # a wedged drain must not stall the loop
            logger=logger,
        )
        self.autotuner = CriticalPathAutotuner(
            self.cluster.service, logger=logger
        )
        # detection-and-incident plane: the breaker-storm drill's witness,
        # ticked BY the controller so its autoscaler nudge lands in the
        # same control interval
        self.alerts: AlertPlane | None = (
            self._build_alert_plane()
            if alert_p is not None and alert_p.enabled else None
        )
        self.host_rollup = self._build_host_rollup()
        self.controller = LifecycleController(
            self.cluster.service,
            autoscaler=self.autoscaler,
            autotuner=self.autotuner,
            epoch_manager=self.epochs,
            alert_plane=self.alerts,
            host_rollup=self.host_rollup,
            report_source=self._stage_report,
            interval_s=p.control_interval_s,
            logger=logger,
        )
        self._tiers = [
            t.strip() for t in p.tiers.split(",") if t.strip()
        ]
        self._spawned = 0
        self._last_report: dict | None = None
        self._last_report_t = 0.0
        self.swap_t: float | None = None
        self.swap_stall_s = 0.0
        self.lane_lost_index: int | None = None
        self.lane_loss_t: float | None = None
        self.t0 = 0.0

    # -- the alert plane ----------------------------------------------------

    def _open_breaker_lanes(self) -> list[int]:
        return [
            l.index for l in self.cluster.service.plane.lanes
            if l.breaker.state == "open"
        ]

    def _build_alert_plane(self) -> AlertPlane:
        ap = self.ap
        plane = AlertPlane.from_params(
            ap, recorder=self.rec,
            trace_source=lambda: self.rec.export()["traceEvents"],
        )
        # the drill signal: breaker transitions are ~0/tick in steady
        # state, so a storm's burst of closed->open flips is a step the
        # EWMA catches immediately; hold_while keeps the incident open
        # until no lane is sitting on an open breaker
        plane.detectors.attach(
            "breaker-storm",
            lambda: self.cluster.service.values()["breakerTransitionsCt"],
            EwmaDetector(alpha=ap.ewma_alpha, z_threshold=ap.z_threshold),
            min_consecutive=ap.min_consecutive,
            opens_incident=True,
            direction="up",
            hold_while=lambda: bool(self._open_breaker_lanes()),
        )
        plane.detectors.attach(
            "queue-depth",
            lambda: float(self.cluster.service.queue_depth()),
            EwmaDetector(alpha=ap.ewma_alpha, z_threshold=ap.z_threshold),
            min_consecutive=max(2, ap.min_consecutive),
            direction="up",
        )
        plane.add_context("open_breaker_lanes", self._open_breaker_lanes)
        plane.add_context(
            "autoscaler",
            lambda: {
                "lanes": len(self.cluster.service.plane),
                "replaced": self.autoscaler.lanes_replaced,
            },
        )

        # breaker-storm incident -> repair-first scaling: the autoscaler's
        # next tick waives its grow/shrink cooldown
        def on_incident(event: str, inc) -> None:
            if event == "open" and "breaker" in inc.kind:
                self.autoscaler.notify_incident(inc.kind)

        plane.incidents.add_listener(on_incident)
        return plane

    def _build_host_rollup(self):
        """This process's hierarchical digest (obs/rollup.py): the
        per-session and per-lane surfaces fold to the key union, so the
        soak report (and any master this host reports to) carries one
        bounded block however many sessions the spawner churns through.
        Ticked by the LifecycleController on the control cadence."""
        from handel_tpu_torch.obs.rollup import HostRollup

        top_k = self.ap.rollup_top_k if self.ap is not None else 8
        hr = HostRollup("soak0", top_k=top_k)
        m = self.cluster.manager
        svc = self.cluster.service
        hr.attach_reporter("service", svc)
        hr.attach_fold("sessions", lambda: (
            (vals, m.labeled_gauge_keys())
            for vals in m.labeled_values().values()
        ))
        hr.attach_fold("device", lambda: (
            (vals, svc.plane.labeled_gauge_keys())
            for vals in svc.plane.labeled_values().values()
        ))
        hr.set_trace(lambda: self.rec.export()["traceEvents"])
        hr.watch("rollup-queue-depth", lambda: float(svc.queue_depth()))
        hr.watch("rollup-sessions-live", lambda: float(m.live_count()))
        return hr

    def _rollup_block(self) -> dict:
        """Nested rollup block: digest bounds + the wire budget a chunked
        delta emission costs at report time."""
        d = self.host_rollup.digest()
        nbytes = self.host_rollup.emit()
        return {
            "host": d["host"],
            "surfaces": d["surfaces"],
            "series": sum(len(d[s]) for s in ("counters", "gauges",
                                              "hists")),
            "delta_bytes": nbytes,
            "top_anomalous": d["anoms"],
        }

    def _alert_block(self) -> dict | None:
        """Nested alerts block: the drill's detection latency (first
        incident open after the forced storm) plus the incident report."""
        if self.alerts is None:
            return None
        log = self.alerts.incidents
        latency_ms = None
        for inc in log.incidents:
            if (
                self.lane_loss_t is not None
                and inc.opened_at >= self.lane_loss_t
            ):
                latency_ms = round(
                    (inc.opened_at - self.lane_loss_t) * 1e3, 3
                )
                break
        return {
            "detection_latency_ms": latency_ms,
            "incident_nudges": self.autoscaler.incident_nudges,
            "report": log.to_report(self.t0),
        }

    def _new_engine(self):
        return _tap_engine(
            HostDevice(self.scheme.constructor, batch_size=self.p.batch_size),
            self.launch_times,
        )

    def _stage_report(self) -> dict | None:
        """The autotuner's stage attribution: the causal tracer's real
        critical-path walk over the live ring, recomputed at most every
        `autotune_every_s` (the walk is O(ring), not free)."""
        now = time.monotonic()
        if now - self._last_report_t < self.p.autotune_every_s:
            return self._last_report
        self._last_report_t = now
        from handel_tpu_torch.sim.trace_cli import critical_path

        events = self.rec.export()["traceEvents"]
        self._last_report = critical_path(events)
        return self._last_report

    async def _spawner(self, t_end: float) -> None:
        """Hold `concurrency` sessions live until t_end, back-filling every
        completion; tiers deal round-robin so every SLO class is always
        represented in the mix."""
        m = self.cluster.manager
        while time.monotonic() < t_end:
            for sid, s in list(m.sessions.items()):
                if s.finished:
                    m.evict(sid)  # terminal verdict already banked
            while m.live_count() < self.p.concurrency:
                tier = (
                    self._tiers[self._spawned % len(self._tiers)]
                    if self._tiers
                    else None
                )
                s = m.spawn(
                    self.p.nodes,
                    seed=self._spawned,
                    tier=tier,
                    config_tweak=self._tweak,
                )
                m.start(s.sid)
                self._spawned += 1
            await asyncio.sleep(0.01)

    def _tweak(self, node_cfg, i):
        node_cfg.update_period = self.p.period_ms / 1000.0

    async def _rotate_epoch(self) -> None:
        """The mid-run swap: same-size registry (content irrelevant to the
        fake scheme), full stage -> quiesce -> flip choreography."""
        pubkeys = [
            self.scheme.keygen(i)[1] for i in range(self.p.registry)
        ]
        await self.epochs.begin_rotation(pubkeys)
        self.swap_t = time.monotonic()
        self.swap_stall_s = await self.epochs.commit_rotation()

    async def _force_lane_loss(self) -> None:
        """Trip lane 0's breaker open and wait for the controller's
        autoscaler tick to replace it."""
        lane = self.cluster.service.plane.lanes[0]
        self.lane_lost_index = lane.index
        self.lane_loss_t = time.monotonic()
        while lane.breaker.state != "open":
            lane.breaker.record_failure()
        # drive ticks directly (serialized against the background loop by
        # the controller lock) so a long drain in a prior interval can't
        # push the replacement past the drill window
        deadline = time.monotonic() + 15.0
        while (
            self.autoscaler.lanes_replaced < 1
            and time.monotonic() < deadline
        ):
            await self.controller.tick()
            await asyncio.sleep(0.1)

    async def run(self) -> dict:
        p = self.p
        self.t0 = t0 = time.monotonic()
        t_end = t0 + p.duration_s
        self.cluster.service.start()
        self.controller.start()
        spawner = asyncio.ensure_future(self._spawner(t_end))
        try:
            await asyncio.sleep(p.swap_at_frac * p.duration_s)
            await self._rotate_epoch()
            await asyncio.sleep(
                max(0.0, (p.lane_loss_at_frac - p.swap_at_frac) * p.duration_s)
            )
            await self._force_lane_loss()
            await spawner
            # drain: let the tail of live sessions reach their verdicts
            await self.cluster.manager.wait_all(p.session_ttl_s + 30.0)
            if self.alerts is not None:
                # a recovered drill should report a CLOSED incident: give
                # the controller its min-hold of quiet ticks (bounded)
                deadline = (
                    time.monotonic() + self.ap.min_hold_s
                    + 20.0 * p.control_interval_s
                )
                while (
                    self.alerts.incidents.current is not None
                    and time.monotonic() < deadline
                ):
                    await asyncio.sleep(p.control_interval_s)
        finally:
            spawner.cancel()
            await self.controller.stop()
        wall = time.monotonic() - t0
        return self._report(wall)

    def _report(self, wall_s: float) -> dict:
        p = self.p
        m = self.cluster.manager
        summary = self.cluster.summary(wall_s)
        gaps = _gap_analysis(self.launch_times, self.swap_t)
        tiers = m.tier_quantiles()
        unresolved = m.live_count()
        stall_ms = self.swap_stall_s * 1e3
        # the swap must hide inside the launch cadence the service already
        # exhibits: 2x the steady p50, or the steady p99 when session-wave
        # load makes the gap tail heavier than any swap, or the timer floor
        bound_ms = max(
            2 * gaps["gap_p50_ms"], gaps["gap_p99_ms"], JITTER_FLOOR_MS
        )
        soak_p99 = summary["session_p99_s"]
        report = {
            # bench-record shape (scripts/bench_check.py): headline +
            # SIDE_METRICS keys flat on the record, detail nested
            "metric": "soak_p99_s",
            "value": soak_p99,
            "backend": "cpu",
            "captured_at": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            "epoch_swap_stall_ms": round(stall_ms, 3),
            "soak_p99_s": soak_p99,
            "shed_rate": summary["shed_rate"],
            "aggregates_per_s": summary["aggregates_per_s"],
            "launch_fill_ratio": summary["launch_fill_ratio"],
            "soak": {
                "duration_s": p.duration_s,
                "wall_s": round(wall_s, 3),
                "sessions_spawned": self._spawned,
                "completed": summary["completed"],
                "expired": summary["expired"],
                "unresolved": unresolved,
                "swap_gap_bound_ms": round(bound_ms, 3),
                "epoch_rotations": self.epochs.rotations,
                "lane_lost": self.lane_lost_index,
                "lanes_replaced": self.autoscaler.lanes_replaced,
                "devices_floor": p.devices,
                "gaps": gaps,
                "tiers": tiers,
                # the causal attribution the autotuner last acted on
                "stages_ms": (self._last_report or {}).get("stages_ms", {}),
                "autotune_dominant": self.autotuner.last_dominant,
                "summary": summary,
                "lifecycle": self.controller.values(),
                "alerts": self._alert_block(),
                "rollup": self._rollup_block(),
            },
        }
        # the shared invariant specs (sim/report_checks.py) stamp `checks`
        # + `ok` — the same predicates soak_smoke re-asserts, so the
        # artifact and the gate can't drift
        return attach(report, SOAK_CHECKS)


async def run_soak(p, workdir: str, logger=DEFAULT_LOGGER,
                   alert_p=None) -> dict:
    """Run one soak and persist `<workdir>/soak_report.json`."""
    os.makedirs(workdir, exist_ok=True)
    run = SoakRun(p, alert_p=alert_p, logger=logger)
    try:
        report = await run.run()
    finally:
        run.cluster.stop()
    path = os.path.join(workdir, "soak_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
    logger.info(
        "soak",
        f"{'OK' if report['ok'] else 'FAILED'} "
        f"completed={report['soak']['completed']} "
        f"swap_stall={report['epoch_swap_stall_ms']:.2f}ms "
        f"p99={report['soak_p99_s']:.3f}s shed={report['shed_rate']:.4f} "
        f"-> {path}",
    )
    return report
