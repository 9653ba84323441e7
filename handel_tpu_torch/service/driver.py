"""Multi-session service drivers: one process or a small fleet of them — a
copy of handel_tpu/service/driver.py.

`MultiSessionCluster` is the in-process form — K concurrent sessions
(service/session.py) sharing ONE `BatchVerifierService` on one event loop,
with an optional /metrics endpoint carrying the session-labeled plane and
the `[alerts]` plane (obs/). `run_service` is the `sim serve` entry: it
reads the `[service]` TOML section (sim/config.py ServiceParams) and runs
the session load either in-process (processes = 1) or sharded over M
worker node-processes (service/worker.py), each worker multiplexing its
share of sessions onto its own shared verifier — "K sessions over M
node-processes".

`HostDevice` adapts host schemes (fake, BN254 reference math) to the
service's device contract so the WHOLE launch path — tenant queue, DRR
fairness, cross-session coalescing, fill accounting, breaker — runs
without a card: one `dispatch_multi` call is one "launch" whose lanes may
span sessions, messages and registries. A service over a card engine
plugs in the port's `BN254Device` instead (models/bn254_torch.py), as the
sim's node does; `serve` itself runs the fake or a host scheme and
refuses a device scheme with the reference's message, since its sessions
each bring their own registry. `mesh_devices = K` attaches the reference's
whole-mesh latency lane beside the throughput lanes: a `HostMeshDevice`
(parallel/mesh_plane.py) modeling one launch over K devices, which small
gold-tier groups ride.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time

from handel_tpu_torch.core.test_harness import FakeScheme
from handel_tpu_torch.models import rlc
from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
from handel_tpu_torch.service.session import SessionManager


class HostDevice:
    """Device-shaped host verifier behind the shared service.

    `dispatch_multi(items)` — items are (msg, pubkeys, bitset, sig) — runs
    the scheme constructor's own batch_verify per (message, registry)
    group, synchronously (the service calls it in an executor thread), and
    returns the verdicts handle `fetch` hands back. `launch_ms` simulates
    a fixed device wall per launch (latency-shape experiments); 0 = as
    fast as the host math goes.

    `batch_check="rlc"` switches the launch to the random-linear-
    combination combined check (models/rlc.py): one M+1-pairing equation
    over the whole launch, bisection with fresh scalars down to the
    per-candidate oracle when it fails. Schemes without an RLC ops table
    (the fake scheme) silently stay per-candidate.
    """

    def __init__(self, constructor, batch_size: int = 64,
                 launch_ms: float = 0.0,
                 batch_check: str = "per_candidate", rlc_rng=None):
        self.constructor = constructor
        self.batch_size = batch_size
        self.launch_ms = launch_ms
        self.batch_check = rlc.validate_batch_check(batch_check)
        self._rlc_rng = rlc_rng
        self._rlc_ops = (
            rlc.host_ops_for(constructor) if batch_check == "rlc" else None
        )
        self.rlc_stats = rlc.RlcStats()
        self.dispatched = 0
        # epoch-rotation protocol parity with the reference's BN254Device:
        # host verification reads per-request pubkeys so there is no
        # resident bank to flip, but the stage -> quiesce -> activate
        # choreography runs end to end
        self.epoch = 0
        self._staged = None
        self.registry_stagings = 0
        self.registry_staged_ms = 0.0

    def stage_registry(self, registry_pubkeys, build_prefix: bool = True) -> int:
        self._staged = registry_pubkeys
        self.registry_stagings += 1
        return len(registry_pubkeys)

    def activate_staged(self) -> int:
        if self._staged is None:
            raise RuntimeError("no staged registry: call stage_registry first")
        self._staged = None
        self.epoch += 1
        return self.epoch

    def dispatch_multi(self, items):
        if self._rlc_ops is not None:
            verdicts = self._rlc_dispatch_multi(items)
        else:
            verdicts = [False] * len(items)
            groups: dict[tuple, list[int]] = {}
            for i, (msg, pubkeys, _, _) in enumerate(items):
                groups.setdefault((msg, id(pubkeys)), []).append(i)
            for (msg, _), idxs in groups.items():
                pubkeys = items[idxs[0]][1]
                reqs = [(items[i][2], items[i][3]) for i in idxs]
                for i, ok in zip(
                    idxs, self.constructor.batch_verify(msg, pubkeys, reqs)
                ):
                    verdicts[i] = bool(ok)
            # per-candidate pairing cost, for the M+1 comparison: each
            # non-empty candidate is 2 Miller loops + 1 final exp
            live = sum(1 for it in items if it[2].cardinality() > 0)
            self.rlc_stats.miller_lanes += 2 * live
            self.rlc_stats.final_exp_lanes += live
        if self.launch_ms > 0:
            time.sleep(self.launch_ms / 1000.0)
        self.dispatched += 1
        return verdicts

    def _rlc_dispatch_multi(self, items):
        """RLC combined launch: aggregate each candidate's apk on the host,
        run one M+1-pairing check over every valid candidate (across
        message groups — that is the point), bisect on failure."""
        verdicts: list[bool] = [False] * len(items)
        cands: dict[int, tuple] = {}
        for i, (msg, pubkeys, bs, sig) in enumerate(items):
            if bs.cardinality() == 0 or getattr(sig, "point", None) is None:
                continue
            apk = self.constructor.aggregate_public_keys(pubkeys, bs)
            if getattr(apk, "point", None) is None:
                continue
            cands[i] = (msg, apk.point, sig.point)

        def combined(sub: list[int]) -> bool:
            return rlc.host_rlc_check(
                self._rlc_ops, [cands[i] for i in sub],
                rng=self._rlc_rng, stats=self.rlc_stats,
            )

        def oracle(i: int) -> bool:
            msg, pubkeys, bs, sig = items[i]
            self.rlc_stats.miller_lanes += 2
            self.rlc_stats.final_exp_lanes += 1
            return bool(
                self.constructor.batch_verify(msg, pubkeys, [(bs, sig)])[0]
            )

        for i, ok in rlc.bisect_verify(
            list(cands), combined, oracle, self.rlc_stats
        ).items():
            verdicts[i] = ok
        return verdicts

    def fetch(self, handle):
        return handle


class MultiSessionCluster:
    """K concurrent sessions sharing one BatchVerifierService in-process."""

    def __init__(
        self,
        sessions: int,
        nodes: int,
        *,
        threshold: int | None = None,
        scheme=None,
        device=None,
        batch_size: int = 64,
        max_sessions: int | None = None,
        session_ttl_s: float = 60.0,
        quantum: int = 8,
        max_pending_per_session: int = 4096,
        queue_capacity: int = 0,
        tier_cycle: tuple | list = (),
        max_delay_ms: float = 2.0,
        spawn_stagger_s: float = 0.0,
        metrics_port: int | None = None,
        seed_base: int = 0,
        config_tweak=None,
        devices: int = 1,
        mesh_devices: int = 0,
        mesh_batch_size: int = 8,
        batch_check: str = "per_candidate",
        recorder=None,
        alert_p=None,
    ):
        self.k = sessions
        self.nodes = nodes
        self.threshold = threshold
        self.spawn_stagger_s = spawn_stagger_s
        self.seed_base = seed_base
        self.config_tweak = config_tweak
        # SLO tiers (service/fairness.py TIERS) dealt round-robin across
        # the spawned sessions; empty = every tenant on the flat default
        self.tier_cycle = tuple(tier_cycle)
        scheme = scheme or FakeScheme()
        if device is None:
            if devices > 1:
                # fleet serve path ([service] devices = N): one host
                # engine per lane, scheduled least-loaded-first
                # (parallel/plane.py) so the tenant queue fills K lanes
                from handel_tpu_torch.parallel.plane import host_plane

                device = host_plane(
                    scheme.constructor, devices, batch_size=batch_size,
                    batch_check=batch_check,
                )
            else:
                device = HostDevice(
                    scheme.constructor, batch_size=batch_size,
                    batch_check=batch_check,
                )
        self.service = BatchVerifierService(
            device,
            max_delay_ms=max_delay_ms,
            quantum=quantum,
            max_pending_per_session=max_pending_per_session,
            queue_capacity=queue_capacity,
            recorder=recorder,
        )
        if mesh_devices > 0:
            # latency plane ([service] mesh_devices = K): one whole-mesh
            # lane beside the per-card throughput lanes — small gold-tier
            # launch groups ride it (parallel/mesh_plane.py ModePolicy)
            from handel_tpu_torch.parallel.mesh_plane import (
                enable_latency_plane,
                host_mesh_engine,
            )

            enable_latency_plane(
                self.service,
                host_mesh_engine(
                    scheme.constructor,
                    devices=mesh_devices,
                    batch_size=mesh_batch_size,
                ),
            )
        # one shared ring across every session's nodes AND the verify
        # plane: session-tagged spans end to end (core/handel.py _sargs,
        # batch_verifier.py lane lifecycle `sessions` arg)
        self.recorder = recorder
        self.manager = SessionManager(
            service=self.service,
            scheme=scheme,
            max_sessions=max_sessions or sessions,
            session_ttl_s=session_ttl_s,
            recorder=recorder,
        )

        # live telemetry (core/metrics.py): the shared verifier plane plus
        # the session-labeled service plane — `sim watch --attach` renders
        # the per-session rows from exactly these families
        self.metrics = None
        self.metrics_server = None
        if metrics_port is not None:
            from handel_tpu_torch.core.metrics import (
                MetricsRegistry,
                MetricsServer,
            )

            reg = MetricsRegistry()
            reg.register_values("device_verifier", self.service)
            # per-device rows beside the session dimension: one sample per
            # plane lane, e.g. handel_device_verifier_launches{device="3"}
            reg.register_labeled_values(
                "device_verifier", self.service.plane, label="device",
                gauges={"mode", "checkMode", "bisectionDepthMax"},
            )
            reg.register_values("service", self.manager)
            reg.register_labeled_values(
                "service",
                self.manager,
                label="session",
                gauges=self.manager.labeled_gauge_keys(),
            )
            reg.register_labeled_values(
                "penalty", self.manager.scorers, label="session"
            )
            reg.add_readiness(
                "sessions_spawned", lambda: self.manager.spawned_ct > 0
            )
            if recorder is not None:
                # ring occupancy / drops / span rate beside the service rows
                reg.register_values("trace", recorder)
            self.metrics = reg
            self.metrics_server = MetricsServer(reg, port=metrics_port).start()

        # serve-mode alert plane ([alerts] TOML section): breaker-storm
        # detection over the shared verify plane, ticked by run()'s loop
        # (serve has no LifecycleController) — /alerts and the
        # handel_alerts_*/handel_incidents_* families ride the same
        # metrics server as the session rows
        self.alerts = None
        self._alert_p = alert_p
        if alert_p is not None and alert_p.enabled:
            from handel_tpu_torch.obs import AlertPlane, EwmaDetector

            ap = AlertPlane.from_params(
                alert_p, recorder=recorder,
                trace_source=(
                    (lambda: recorder.export()["traceEvents"])
                    if recorder is not None else None
                ),
            )
            ap.detectors.attach(
                "breaker-storm",
                lambda: self.service.values()["breakerTransitionsCt"],
                EwmaDetector(alpha=alert_p.ewma_alpha,
                             z_threshold=alert_p.z_threshold),
                min_consecutive=alert_p.min_consecutive,
                opens_incident=True,
                direction="up",
                hold_while=lambda: any(
                    l.breaker.state == "open"
                    for l in self.service.plane.lanes
                ),
            )
            ap.detectors.attach(
                "queue-depth",
                lambda: float(self.service.queue_depth()),
                EwmaDetector(alpha=alert_p.ewma_alpha,
                             z_threshold=alert_p.z_threshold),
                min_consecutive=max(2, alert_p.min_consecutive),
                direction="up",
            )
            ap.add_context(
                "open_breaker_lanes",
                lambda: [
                    l.index for l in self.service.plane.lanes
                    if l.breaker.state == "open"
                ],
            )
            self.alerts = ap
            if self.metrics is not None:
                ap.register_metrics(self.metrics)

    async def _alert_loop(self) -> None:
        while True:
            await asyncio.sleep(self._alert_p.tick_interval_s)
            self.alerts.tick()

    async def run(self, timeout: float = 120.0) -> dict:
        """Spawn + start every session, await all terminal states, and
        return the run summary (the bench/capture record shape)."""
        t0 = time.perf_counter()
        alert_task = (
            asyncio.ensure_future(self._alert_loop())
            if self.alerts is not None
            else None
        )
        try:
            for i in range(self.k):
                s = self.manager.spawn(
                    self.nodes,
                    threshold=self.threshold,
                    seed=self.seed_base + i,
                    config_tweak=self.config_tweak,
                    tier=self.tier_cycle[i % len(self.tier_cycle)]
                    if self.tier_cycle
                    else None,
                )
                self.manager.start(s.sid)
                if self.spawn_stagger_s > 0:
                    await asyncio.sleep(self.spawn_stagger_s)
            await self.manager.wait_all(timeout)
        finally:
            if alert_task is not None:
                alert_task.cancel()
        wall = time.perf_counter() - t0
        return self.summary(wall)

    def summary(self, wall_s: float) -> dict:
        mv = self.manager.values()
        sv = self.service.values()
        return {
            "sessions": self.k,
            "nodes_per_session": self.nodes,
            "completed": int(mv["sessionsCompleted"]),
            "expired": int(mv["sessionsExpired"]),
            "wall_s": round(wall_s, 3),
            # sustained finality rate: completed aggregation instances
            # (full threshold aggregates produced) per wall second
            "aggregates_per_s": round(mv["sessionsCompleted"] / wall_s, 3)
            if wall_s > 0
            else 0.0,
            "session_p50_s": round(mv["sessionCompletionP50S"], 4),
            "session_p99_s": round(mv["sessionCompletionP99S"], 4),
            # coalescing evidence: per-launch lane fill + cross-message mix
            "launch_fill_ratio": round(sv["launchFillRatio"], 4),
            "verifier_launches": int(sv["verifierLaunches"]),
            "verifier_candidates": int(sv["verifierCandidates"]),
            "coalesced_launches": int(sv["coalescedLaunches"]),
            "dedup_hit_rate": round(sv["dedupHitRate"], 4),
            "admission_refused": int(sv["admissionRefused"]),
            # lifecycle plane: SLO shedding, epoch rotation, elasticity
            "admission_shed": int(sv["admissionShed"]),
            "shed_rate": round(sv["shedRate"], 4),
            "epoch": int(sv["epoch"]),
            "quiesce_ct": int(sv["quiesceCt"]),
            "last_quiesce_stall_ms": round(sv["lastQuiesceStallMs"], 3),
            "tier_quantiles": self.manager.tier_quantiles(),
            # fleet plane: per-device launch counts (every device
            # dispatched) + the scheduler audit
            "devices": len(self.service.plane),
            "device_launches": [
                lane.launches for lane in self.service.plane.lanes
            ],
            "sched_idle_violations": int(
                self.service.plane.idle_violations
            ),
        }

    def stop(self) -> None:
        self.manager.stop()
        self.service.stop()
        if self.metrics_server is not None:
            self.metrics_server.stop()


def _split(total: int, parts: int) -> list[int]:
    """total sessions over parts workers, remainder on the first ones."""
    base, rem = divmod(total, max(1, parts))
    return [base + (1 if i < rem else 0) for i in range(parts)]


async def run_in_process(cfg, *, seed_base: int = 0,
                         metrics_port: int | None = None,
                         timeout: float | None = None) -> dict:
    """One worker's share: build a MultiSessionCluster from the TOML
    `[service]` section and run it to completion."""
    p = cfg.service
    scheme = None
    if cfg.scheme not in ("", "fake"):
        from handel_tpu_torch.models.registry import is_device_scheme, new_scheme

        if is_device_scheme(cfg.scheme):
            raise ValueError(
                f"sim serve: device scheme {cfg.scheme!r} needs a shared "
                f"registry across sessions — run it with scheme = 'fake' "
                f"or a host scheme for now (ROADMAP item 3 follow-up)"
            )
        scheme = new_scheme(cfg.scheme)

    def tweak(node_cfg, i):
        node_cfg.update_period = p.period_ms / 1000.0

    cluster = MultiSessionCluster(
        p.sessions,
        p.nodes,
        threshold=p.threshold or None,
        scheme=scheme,
        devices=p.devices,
        mesh_devices=p.mesh_devices,
        mesh_batch_size=p.mesh_batch_size,
        batch_check=p.batch_check,
        batch_size=p.batch_size or cfg.batch_size,
        max_sessions=p.max_sessions or None,
        session_ttl_s=p.session_ttl_s,
        quantum=p.quantum,
        max_pending_per_session=p.max_pending_per_session,
        queue_capacity=p.queue_capacity,
        tier_cycle=[t.strip() for t in p.tiers.split(",") if t.strip()],
        spawn_stagger_s=p.spawn_stagger_ms / 1000.0,
        metrics_port=metrics_port,
        seed_base=seed_base,
        config_tweak=tweak,
        alert_p=getattr(cfg, "alerts", None),
    )
    try:
        return await cluster.run(timeout or cfg.max_timeout_s)
    finally:
        cluster.stop()


def merge_summaries(parts: list[dict]) -> dict:
    """Fleet summary from per-worker summaries: counts sum, rates sum
    (workers run concurrently), latency percentiles take the worst-case
    worker (conservative — exact merge would need the raw samples),
    fill/dedup weight by launches."""
    out = {
        "sessions": sum(p["sessions"] for p in parts),
        "nodes_per_session": parts[0]["nodes_per_session"] if parts else 0,
        "completed": sum(p["completed"] for p in parts),
        "expired": sum(p["expired"] for p in parts),
        "wall_s": max((p["wall_s"] for p in parts), default=0.0),
        "aggregates_per_s": round(
            sum(p["aggregates_per_s"] for p in parts), 3
        ),
        "session_p50_s": max((p["session_p50_s"] for p in parts), default=0.0),
        "session_p99_s": max((p["session_p99_s"] for p in parts), default=0.0),
        "verifier_launches": sum(p["verifier_launches"] for p in parts),
        "verifier_candidates": sum(p["verifier_candidates"] for p in parts),
        "coalesced_launches": sum(p["coalesced_launches"] for p in parts),
        "admission_refused": sum(p["admission_refused"] for p in parts),
        "admission_shed": sum(p.get("admission_shed", 0) for p in parts),
        # conservative: the worst worker's shed rate (exact needs raws)
        "shed_rate": max((p.get("shed_rate", 0.0) for p in parts), default=0.0),
        # fleet plane: each worker owns its own device plane, so the rows
        # concatenate (older workers without the keys contribute nothing)
        "devices": sum(p.get("devices", 1) for p in parts),
        "device_launches": [
            n for p in parts for n in p.get("device_launches", [])
        ],
        "sched_idle_violations": sum(
            p.get("sched_idle_violations", 0) for p in parts
        ),
        "workers": len(parts),
    }
    launches = out["verifier_launches"]
    out["launch_fill_ratio"] = (
        round(
            sum(p["launch_fill_ratio"] * p["verifier_launches"]
                for p in parts) / launches,
            4,
        )
        if launches
        else 0.0
    )
    hits = sum(
        p["dedup_hit_rate"] * p["verifier_candidates"] for p in parts
    )
    out["dedup_hit_rate"] = (
        round(hits / out["verifier_candidates"], 4)
        if out["verifier_candidates"]
        else 0.0
    )
    return out


async def run_service(cfg, workdir: str, config_path: str = "") -> dict:
    """The `sim serve` orchestrator: K sessions over M node-processes.

    processes = 1 runs in this process. Otherwise M workers
    (service/worker.py) each run their share of sessions against their own
    shared verifier; per-worker summaries merge into one record, written to
    `<workdir>/service_summary.json` either way.
    """
    from handel_tpu_torch.sim.config import dump_config

    p = cfg.service
    if p.sessions <= 0:
        raise ValueError("no [service] section (service.sessions must be > 0)")
    os.makedirs(workdir, exist_ok=True)
    if not config_path:
        config_path = os.path.join(workdir, "serve.toml")
        with open(config_path, "w") as f:
            f.write(dump_config(cfg))

    metrics_ports: list[int] = []
    if cfg.metrics:
        from handel_tpu_torch.sim.platform import free_ports, write_metrics_ports

        metrics_ports = free_ports(max(1, p.processes))
        write_metrics_ports(
            workdir, 0, dict(enumerate(metrics_ports))
        )

    if p.processes <= 1:
        summary = await run_in_process(
            cfg,
            metrics_port=metrics_ports[0] if metrics_ports else None,
        )
        summary["workers"] = 1
    else:
        shares = _split(p.sessions, p.processes)
        procs = []
        for i, share in enumerate(shares):
            if share <= 0:
                continue
            cmd = [
                sys.executable,
                "-m",
                "handel_tpu_torch.service.worker",
                "--config",
                config_path,
                "--index",
                str(i),
                "--sessions",
                str(share),
            ]
            if metrics_ports:
                cmd += ["--metrics-port", str(metrics_ports[i])]
            procs.append(
                await asyncio.create_subprocess_exec(
                    *cmd,
                    stdout=asyncio.subprocess.PIPE,
                    stderr=asyncio.subprocess.PIPE,
                )
            )
        outs = await asyncio.gather(*(pr.communicate() for pr in procs))
        parts: list[dict] = []
        for pr, (out, err) in zip(procs, outs):
            if pr.returncode != 0:
                sys.stderr.write(err.decode(errors="replace"))
                raise RuntimeError(
                    f"service worker failed (rc={pr.returncode})"
                )
            for line in out.decode().splitlines():
                if line.startswith("SERVICE_RESULT "):
                    parts.append(json.loads(line[len("SERVICE_RESULT "):]))
        if len(parts) != len(procs):
            raise RuntimeError(
                f"{len(parts)}/{len(procs)} workers reported a summary"
            )
        summary = merge_summaries(parts)

    summary["scheme"] = cfg.scheme
    summary["ok"] = (
        summary["expired"] == 0
        and summary["completed"] == summary["sessions"]
    )
    with open(os.path.join(workdir, "service_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
        f.write("\n")
    return summary
