"""Simulation TOML configuration — a copy of handel_tpu/sim/config.py.

Reference: simul/lib/config.go:41-344 — the global section (Network, Curve,
Encoding, Allocator, MonitorPort, Simulation, MaxTimeout, Retrials) plus a
`[[runs]]` matrix ({Nodes, Threshold, Failing, Processes, Handel{Period,
UpdateCount, NodeCount, Timeout, UnsafeSleepTimeOnSigVerify}}), the factory
methods, and `GetHandelConfig` bridging into the library Config
(simul/lib/config.go:290-319).

Additions over the reference: `scheme` ("fake"/"bn254"/"bn254-cuda"; the
JAX package's device names select the same device scheme,
models/registry.py), `batch_size` (device launch width), `shared_verifier`
(fuse co-located nodes' batches).

The port parses and dumps the whole TOML format, byte for byte as the JAX
package does, so every config of the repo loads. The dataclasses are data;
the method that builds a part the port has not ported yet (the simulated
verify sleep) raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import random

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: the tomli backport is the
    import tomli as tomllib  # same module under its pre-stdlib name

from dataclasses import dataclass, field

from handel_tpu_torch.core.config import Config
from handel_tpu_torch.network.chaos import ChaosConfig


@dataclass
class HandelParams:
    period_ms: float = 10.0
    update_count: int = 1
    fast_path: int = 10
    timeout_ms: float = 50.0
    unsafe_sleep_verify_ms: int = 0
    # verification strategy sweep axis (HandelConfig.Evaluator + the
    # confgenerator's `evaluator` scenario): "store" (score by the store),
    # "eval1" (verify everything), "fifo" (arrival order, no scoring)
    evaluator: str = "store"

    def to_config(self, threshold: int, seed: int) -> Config:
        if self.unsafe_sleep_verify_ms:
            raise NotImplementedError(
                "unsafe_sleep_verify_ms is not ported yet: "
                "Config.unsafe_sleep_on_verify_ms (ROADMAP item 8, 6j)"
            )
        c = Config()
        c.update_period = self.period_ms / 1000.0
        c.update_count = self.update_count
        c.fast_path = self.fast_path
        c.level_timeout = self.timeout_ms / 1000.0
        c.contributions = threshold
        c.rand = random.Random(seed)
        if self.evaluator == "eval1":
            from handel_tpu_torch.core.processing import Evaluator1

            c.new_evaluator = lambda store, h: Evaluator1()
        elif self.evaluator == "fifo":
            from handel_tpu_torch.core.processing import FifoProcessing

            c.new_processing = FifoProcessing
        elif self.evaluator != "store":
            raise ValueError(f"unknown evaluator {self.evaluator!r}")
        return c


@dataclass
class AdversaryParams:
    """Byzantine roles per run (sim/adversary.py): how many nodes play each
    role, assigned deterministically to the highest non-offline ids."""

    invalid_signer: int = 0
    stale_replayer: int = 0
    flooder: int = 0
    flood_pps: float = 200.0
    # dynamic membership (scenario engine): nodes that participate honestly
    # then DEPART mid-run, triggering survivor re-leveling + threshold
    # re-evaluation (Handel.mark_departed)
    churner: int = 0
    churn_after_ms: float = 500.0

    def total(self) -> int:
        return (
            self.invalid_signer
            + self.stale_replayer
            + self.flooder
            + self.churner
        )

    def counts(self) -> dict[str, int]:
        return {
            "invalid_signer": self.invalid_signer,
            "stale_replayer": self.stale_replayer,
            "flooder": self.flooder,
            "churner": self.churner,
        }


@dataclass
class RunConfig:
    nodes: int = 8
    threshold: int = 0  # 0 -> default percentage
    failing: int = 0
    processes: int = 1
    handel: HandelParams = field(default_factory=HandelParams)
    adversaries: AdversaryParams = field(default_factory=AdversaryParams)

    def resolved_threshold(self) -> int:
        if self.threshold > 0:
            return self.threshold
        from handel_tpu_torch.core.config import (
            DEFAULT_CONTRIBUTIONS_PERC,
            percentage_to_contributions,
        )

        return percentage_to_contributions(DEFAULT_CONTRIBUTIONS_PERC, self.nodes)

    def stats_extra(self, run_index: int) -> dict[str, float]:
        """Per-run identity + swept protocol knobs for the stats CSV, so
        parameter-sweep captures are self-describing (the reference embeds
        the lib.Config fields the same way). Shared by both platforms."""
        return {
            "run": float(run_index),
            "nodes": float(self.nodes),
            "threshold": float(self.resolved_threshold()),
            "failing": float(self.failing),
            "adversaries": float(self.adversaries.total()),
            "period_ms": float(self.handel.period_ms),
            "timeout_ms": float(self.handel.timeout_ms),
            "update_count": float(self.handel.update_count),
        }


@dataclass
class ServiceParams:
    """`[service]` section: the multi-tenant aggregation service
    (handel_tpu/service/). sessions = 0 keeps service mode off; `sim
    serve` requires it > 0. Each of `sessions` concurrent aggregation
    instances runs `nodes` logical Handel nodes over its own committee,
    all multiplexed onto one shared BatchVerifierService per process."""

    sessions: int = 0
    nodes: int = 16
    threshold: int = 0  # 0 -> default percentage of `nodes`
    processes: int = 1  # worker node-processes the sessions shard over
    devices: int = 1  # verifier plane lanes (DevicePlane) per process
    mesh_devices: int = 0  # whole-mesh latency lane width (parallel/
    # mesh_plane.py); 0 -> no mesh lane, dual-mode scheduling off
    mesh_batch_size: int = 8  # the mesh lane's (small) launch width
    max_sessions: int = 0  # live-session admission cap; 0 -> `sessions`
    session_ttl_s: float = 60.0  # running session expiry deadline
    quantum: int = 8  # DRR lane credits per tenant ring visit
    max_pending_per_session: int = 4096  # per-tenant verifier queue bound
    queue_capacity: int = 0  # global SLO shed bound (fairness.py); 0 -> off,
    # leaving the flat per-session bound above as the only admission control
    tiers: str = ""  # comma-separated SLO tier cycle assigned to sessions
    # round-robin, e.g. "gold,bronze" (fairness.py TIERS); "" -> untiered
    batch_size: int = 0  # shared-launch lanes; 0 -> global batch_size
    spawn_stagger_ms: float = 0.0  # delay between session spawns
    period_ms: float = 10.0  # gossip period of the session nodes
    fp_backend: str = ""  # Field modmul kernel for the service's verify
    # plane ("cios"/"rns", ops/fp.py backend seam); "" -> global fp_backend
    batch_check: str = "per_candidate"  # verifier check mode: "per_candidate"
    # (one pairing check per lane) or "rlc" (random-linear-combination
    # combined check with bisection fallback, models/rlc.py)

    def enabled(self) -> bool:
        return self.sessions > 0


@dataclass
class SoakParams:
    """`[soak]` section: the lifecycle soak harness (sim/soak.py,
    `python -m handel_tpu.sim soak`). Defaults are the ~90 s CI shape:
    sustained tiered load on a 2-lane host plane with a mid-run epoch swap
    at 40% and a forced lane-0 loss at 60% of the run."""

    duration_s: float = 90.0  # load window (drain tail rides on top)
    nodes: int = 16  # Handel nodes per session
    concurrency: int = 8  # sessions held live by the spawner
    devices: int = 2  # starting verify-plane lanes
    max_lanes: int = 4  # LaneAutoscaler ceiling
    batch_size: int = 64  # shared-launch width
    queue_capacity: int = 4096  # global SLO shed bound (fairness.py)
    session_ttl_s: float = 60.0  # per-session expiry (an expiry = a drop)
    tiers: str = "gold,silver,bronze,standard"  # round-robin SLO cycle
    period_ms: float = 5.0  # session node gossip period
    registry: int = 256  # rotated validator-set size (epoch swap payload)
    swap_at_frac: float = 0.4  # epoch rotation point, fraction of duration
    lane_loss_at_frac: float = 0.6  # forced lane-0 breaker-open point
    control_interval_s: float = 0.25  # LifecycleController tick
    autotune_every_s: float = 5.0  # critical-path recompute throttle
    trace_capacity: int = 1 << 17  # flight-recorder ring (events)


@dataclass
class LoadParams:
    """`[load]` section: the open-loop arrival generator (sim/load.py,
    `python -m handel_tpu.sim load`). rate_sps = 0 keeps load mode off.

    Unlike `[service]`/`[soak]` (closed-loop: the harness back-fills on
    completion), sessions arrive on a seeded Poisson/diurnal/burst clock
    whether or not the federation keeps up — open-loop p50/p99 and
    goodput against `deadline_s` are the first-class metrics."""

    rate_sps: float = 0.0  # mean session arrivals per second; 0 -> off
    duration_s: float = 60.0  # arrival window (drain tail rides on top)
    model: str = "poisson"  # arrival process: poisson | diurnal | burst
    seed: int = 0  # arrival clock + origin sampling seed
    nodes: int = 8  # Handel committee size per arriving session
    deadline_s: float = 5.0  # per-session arrival->verdict deadline
    # (goodput = completions inside it / arrivals)
    tiers: str = "gold,silver,bronze,standard"  # round-robin SLO cycle
    # -- diurnal model: rate * (1 + amplitude*sin(2*pi*t/period)) --------
    diurnal_amplitude: float = 0.5  # peak swing as a fraction of the mean
    diurnal_period_s: float = 30.0  # one day, compressed
    # -- burst model: rate * burst_x inside each burst window ------------
    burst_every_s: float = 10.0  # burst cadence
    burst_x: float = 4.0  # rate multiplier inside a burst
    burst_len_s: float = 2.0  # burst width

    def enabled(self) -> bool:
        return self.rate_sps > 0


@dataclass
class FederationParams:
    """`[federation]` section: the geo-federated service plane the load
    generator drives (service/federation.py). One MultiSessionCluster per
    region of the `planet` preset; a front door routes each arrival to
    the nearest healthy region by RTT, spilling over on shed/death."""

    planet: str = "planet-3region"  # scenario/planets.py preset
    geo_seed: int = 0
    devices: int = 1  # verify-plane lanes per region cluster
    batch_size: int = 32  # shared-launch width per region
    queue_capacity: int = 512  # per-region SLO shed bound (fairness.py)
    max_sessions: int = 64  # per-region live-session admission cap
    session_ttl_s: float = 30.0  # per-session expiry inside a region
    period_ms: float = 5.0  # session node gossip period
    probe_interval_s: float = 0.25  # front-door health probe cadence
    # capped exponential backoff when EVERY region refuses an arrival:
    # min(retry_cap_ms, retry_base_ms * 2^attempt), retry_budget attempts
    retry_base_ms: float = 50.0
    retry_cap_ms: float = 500.0
    retry_budget: int = 4
    registry: int = 64  # validator-set size staged on region rejoin
    shed_ceiling: float = 0.15  # acceptance bound on the global shed rate
    # -- chaos: scheduled mid-run region kill + recovery -----------------
    kill_region: str = ""  # region name; "" -> no kill drill
    kill_at_frac: float = 0.35  # of the load window
    recover_at_frac: float = 0.65
    trace_capacity: int = 1 << 17  # flight-recorder ring (events)


@dataclass
class AlertParams:
    """`[alerts]` section: the detection-and-incident plane (handel_tpu/
    obs/). Rides every harness that carries a control loop — `sim load`
    ticks it beside the federation, `sim soak` through the
    LifecycleController, `sim serve` beside its metrics registry. All
    knobs default to the production shape; `window_scale` compresses the
    burn windows so a 45 s drill exercises the same multi-window math a
    30-day SLO would."""

    enabled: bool = True
    # burn-rate evaluation (obs/slo.py): fast/slow window pair, scaled
    fast_window_s: float = 60.0
    slow_window_s: float = 900.0
    window_scale: float = 1.0
    page_x: float = 14.4  # page when BOTH windows burn >= this multiple
    warn_x: float = 6.0
    goodput_slo: float = 0.95  # deadline-met fraction the goodput rule holds
    # anomaly detection (obs/detect.py)
    z_threshold: float = 6.0
    ewma_alpha: float = 0.3
    min_consecutive: int = 1  # anomalous ticks before a series fires
    seed: int = 0  # MAD frugal-sketch coin-flip stream
    # incident lifecycle (obs/incidents.py): flap suppression pair
    min_hold_s: float = 2.0  # quiet time required before close
    cooldown_s: float = 5.0  # refire inside this reopens, not re-mints
    tick_interval_s: float = 0.25  # evaluation cadence
    # hierarchical roll-ups (obs/rollup.py): per-host digests -> fleet
    series_cap: int = 0  # labeled-family cardinality cap (0 = uncapped)
    rollup_top_k: int = 8  # anomalous series carried per host digest
    rollup_interval_s: float = 1.0  # host digest emit cadence
    rollup_stale_s: float = 5.0  # host counts as down after this silence


@dataclass
class SwarmParams:
    """`[swarm]` section: the virtual-node runtime (handel_tpu/swarm/).

    One committee of `identities` members, every member a co-resident
    virtual node, sharded over `processes` worker processes in contiguous
    ID blocks. identities = 0 keeps swarm mode off; `sim swarm` requires
    it > 0. The fake scheme is implied — swarm scale is a host-runtime
    experiment, not a pairing benchmark (the verify plane still runs
    through the shared BatchVerifierService so the launch path is real).
    """

    identities: int = 0
    processes: int = 1
    threshold: int = 0  # 0 -> default percentage of `identities`
    period_ms: float = 2000.0  # vnode gossip period. The in-memory router is
    # lossless and candidate order is id-staggered, so the fast-path cascade
    # alone covers every level deterministically; gossip is a repair net, and
    # every period costs ~identities × active-levels deliveries of CPU.
    timeout_ms: float = 50.0  # level-start timeout per vnode
    fast_path: int = 3  # completed-level burst fanout. With id-staggered
    # candidate order each peer receives exactly this many copies per level,
    # so it is the redundancy factor of the wave (10, the WAN default, just
    # multiplies single-core CPU by 3x for no extra coverage)
    tick_ms: float = 10.0  # TimerWheel resolution
    batch_size: int = 64  # shared verifier launch width
    max_pending: int = 256  # per-vnode unverified-candidate bound
    chunk_bits: int = 12  # registry pager chunk = 2^chunk_bits identities
    page_budget: int = 64  # resident chunks per process
    timeout_s: float = 0.0  # run deadline; 0 -> global max_timeout_s

    def enabled(self) -> bool:
        return self.identities > 0


@dataclass
class ScenarioParams:
    """`[scenario]` section: the WAN scenario engine (handel_tpu/scenario/).

    One declarative knob set composing three orthogonal axes on top of any
    run: a geo-latency planet model (GeoNetwork region RTT matrices), stake
    weights (weighted thresholds in core/handel.py), and join-side dynamic
    membership (epoch-staged registry admission). Departure-side churn
    rides the existing adversary machinery (`[runs.adversaries] churner`).
    All axes default off; a `[scenario]` with only `weight_profile =
    "count"` activates the weighted code path with all-1.0 weights — by
    construction bit-for-bit identical to the count threshold."""

    name: str = ""  # label stamped into reports/captures
    # -- geo planet model: a named preset (scenario/planets.py) OR an
    # inline regions + rtt_ms matrix; preset wins when both are set ------
    planet: str = ""
    regions: list[str] = field(default_factory=list)
    rtt_ms: list[list[float]] = field(default_factory=list)
    jitter_ms: float = 0.0  # per-hop Gaussian jitter (std dev, ms)
    geo_seed: int = 0
    # -- dynamic membership: join-side admissions through the epoch path
    # (lifecycle/epoch.py stage_registry/activate_staged) ----------------
    joins: int = 0
    join_at_frac: float = 0.5  # of the run window (scenario engine)
    # -- stake weights: per-identity weight profile (scenario/weights.py);
    # "" = count threshold (weighted path off) ---------------------------
    weight_profile: str = ""  # "" | count | linear | pareto | split
    weight_seed: int = 0
    # weighted threshold as a fraction of total stake; 0 -> derive the
    # same fraction the count threshold is of the node count
    weight_threshold_frac: float = 0.0

    def geo_enabled(self) -> bool:
        return bool(self.planet or self.regions)

    def weights_enabled(self) -> bool:
        return bool(self.weight_profile)

    def enabled(self) -> bool:
        return self.geo_enabled() or self.weights_enabled() or self.joins > 0

    def geo_config(self):
        """Resolve preset/inline matrix into a validated GeoConfig
        (region placement derives per node via .for_node)."""
        from handel_tpu_torch.network.geo import GeoConfig
        from handel_tpu_torch.scenario.planets import planet_preset

        if self.planet:
            regions, rtt = planet_preset(self.planet)
        else:
            regions, rtt = list(self.regions), [list(r) for r in self.rtt_ms]
        return GeoConfig(
            regions=regions,
            rtt_ms=rtt,
            jitter_ms=self.jitter_ms,
            seed=self.geo_seed,
        ).validate()

    def make_weights(self, n: int):
        from handel_tpu_torch.scenario.weights import make_weights

        return make_weights(self.weight_profile, n, seed=self.weight_seed)

    def weight_threshold(self, count_threshold: int, n: int, weights) -> float:
        total = float(sum(weights))
        if self.weight_threshold_frac > 0.0:
            return self.weight_threshold_frac * total
        # same fraction of stake as the count threshold is of the node
        # count — all-1.0 weights make this exactly `count_threshold`
        return count_threshold * total / n


@dataclass
class HostSpec:
    """One host of the remote platform's fleet (sim/remote.py; the analog
    of an aws.go instance entry)."""

    connect: str = "local"  # "local" | "ssh:<user@host>"
    ip: str = "127.0.0.1"  # address other nodes dial this host's nodes at
    python: str = ""  # remote python executable ("" = this interpreter)
    workdir: str = ""  # staging dir on the host ("" = per-host tmp dir)
    # this host holds the accelerator: with shared_verifier + a device
    # scheme, one process here serves the batch plane over TCP and every
    # chip-less process in the fleet verifies through it
    # (parallel/rpc_verifier.py)
    device: bool = False


@dataclass
class SimConfig:
    network: str = "udp"  # udp | tcp | inproc
    scheme: str = "bn254"
    allocator: str = "round-robin"
    monitor_port: int = 0  # 0 -> pick free
    max_timeout_s: float = 60.0
    retrials: int = 1
    batch_size: int = 16
    shared_verifier: bool = False
    # device-mesh width for the verification plane (>1 = sharded kernels,
    # not ported yet: ROADMAP item 7)
    mesh_devices: int = 1
    # Field modmul kernel for device schemes: "cios" (kernel B1,
    # csrc/fp_mont.cu) or "rns" (residue-number-system products, kernel B2,
    # ops/rns.py); plumbed node -> new_scheme -> models/bn254_torch.py ->
    # ops/curve.py -> ops/fp.py
    fp_backend: str = "cios"
    # With fp_backend = "rns": keep pairing values resident as residue
    # planes across the Miller loop / final exponentiation, reconstructing
    # through the CRT only at line boundaries (ops/pairing.py). Ignored by
    # "cios". `true` is the optimized default; `false` forces the legacy
    # per-mul round-trip form for debugging.
    rns_resident: bool = True
    debug: bool = False
    # live telemetry plane (core/metrics.py): every node process serves
    # /metrics + /healthz + /readyz on its own port (allocated by the
    # platform, written to <workdir>/metrics_ports.json); `metrics = false`
    # keeps the plane fully off — zero threads, zero sockets
    metrics: bool = False
    # seconds a node keeps its metrics endpoint up after the END barrier so
    # scrapers (`sim watch`, Prometheus) catch the final counter state of a
    # short run; 0 = exit immediately
    metrics_linger_s: float = 0.0
    # span tracing (core/trace.py): node processes record a per-contribution
    # flight recorder and dump Chrome trace_event JSON into the run's
    # trace dir; analyze with `python -m handel_tpu.sim trace <dir>`
    trace: bool = False
    # flight-recorder ring capacity (events per process)
    trace_capacity: int = 1 << 16
    # "" = Handel; "nsquare" / "gossipsub" select the comparison baselines
    # (simul/p2p; here handel_tpu/baselines/gossip.py)
    baseline: str = ""
    # -- fault injection (network/chaos.py): applied to every node's
    # transport when any rate is nonzero; seeds derive per node ------------
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    # -- multi-tenant service (handel_tpu/service/; `sim serve`) -----------
    service: ServiceParams = field(default_factory=ServiceParams)
    # -- lifecycle soak harness (sim/soak.py; `sim soak`) ------------------
    soak: SoakParams = field(default_factory=SoakParams)
    # -- open-loop load generator (sim/load.py; `sim load`) ----------------
    load: LoadParams = field(default_factory=LoadParams)
    # -- geo federation the load drives (service/federation.py) ------------
    federation: FederationParams = field(default_factory=FederationParams)
    # -- SLO alerting + incident plane (handel_tpu/obs/) -------------------
    alerts: AlertParams = field(default_factory=AlertParams)
    # -- virtual-node swarm (handel_tpu/swarm/; `sim swarm`) ---------------
    swarm: SwarmParams = field(default_factory=SwarmParams)
    # -- WAN scenario engine (handel_tpu/scenario/; `sim scenario`) --------
    scenario: ScenarioParams = field(default_factory=ScenarioParams)
    # -- remote platform (sim/remote.py; aws.go analog) --------------------
    hosts: list[HostSpec] = field(default_factory=list)
    master_ip: str = "127.0.0.1"  # address remote nodes dial the master at
    base_port: int = 0  # node port base; 0 = probe locally (all-local only)
    runs: list[RunConfig] = field(default_factory=list)


def load_config(path: str) -> SimConfig:
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    cfg = SimConfig(
        network=raw.get("network", "udp"),
        scheme=raw.get("scheme", raw.get("curve", "bn254")),
        allocator=raw.get("allocator", "round-robin"),
        monitor_port=int(raw.get("monitor_port", 0)),
        max_timeout_s=float(raw.get("max_timeout_s", 60.0)),
        retrials=int(raw.get("retrials", 1)),
        batch_size=int(raw.get("batch_size", 16)),
        shared_verifier=bool(raw.get("shared_verifier", False)),
        mesh_devices=int(raw.get("mesh_devices", 1)),
        fp_backend=str(raw.get("fp_backend", "cios")),
        rns_resident=bool(raw.get("rns_resident", True)),
        debug=bool(raw.get("debug", False)),
        metrics=bool(raw.get("metrics", False)),
        metrics_linger_s=float(raw.get("metrics_linger_s", 0.0)),
        trace=bool(raw.get("trace", False)),
        trace_capacity=int(raw.get("trace_capacity", 1 << 16)),
        baseline=str(raw.get("baseline", "")),
        master_ip=str(raw.get("master_ip", "127.0.0.1")),
        base_port=int(raw.get("base_port", 0)),
    )
    ch = raw.get("chaos", {})
    cfg.chaos = ChaosConfig(
        drop_rate=float(ch.get("drop_rate", 0.0)),
        corrupt_rate=float(ch.get("corrupt_rate", 0.0)),
        duplicate_rate=float(ch.get("duplicate_rate", 0.0)),
        reorder_rate=float(ch.get("reorder_rate", 0.0)),
        delay_rate=float(ch.get("delay_rate", 0.0)),
        delay_ms=float(ch.get("delay_ms", 0.0)),
        delay_jitter_ms=float(ch.get("delay_jitter_ms", 0.0)),
        seed=int(ch.get("seed", 0)),
    ).validate()
    sv = raw.get("service", {})
    cfg.service = ServiceParams(
        sessions=int(sv.get("sessions", 0)),
        nodes=int(sv.get("nodes", 16)),
        threshold=int(sv.get("threshold", 0)),
        processes=int(sv.get("processes", 1)),
        devices=int(sv.get("devices", 1)),
        mesh_devices=int(sv.get("mesh_devices", 0)),
        mesh_batch_size=int(sv.get("mesh_batch_size", 8)),
        max_sessions=int(sv.get("max_sessions", 0)),
        session_ttl_s=float(sv.get("session_ttl_s", 60.0)),
        quantum=int(sv.get("quantum", 8)),
        max_pending_per_session=int(sv.get("max_pending_per_session", 4096)),
        queue_capacity=int(sv.get("queue_capacity", 0)),
        tiers=str(sv.get("tiers", "")),
        batch_size=int(sv.get("batch_size", 0)),
        spawn_stagger_ms=float(sv.get("spawn_stagger_ms", 0.0)),
        period_ms=float(sv.get("period_ms", 10.0)),
        fp_backend=str(sv.get("fp_backend", "")),
        batch_check=str(sv.get("batch_check", "per_candidate")),
    )
    if cfg.fp_backend not in ("cios", "rns") or cfg.service.fp_backend not in (
        "", "cios", "rns",
    ):
        raise ValueError(
            f"fp_backend must be one of 'cios', 'rns', got "
            f"{cfg.fp_backend!r} / service {cfg.service.fp_backend!r} "
            "(the 'rns' backend additionally honours the boolean "
            "`rns_resident` knob for residue-resident pairing)"
        )
    if cfg.service.batch_check not in ("per_candidate", "rlc"):
        raise ValueError(
            "service.batch_check must be one of 'per_candidate', 'rlc', got "
            f"{cfg.service.batch_check!r}"
        )
    so = raw.get("soak", {})
    cfg.soak = SoakParams(
        duration_s=float(so.get("duration_s", 90.0)),
        nodes=int(so.get("nodes", 16)),
        concurrency=int(so.get("concurrency", 8)),
        devices=int(so.get("devices", 2)),
        max_lanes=int(so.get("max_lanes", 4)),
        batch_size=int(so.get("batch_size", 64)),
        queue_capacity=int(so.get("queue_capacity", 4096)),
        session_ttl_s=float(so.get("session_ttl_s", 60.0)),
        tiers=str(so.get("tiers", "gold,silver,bronze,standard")),
        period_ms=float(so.get("period_ms", 5.0)),
        registry=int(so.get("registry", 256)),
        swap_at_frac=float(so.get("swap_at_frac", 0.4)),
        lane_loss_at_frac=float(so.get("lane_loss_at_frac", 0.6)),
        control_interval_s=float(so.get("control_interval_s", 0.25)),
        autotune_every_s=float(so.get("autotune_every_s", 5.0)),
        trace_capacity=int(so.get("trace_capacity", 1 << 17)),
    )
    lo = raw.get("load", {})
    cfg.load = LoadParams(
        rate_sps=float(lo.get("rate_sps", 0.0)),
        duration_s=float(lo.get("duration_s", 60.0)),
        model=str(lo.get("model", "poisson")),
        seed=int(lo.get("seed", 0)),
        nodes=int(lo.get("nodes", 8)),
        deadline_s=float(lo.get("deadline_s", 5.0)),
        tiers=str(lo.get("tiers", "gold,silver,bronze,standard")),
        diurnal_amplitude=float(lo.get("diurnal_amplitude", 0.5)),
        diurnal_period_s=float(lo.get("diurnal_period_s", 30.0)),
        burst_every_s=float(lo.get("burst_every_s", 10.0)),
        burst_x=float(lo.get("burst_x", 4.0)),
        burst_len_s=float(lo.get("burst_len_s", 2.0)),
    )
    if cfg.load.model not in ("poisson", "diurnal", "burst"):
        raise ValueError(
            "load.model must be one of 'poisson', 'diurnal', 'burst', got "
            f"{cfg.load.model!r}"
        )
    if not 0.0 <= cfg.load.diurnal_amplitude < 1.0:
        raise ValueError(
            "load.diurnal_amplitude must be in [0, 1) — the rate must stay "
            f"positive, got {cfg.load.diurnal_amplitude}"
        )
    fe = raw.get("federation", {})
    cfg.federation = FederationParams(
        planet=str(fe.get("planet", "planet-3region")),
        geo_seed=int(fe.get("geo_seed", 0)),
        devices=int(fe.get("devices", 1)),
        batch_size=int(fe.get("batch_size", 32)),
        queue_capacity=int(fe.get("queue_capacity", 512)),
        max_sessions=int(fe.get("max_sessions", 64)),
        session_ttl_s=float(fe.get("session_ttl_s", 30.0)),
        period_ms=float(fe.get("period_ms", 5.0)),
        probe_interval_s=float(fe.get("probe_interval_s", 0.25)),
        retry_base_ms=float(fe.get("retry_base_ms", 50.0)),
        retry_cap_ms=float(fe.get("retry_cap_ms", 500.0)),
        retry_budget=int(fe.get("retry_budget", 4)),
        registry=int(fe.get("registry", 64)),
        shed_ceiling=float(fe.get("shed_ceiling", 0.15)),
        kill_region=str(fe.get("kill_region", "")),
        kill_at_frac=float(fe.get("kill_at_frac", 0.35)),
        recover_at_frac=float(fe.get("recover_at_frac", 0.65)),
        trace_capacity=int(fe.get("trace_capacity", 1 << 17)),
    )
    if cfg.federation.retry_base_ms <= 0 or (
        cfg.federation.retry_cap_ms < cfg.federation.retry_base_ms
    ):
        raise ValueError(
            "federation retry backoff needs retry_base_ms > 0 and "
            f"retry_cap_ms >= retry_base_ms, got base "
            f"{cfg.federation.retry_base_ms} / cap "
            f"{cfg.federation.retry_cap_ms}"
        )
    if cfg.federation.kill_region and not (
        0.0 < cfg.federation.kill_at_frac
        < cfg.federation.recover_at_frac <= 1.0
    ):
        raise ValueError(
            "federation kill drill needs 0 < kill_at_frac < recover_at_frac "
            f"<= 1, got kill {cfg.federation.kill_at_frac} / recover "
            f"{cfg.federation.recover_at_frac}"
        )
    al = raw.get("alerts", {})
    cfg.alerts = AlertParams(
        enabled=bool(al.get("enabled", True)),
        fast_window_s=float(al.get("fast_window_s", 60.0)),
        slow_window_s=float(al.get("slow_window_s", 900.0)),
        window_scale=float(al.get("window_scale", 1.0)),
        page_x=float(al.get("page_x", 14.4)),
        warn_x=float(al.get("warn_x", 6.0)),
        goodput_slo=float(al.get("goodput_slo", 0.95)),
        z_threshold=float(al.get("z_threshold", 6.0)),
        ewma_alpha=float(al.get("ewma_alpha", 0.3)),
        min_consecutive=int(al.get("min_consecutive", 1)),
        seed=int(al.get("seed", 0)),
        min_hold_s=float(al.get("min_hold_s", 2.0)),
        cooldown_s=float(al.get("cooldown_s", 5.0)),
        tick_interval_s=float(al.get("tick_interval_s", 0.25)),
        series_cap=int(al.get("series_cap", 0)),
        rollup_top_k=int(al.get("rollup_top_k", 8)),
        rollup_interval_s=float(al.get("rollup_interval_s", 1.0)),
        rollup_stale_s=float(al.get("rollup_stale_s", 5.0)),
    )
    if cfg.alerts.fast_window_s >= cfg.alerts.slow_window_s:
        raise ValueError(
            "alerts needs fast_window_s < slow_window_s, got fast "
            f"{cfg.alerts.fast_window_s} / slow {cfg.alerts.slow_window_s}"
        )
    if cfg.alerts.warn_x >= cfg.alerts.page_x:
        raise ValueError(
            "alerts needs warn_x < page_x, got warn "
            f"{cfg.alerts.warn_x} / page {cfg.alerts.page_x}"
        )
    if not 0.0 < cfg.alerts.goodput_slo < 1.0:
        raise ValueError(
            "alerts.goodput_slo must be in (0, 1), got "
            f"{cfg.alerts.goodput_slo}"
        )
    if cfg.alerts.window_scale <= 0.0 or cfg.alerts.tick_interval_s <= 0.0:
        raise ValueError(
            "alerts needs window_scale > 0 and tick_interval_s > 0, got "
            f"scale {cfg.alerts.window_scale} / tick "
            f"{cfg.alerts.tick_interval_s}"
        )
    if cfg.alerts.min_hold_s < 0.0 or cfg.alerts.cooldown_s < 0.0:
        raise ValueError(
            "alerts needs min_hold_s >= 0 and cooldown_s >= 0, got "
            f"hold {cfg.alerts.min_hold_s} / cooldown "
            f"{cfg.alerts.cooldown_s}"
        )
    if cfg.alerts.series_cap < 0:
        raise ValueError(
            f"alerts.series_cap must be >= 0, got {cfg.alerts.series_cap}"
        )
    if cfg.alerts.rollup_top_k < 1:
        raise ValueError(
            f"alerts.rollup_top_k must be >= 1, got {cfg.alerts.rollup_top_k}"
        )
    if cfg.alerts.rollup_interval_s <= 0.0 or cfg.alerts.rollup_stale_s <= 0.0:
        raise ValueError(
            "alerts needs rollup_interval_s > 0 and rollup_stale_s > 0, got "
            f"interval {cfg.alerts.rollup_interval_s} / stale "
            f"{cfg.alerts.rollup_stale_s}"
        )
    sc = raw.get("scenario", {})
    cfg.scenario = ScenarioParams(
        name=str(sc.get("name", "")),
        planet=str(sc.get("planet", "")),
        regions=[str(x) for x in sc.get("regions", [])],
        rtt_ms=[[float(v) for v in row] for row in sc.get("rtt_ms", [])],
        jitter_ms=float(sc.get("jitter_ms", 0.0)),
        geo_seed=int(sc.get("geo_seed", 0)),
        joins=int(sc.get("joins", 0)),
        join_at_frac=float(sc.get("join_at_frac", 0.5)),
        weight_profile=str(sc.get("weight_profile", "")),
        weight_seed=int(sc.get("weight_seed", 0)),
        weight_threshold_frac=float(sc.get("weight_threshold_frac", 0.0)),
    )
    sw = raw.get("swarm", {})
    cfg.swarm = SwarmParams(
        identities=int(sw.get("identities", 0)),
        processes=int(sw.get("processes", 1)),
        threshold=int(sw.get("threshold", 0)),
        period_ms=float(sw.get("period_ms", 2000.0)),
        timeout_ms=float(sw.get("timeout_ms", 50.0)),
        fast_path=int(sw.get("fast_path", 3)),
        tick_ms=float(sw.get("tick_ms", 10.0)),
        batch_size=int(sw.get("batch_size", 64)),
        max_pending=int(sw.get("max_pending", 256)),
        chunk_bits=int(sw.get("chunk_bits", 12)),
        page_budget=int(sw.get("page_budget", 64)),
        timeout_s=float(sw.get("timeout_s", 0.0)),
    )
    for h in raw.get("hosts", []):
        cfg.hosts.append(
            HostSpec(
                connect=str(h.get("connect", "local")),
                ip=str(h.get("ip", "127.0.0.1")),
                python=str(h.get("python", "")),
                workdir=str(h.get("workdir", "")),
                device=bool(h.get("device", False)),
            )
        )
    for r in raw.get("runs", []):
        h = r.get("handel", {})
        a = r.get("adversaries", {})
        cfg.runs.append(
            RunConfig(
                nodes=int(r.get("nodes", 8)),
                threshold=int(r.get("threshold", 0)),
                failing=int(r.get("failing", 0)),
                processes=int(r.get("processes", 1)),
                adversaries=AdversaryParams(
                    invalid_signer=int(a.get("invalid_signer", 0)),
                    stale_replayer=int(a.get("stale_replayer", 0)),
                    flooder=int(a.get("flooder", 0)),
                    flood_pps=float(a.get("flood_pps", 200.0)),
                    churner=int(a.get("churner", 0)),
                    churn_after_ms=float(a.get("churn_after_ms", 500.0)),
                ),
                handel=HandelParams(
                    period_ms=float(h.get("period_ms", 10.0)),
                    update_count=int(h.get("update_count", 1)),
                    fast_path=int(h.get("fast_path", 10)),
                    timeout_ms=float(h.get("timeout_ms", 50.0)),
                    unsafe_sleep_verify_ms=int(h.get("unsafe_sleep_verify_ms", 0)),
                    evaluator=str(h.get("evaluator", "store")),
                ),
            )
        )
    if not cfg.runs:
        cfg.runs.append(RunConfig())
    return cfg


def dump_config(cfg: SimConfig) -> str:
    """SimConfig -> TOML text (tomllib is read-only; layout kept trivial)."""
    lines = [
        f'network = "{cfg.network}"',
        f'scheme = "{cfg.scheme}"',
        f'allocator = "{cfg.allocator}"',
        f"monitor_port = {cfg.monitor_port}",
        f"max_timeout_s = {cfg.max_timeout_s}",
        f"retrials = {cfg.retrials}",
        f"batch_size = {cfg.batch_size}",
        f"shared_verifier = {str(cfg.shared_verifier).lower()}",
        f"mesh_devices = {cfg.mesh_devices}",
        f'fp_backend = "{cfg.fp_backend}"',
        f"rns_resident = {str(cfg.rns_resident).lower()}",
        f"debug = {str(cfg.debug).lower()}",
        f"metrics = {str(cfg.metrics).lower()}",
        f"metrics_linger_s = {cfg.metrics_linger_s}",
        f"trace = {str(cfg.trace).lower()}",
        f"trace_capacity = {cfg.trace_capacity}",
        f'baseline = "{cfg.baseline}"',
        f'master_ip = "{cfg.master_ip}"',
        f"base_port = {cfg.base_port}",
    ]
    if cfg.chaos.any():
        lines += [
            "",
            "[chaos]",
            f"drop_rate = {cfg.chaos.drop_rate}",
            f"corrupt_rate = {cfg.chaos.corrupt_rate}",
            f"duplicate_rate = {cfg.chaos.duplicate_rate}",
            f"reorder_rate = {cfg.chaos.reorder_rate}",
            f"delay_rate = {cfg.chaos.delay_rate}",
            f"delay_ms = {cfg.chaos.delay_ms}",
            f"delay_jitter_ms = {cfg.chaos.delay_jitter_ms}",
            f"seed = {cfg.chaos.seed}",
        ]
    if cfg.service.enabled():
        lines += [
            "",
            "[service]",
            f"sessions = {cfg.service.sessions}",
            f"nodes = {cfg.service.nodes}",
            f"threshold = {cfg.service.threshold}",
            f"processes = {cfg.service.processes}",
            f"devices = {cfg.service.devices}",
            f"mesh_devices = {cfg.service.mesh_devices}",
            f"mesh_batch_size = {cfg.service.mesh_batch_size}",
            f"max_sessions = {cfg.service.max_sessions}",
            f"session_ttl_s = {cfg.service.session_ttl_s}",
            f"quantum = {cfg.service.quantum}",
            f"max_pending_per_session = {cfg.service.max_pending_per_session}",
            f"queue_capacity = {cfg.service.queue_capacity}",
            f"tiers = {cfg.service.tiers!r}",
            f"batch_size = {cfg.service.batch_size}",
            f"spawn_stagger_ms = {cfg.service.spawn_stagger_ms}",
            f"period_ms = {cfg.service.period_ms}",
            f'fp_backend = "{cfg.service.fp_backend}"',
            f'batch_check = "{cfg.service.batch_check}"',
        ]
    if cfg.soak != SoakParams():  # non-default soak shapes round-trip
        lines += [
            "",
            "[soak]",
            f"duration_s = {cfg.soak.duration_s}",
            f"nodes = {cfg.soak.nodes}",
            f"concurrency = {cfg.soak.concurrency}",
            f"devices = {cfg.soak.devices}",
            f"max_lanes = {cfg.soak.max_lanes}",
            f"batch_size = {cfg.soak.batch_size}",
            f"queue_capacity = {cfg.soak.queue_capacity}",
            f"session_ttl_s = {cfg.soak.session_ttl_s}",
            f"tiers = {cfg.soak.tiers!r}",
            f"period_ms = {cfg.soak.period_ms}",
            f"registry = {cfg.soak.registry}",
            f"swap_at_frac = {cfg.soak.swap_at_frac}",
            f"lane_loss_at_frac = {cfg.soak.lane_loss_at_frac}",
            f"control_interval_s = {cfg.soak.control_interval_s}",
            f"autotune_every_s = {cfg.soak.autotune_every_s}",
            f"trace_capacity = {cfg.soak.trace_capacity}",
        ]
    if cfg.load.enabled():
        lo = cfg.load
        lines += [
            "",
            "[load]",
            f"rate_sps = {lo.rate_sps}",
            f"duration_s = {lo.duration_s}",
            f'model = "{lo.model}"',
            f"seed = {lo.seed}",
            f"nodes = {lo.nodes}",
            f"deadline_s = {lo.deadline_s}",
            f"tiers = {lo.tiers!r}",
            f"diurnal_amplitude = {lo.diurnal_amplitude}",
            f"diurnal_period_s = {lo.diurnal_period_s}",
            f"burst_every_s = {lo.burst_every_s}",
            f"burst_x = {lo.burst_x}",
            f"burst_len_s = {lo.burst_len_s}",
        ]
    if cfg.load.enabled() or cfg.federation != FederationParams():
        fe = cfg.federation
        lines += [
            "",
            "[federation]",
            f'planet = "{fe.planet}"',
            f"geo_seed = {fe.geo_seed}",
            f"devices = {fe.devices}",
            f"batch_size = {fe.batch_size}",
            f"queue_capacity = {fe.queue_capacity}",
            f"max_sessions = {fe.max_sessions}",
            f"session_ttl_s = {fe.session_ttl_s}",
            f"period_ms = {fe.period_ms}",
            f"probe_interval_s = {fe.probe_interval_s}",
            f"retry_base_ms = {fe.retry_base_ms}",
            f"retry_cap_ms = {fe.retry_cap_ms}",
            f"retry_budget = {fe.retry_budget}",
            f"registry = {fe.registry}",
            f"shed_ceiling = {fe.shed_ceiling}",
            f'kill_region = "{fe.kill_region}"',
            f"kill_at_frac = {fe.kill_at_frac}",
            f"recover_at_frac = {fe.recover_at_frac}",
            f"trace_capacity = {fe.trace_capacity}",
        ]
    if cfg.alerts != AlertParams():  # non-default alert shapes round-trip
        al = cfg.alerts
        lines += [
            "",
            "[alerts]",
            f"enabled = {str(al.enabled).lower()}",
            f"fast_window_s = {al.fast_window_s}",
            f"slow_window_s = {al.slow_window_s}",
            f"window_scale = {al.window_scale}",
            f"page_x = {al.page_x}",
            f"warn_x = {al.warn_x}",
            f"goodput_slo = {al.goodput_slo}",
            f"z_threshold = {al.z_threshold}",
            f"ewma_alpha = {al.ewma_alpha}",
            f"min_consecutive = {al.min_consecutive}",
            f"seed = {al.seed}",
            f"min_hold_s = {al.min_hold_s}",
            f"cooldown_s = {al.cooldown_s}",
            f"tick_interval_s = {al.tick_interval_s}",
            f"series_cap = {al.series_cap}",
            f"rollup_top_k = {al.rollup_top_k}",
            f"rollup_interval_s = {al.rollup_interval_s}",
            f"rollup_stale_s = {al.rollup_stale_s}",
        ]
    if cfg.scenario.enabled():
        sc = cfg.scenario
        lines += [
            "",
            "[scenario]",
            f'name = "{sc.name}"',
            f'planet = "{sc.planet}"',
        ]
        if sc.regions:
            regions = ", ".join(f'"{r}"' for r in sc.regions)
            lines.append(f"regions = [{regions}]")
        if sc.rtt_ms:
            rows = ", ".join(
                "[" + ", ".join(str(v) for v in row) + "]"
                for row in sc.rtt_ms
            )
            lines.append(f"rtt_ms = [{rows}]")
        lines += [
            f"jitter_ms = {sc.jitter_ms}",
            f"geo_seed = {sc.geo_seed}",
            f"joins = {sc.joins}",
            f"join_at_frac = {sc.join_at_frac}",
            f'weight_profile = "{sc.weight_profile}"',
            f"weight_seed = {sc.weight_seed}",
            f"weight_threshold_frac = {sc.weight_threshold_frac}",
        ]
    if cfg.swarm.enabled():
        lines += [
            "",
            "[swarm]",
            f"identities = {cfg.swarm.identities}",
            f"processes = {cfg.swarm.processes}",
            f"threshold = {cfg.swarm.threshold}",
            f"period_ms = {cfg.swarm.period_ms}",
            f"timeout_ms = {cfg.swarm.timeout_ms}",
            f"fast_path = {cfg.swarm.fast_path}",
            f"tick_ms = {cfg.swarm.tick_ms}",
            f"batch_size = {cfg.swarm.batch_size}",
            f"max_pending = {cfg.swarm.max_pending}",
            f"chunk_bits = {cfg.swarm.chunk_bits}",
            f"page_budget = {cfg.swarm.page_budget}",
            f"timeout_s = {cfg.swarm.timeout_s}",
        ]
    for h in cfg.hosts:
        lines += [
            "",
            "[[hosts]]",
            f'connect = "{h.connect}"',
            f'ip = "{h.ip}"',
            f'python = "{h.python}"',
            f'workdir = "{h.workdir}"',
            f"device = {str(h.device).lower()}",
        ]
    for r in cfg.runs:
        lines += [
            "",
            "[[runs]]",
            f"nodes = {r.nodes}",
            f"threshold = {r.threshold}",
            f"failing = {r.failing}",
            f"processes = {r.processes}",
        ]
        if r.adversaries.total():
            lines += [
                "[runs.adversaries]",
                f"invalid_signer = {r.adversaries.invalid_signer}",
                f"stale_replayer = {r.adversaries.stale_replayer}",
                f"flooder = {r.adversaries.flooder}",
                f"flood_pps = {r.adversaries.flood_pps}",
                f"churner = {r.adversaries.churner}",
                f"churn_after_ms = {r.adversaries.churn_after_ms}",
            ]
        lines += [
            "[runs.handel]",
            f"period_ms = {r.handel.period_ms}",
            f"update_count = {r.handel.update_count}",
            f"fast_path = {r.handel.fast_path}",
            f"timeout_ms = {r.handel.timeout_ms}",
            f"unsafe_sleep_verify_ms = {r.handel.unsafe_sleep_verify_ms}",
            f'evaluator = "{r.handel.evaluator}"',
        ]
    return "\n".join(lines) + "\n"
