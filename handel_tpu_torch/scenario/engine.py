"""The WAN scenario engine, composing geo latency, churn, weights and joins:
a copy of handel_tpu/scenario/engine.py.

`run_scenario(cfg, workdir)` takes one parsed sim TOML (sim/config.py;
`[scenario]` + the usual `[[runs]]` shape) and drives a single in-process
aggregation round with every configured axis active at once:

  geo       every node's transport is a GeoNetwork (network/geo.py) over
            the planet's region RTT matrix; each node's Config.region tag
            rides its trace spans so the critical path attributes WAN
            hops by region pair (sim/trace_cli.py region_hops);
  weights   a deterministic stake profile (scenario/weights.py) feeds the
            weighted threshold plane (core/handel.py): the round completes
            when the aggregate's WEIGHT clears the stake threshold;
  churn     `[runs.adversaries] churner = K` nodes participate honestly
            then depart on the MembershipSchedule's staggered timeline,
            broadcasting Handel.mark_departed so survivors re-level and
            re-evaluate reachability;
  joins     `joins = J` new identities are admitted through the epoch
            path — an enlarged registry staged on every verify lane, then
            quiesce + flip (lifecycle/epoch.py). A join lands in the next
            epoch's committee; the running round is unaffected by design.

The result is a bench-record-shaped report (scripts/bench_check.py,
headline `geo_weighted_ttt_s`) plus the trace dump + trace report in
`workdir`, making every scenario a captured, regression-gated artifact.
"""

from __future__ import annotations

import asyncio
import json
import os
import time

from handel_tpu_torch.core.logging import DEFAULT_LOGGER
from handel_tpu_torch.core.test_harness import LocalCluster
from handel_tpu_torch.core.trace import FlightRecorder
from handel_tpu_torch.scenario.membership import MembershipSchedule
from handel_tpu_torch.sim.adversary import (
    ROLE_CHURNER,
    adversary_roles,
    check_threshold_reachable,
)


async def _admit_joins(scen, nodes: int, scheme, logger) -> tuple[int, float]:
    """Join-side membership: stage an ENLARGED registry (the original n
    identities plus `joins` new keys) on a live verify plane and flip the
    epoch: lifecycle/epoch.py's stage -> quiesce -> activate choreography,
    here driven by membership change instead of key rotation. Returns (epochs advanced,
    swap stall seconds)."""
    from handel_tpu_torch.lifecycle.epoch import EpochManager
    from handel_tpu_torch.service.driver import MultiSessionCluster

    cluster = MultiSessionCluster(
        sessions=0, nodes=nodes, scheme=scheme, batch_size=32,
        max_sessions=1,
    )
    cluster.service.start()
    try:
        epochs = EpochManager(cluster.service, cluster.manager, logger=logger)
        pubkeys = [
            scheme.keygen(i)[1] for i in range(nodes + scen.joins)
        ]
        await epochs.begin_rotation(pubkeys)
        stall_s = await epochs.commit_rotation()
        return epochs.rotations, stall_s
    finally:
        cluster.service.stop()


async def run_scenario(cfg, workdir: str, logger=DEFAULT_LOGGER) -> dict:
    """Run the scenario described by `cfg` (a SimConfig with `[scenario]`),
    writing scenario_trace.json + scenario_report.json into `workdir`."""
    scen = cfg.scenario
    run = cfg.runs[0]
    n = run.nodes
    threshold = run.resolved_threshold()

    geo = scen.geo_config() if scen.geo_enabled() else None
    weights = scen.make_weights(n) if scen.weights_enabled() else None
    weight_threshold = (
        scen.weight_threshold(threshold, n, weights)
        if weights is not None
        else 0.0
    )

    roles = (
        adversary_roles(run.adversaries.counts(), n)
        if run.adversaries.total()
        else {}
    )
    check_threshold_reachable(
        threshold,
        n,
        run.failing,
        roles,
        weights=weights,
        weight_threshold=weight_threshold,
    )

    churn_after_s = run.adversaries.churn_after_ms / 1000.0
    schedule = MembershipSchedule(
        nodes=n,
        churner_ids=[i for i, r in roles.items() if r == ROLE_CHURNER],
        churn_after_s=churn_after_s,
        joins=scen.joins,
        join_at_s=scen.join_at_frac * max(1.0, 2.0 * churn_after_s),
        seed=scen.geo_seed,
    )

    recorder = FlightRecorder(capacity=cfg.trace_capacity)

    def config_factory(i: int):
        c = run.handel.to_config(threshold, seed=i)
        if weights is not None:
            c.weights = weights
            c.weight_threshold = weight_threshold
        return c

    cluster = LocalCluster(
        n,
        threshold=threshold,
        offline=[],
        config_factory=config_factory,
        adversaries=roles,
        recorder=recorder,
        geo=geo,
        chaos=cfg.chaos if cfg.chaos.any() else None,
        churn_after_s=churn_after_s,
    )
    # per-churner staggered departure times from the deterministic schedule
    for nid, a in cluster.adversaries.items():
        if getattr(a, "role", None) == ROLE_CHURNER:
            at = schedule.leave_time_of(nid)
            if at is not None:
                a.leave_after_s = at

    epochs_advanced, swap_stall_s = 0, 0.0
    join_task = None
    t0 = time.monotonic()
    cluster.start()
    try:
        if scen.joins > 0:
            join_at = schedule.joins()[0].at_s

            async def _join_later():
                await asyncio.sleep(join_at)
                return await _admit_joins(scen, n, cluster.scheme, logger)

            join_task = asyncio.ensure_future(_join_later())
        finals = await cluster.wait_complete_success(
            timeout=cfg.max_timeout_s
        )
        ttt = time.monotonic() - t0
        if join_task is not None:
            epochs_advanced, swap_stall_s = await asyncio.wait_for(
                join_task, timeout=cfg.max_timeout_s
            )
            join_task = None
    finally:
        if join_task is not None:
            join_task.cancel()
        cluster.stop()

    # -- verdicts over the converged state ---------------------------------
    final = next(iter(finals.values()))
    card = final.bitset.cardinality()
    achieved_weight = (
        final.bitset.weight_sum(weights) if weights is not None else float(card)
    )
    reached = (
        achieved_weight >= weight_threshold - 1e-9
        if weights is not None
        else card >= threshold
    )
    churner_ids = [i for i, r in roles.items() if r == ROLE_CHURNER]
    departed_everywhere = all(
        set(churner_ids) <= h.departed for h in cluster.handels.values()
    )

    trace_path = os.path.join(workdir, "scenario_trace.json")
    recorder.dump(trace_path)
    from handel_tpu_torch.sim.trace_cli import build_report

    trace_report = build_report(recorder.export()["traceEvents"])
    cp = trace_report.get("critical_path") or {}
    region_hops = cp.get("region_hops", [])

    checks = {
        "threshold_reached": bool(reached),
        "departures_marked": departed_everywhere,
        "epoch_advanced": scen.joins == 0 or epochs_advanced >= 1,
        "region_attributed": geo is None or len(region_hops) >= 1,
    }
    report = {
        # bench-record shape (scripts/bench_check.py SIDE_METRICS)
        "metric": "geo_weighted_ttt_s",
        "value": round(ttt, 6),
        "backend": "scenario",
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "ok": all(checks.values()),
        "checks": checks,
        "geo_weighted_ttt_s": round(ttt, 6),
        "scenario": {
            "name": scen.name or "unnamed",
            "planet": scen.planet,
            "regions": geo.regions if geo is not None else [],
            "nodes": n,
            "threshold": threshold,
            "failing": run.failing,
            "churners": len(churner_ids),
            "departed_ids": sorted(churner_ids),
            "joins": scen.joins,
            "epochs_advanced": epochs_advanced,
            "epoch_swap_stall_ms": round(swap_stall_s * 1e3, 3),
            "weight_profile": scen.weight_profile,
            "weight_threshold": round(weight_threshold, 6),
            "achieved_weight": round(achieved_weight, 6),
            "achieved_cardinality": card,
            "region_hops": region_hops,
            "critical_path_ms": cp.get("wall_ms", 0.0),
            "stages_ms": cp.get("stages_ms", {}),
            "sent_packets": cluster.router.sent_packets,
        },
    }
    with open(os.path.join(workdir, "scenario_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def run_scenario_sync(cfg, workdir: str, logger=DEFAULT_LOGGER) -> dict:
    return asyncio.run(run_scenario(cfg, workdir, logger=logger))
