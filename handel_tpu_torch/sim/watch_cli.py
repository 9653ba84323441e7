"""`sim watch`: live terminal dashboard over a run's /metrics endpoints — a
copy of handel_tpu/sim/watch_cli.py.

Usage:
    python -m handel_tpu_torch.sim watch <config.toml> [--workdir DIR]
        [--interval 1.0] [--snapshot PATH]
    python -m handel_tpu_torch.sim watch --attach <workdir>  (scrape a running run)

The first form launches the simulation (forcing `metrics = true` and a
short post-END linger so the final counter state is scrapeable), discovers
every node process's endpoint from `<workdir>/metrics_ports.json`
(sim/platform.py writes it before spawning), and refreshes an ANSI
dashboard about once a second: the per-level completion wave across the
fleet, verify/queue-wait p50/p99 from the merged histograms, dedup hit
rate, breaker states, and penalty/ban counts. `--attach` skips launching
and scrapes an existing run dir instead (e.g. one started by another
terminal, or a remote run with forwarded ports).

`--snapshot` writes the last successful raw /metrics scrape of every
endpoint to a file — the captured evidence form (results/README.md).

Everything here is stdlib: urllib scrapes, ANSI escape rendering (no
curses dependency — a dumb pipe gets plain refreshing blocks instead).

The dashboard model and its rows are the JAX package's whole (sessions,
fleets, federation and alerts among them): they render from whatever
families an endpoint serves, so the same exposition text gives the same
strings. The launched run goes
through the port's localhost platform on a thread of this process; the
node processes it spawns hold the card, and this process keeps none (the
platform's keygen scheme is on the host).
"""

from __future__ import annotations

import argparse
import asyncio
import glob
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

from handel_tpu_torch.core.metrics import merged_histogram, parse_exposition

SCRAPE_TIMEOUT_S = 0.75


# -- discovery ----------------------------------------------------------------


def discover_endpoints(workdir: str) -> list[str]:
    """Metrics addresses of a run dir: the platform's metrics_ports.json
    plus any `metrics_*.addr` files dropped by manually started nodes."""
    out: list[str] = []
    path = os.path.join(workdir, "metrics_ports.json")
    try:
        with open(path) as f:
            plan = json.load(f)
        out.extend(plan.get("addresses", {}).values())
    except (OSError, ValueError):
        pass
    for p in sorted(glob.glob(os.path.join(workdir, "metrics_*.addr"))):
        try:
            with open(p) as f:
                addr = f.read().strip()
            if addr and addr not in out:
                out.append(addr)
        except OSError:
            continue
    return out


def scrape(addr: str) -> tuple[dict, str] | None:
    """(parsed families, raw text) of one endpoint, or None when down."""
    try:
        with urllib.request.urlopen(
            f"http://{addr}/metrics", timeout=SCRAPE_TIMEOUT_S
        ) as r:
            text = r.read().decode()
        return parse_exposition(text), text
    except (urllib.error.URLError, OSError, ValueError):
        return None


# -- aggregation --------------------------------------------------------------


def _samples(fams: dict, name: str) -> list[tuple[dict, float]]:
    fam = fams.get(name)
    return list(fam["samples"]) if fam else []


def _merge_all(scrapes: list[dict]) -> dict:
    """Concatenate parsed families across endpoints (samples keep their
    per-node labels, so nothing collapses)."""
    merged: dict = {}
    for fams in scrapes:
        for name, fam in fams.items():
            dst = merged.setdefault(name, {"type": fam["type"], "samples": []})
            dst["samples"].extend(fam["samples"])
    return merged


def aggregate(scrapes: list[dict]) -> dict:
    """The dashboard model from any number of parsed endpoint scrapes."""
    fams = _merge_all(scrapes)

    per_node_levels: dict[str, float] = {}
    for labels, v in _samples(fams, "handel_sigs_levels_completed_ct"):
        per_node_levels[labels.get("node", "?")] = v
    best = [v for _, v in _samples(fams, "handel_sigs_best_cardinality")]

    def hist_q(name, q):
        h = merged_histogram(fams, name)
        return h.quantile(q) if h else None

    def total(name):
        s = _samples(fams, name)
        return sum(v for _, v in s) if s else None

    def mean(name):
        s = _samples(fams, name)
        return sum(v for _, v in s) / len(s) if s else None

    # per-device breaker rows (the fleet plane) are rendered separately;
    # keep this count at one entry per verifier service
    breaker = [v for labels, v in _samples(
        fams, "handel_device_verifier_breaker_state"
    ) if "device" not in labels] + [
        v for _, v in _samples(fams, "handel_device_breaker_state")
    ]

    # multi-tenant service plane (service/): per-session rows
    # keyed by the `session` label dimension, plus the manager aggregates
    sessions: dict[str, dict] = {}
    for field, name in (
        ("state", "handel_service_state"),
        ("pending", "handel_service_pending"),
        ("nodes_done", "handel_service_nodes_done"),
        ("nodes", "handel_service_nodes"),
        ("best", "handel_service_best_cardinality"),
        ("threshold", "handel_service_threshold"),
        ("queue", "handel_service_queue_depth"),
    ):
        for labels, v in _samples(fams, name):
            sid = labels.get("session")
            if sid:
                sessions.setdefault(sid, {})[field] = v

    # fleet-of-chips verifier plane (parallel/plane.py): per-device rows
    # keyed by the `device` label dimension beside the session axis
    devices: dict[str, dict] = {}
    for field, name in (
        ("launches", "handel_device_verifier_launches"),
        ("candidates", "handel_device_verifier_candidates"),
        ("fill", "handel_device_verifier_fill_ratio"),
        ("last_fill", "handel_device_verifier_last_fill"),
        ("inflight", "handel_device_verifier_inflight"),
        ("load", "handel_device_verifier_load"),
        ("retries", "handel_device_verifier_retries"),
        ("breaker", "handel_device_verifier_breaker_state"),
        # dual-mode scheduling (parallel/mesh_plane.py): 1 = whole-mesh
        # latency lane, 0 = per-chip throughput lane
        ("mode", "handel_device_verifier_mode"),
        # batch-check mode (models/rlc.py): 1 = rlc, 0 = per-candidate
        ("check", "handel_device_verifier_check_mode"),
        ("bisections", "handel_device_verifier_bisection_ct"),
    ):
        for labels, v in _samples(fams, name):
            did = labels.get("device")
            if did is not None:
                devices.setdefault(did, {})[field] = v

    # geo-federation plane (service/federation.py): one row per region
    # from the `region` label dimension, beside the front-door aggregates
    regions: dict[str, dict] = {}
    for field, name in (
        ("healthy", "handel_federation_region_healthy"),
        ("arrivals", "handel_federation_arrivals"),
        ("admitted", "handel_federation_admitted"),
        ("spill_in", "handel_federation_spill_in"),
        ("live", "handel_federation_sessions_live"),
        ("completed", "handel_federation_completed"),
        ("shed_rate", "handel_federation_shed_rate"),
        ("epoch", "handel_federation_epoch"),
        ("kills", "handel_federation_kills"),
    ):
        for labels, v in _samples(fams, name):
            rid = labels.get("region")
            if rid is not None:
                regions.setdefault(rid, {})[field] = v

    # hierarchical roll-up plane (obs/rollup.py FleetRollup
    # .register_metrics): one row per host digest from the `host` label
    # dimension, beside the master's O(hosts) merge aggregates
    fleet_hosts: dict[str, dict] = {}
    for field, name in (
        ("up", "handel_fleet_host_up"),
        ("seq", "handel_fleet_digest_seq"),
        ("series", "handel_fleet_series_ct"),
        ("top_z", "handel_fleet_top_z"),
    ):
        for labels, v in _samples(fams, name):
            hid = labels.get("host")
            if hid is not None:
                fleet_hosts.setdefault(hid, {})[field] = v

    # alert/incident plane (obs/, via AlertPlane.register_metrics): one row per burn rule from the `rule` label
    # dimension, beside the detector-bank and incident-log aggregates
    alert_rules: dict[str, dict] = {}
    for field, name in (
        ("state", "handel_alerts_alert_state"),
        ("burn_fast", "handel_alerts_burn_fast"),
        ("burn_slow", "handel_alerts_burn_slow"),
    ):
        for labels, v in _samples(fams, name):
            rid = labels.get("rule")
            if rid is not None:
                alert_rules.setdefault(rid, {})[field] = v

    def first(name):
        s = _samples(fams, name)
        return s[0][1] if s else None

    def first_global(name):
        # skip region-labeled samples of families that exist on both the
        # federation plane and the per-region plane (e.g. epoch)
        s = [v for labels, v in _samples(fams, name)
             if "region" not in labels]
        return s[0] if s else None

    return {
        "sessions": sessions,
        "devices": devices,
        "service_live": total("handel_service_sessions_live"),
        "service_completed": total("handel_service_sessions_completed"),
        "service_expired": total("handel_service_sessions_expired"),
        "service_evicted": total("handel_service_sessions_evicted"),
        "service_p50": first("handel_service_session_completion_p50_s"),
        "service_p99": first("handel_service_session_completion_p99_s"),
        "launch_fill": mean("handel_device_verifier_launch_fill_ratio"),
        "nodes": len(per_node_levels),
        "levels": per_node_levels,
        "best_min": min(best) if best else None,
        "best_max": max(best) if best else None,
        "verify_p50": hist_q("handel_sigs_verify_latency_s", 0.5),
        "verify_p99": hist_q("handel_sigs_verify_latency_s", 0.99),
        "queue_p50": hist_q("handel_sigs_queue_wait_s", 0.5),
        "queue_p99": hist_q("handel_sigs_queue_wait_s", 0.99),
        "wave_p50": hist_q("handel_sigs_level_complete_s", 0.5),
        "wave_p99": hist_q("handel_sigs_level_complete_s", 0.99),
        "dedup_rate": mean("handel_device_verifier_dedup_hit_rate")
        if fams.get("handel_device_verifier_dedup_hit_rate")
        else mean("handel_sigs_dedup_hit_rate"),
        "breaker_open": sum(1 for v in breaker if v >= 1.0),
        "breaker_half": sum(1 for v in breaker if v == 0.5),
        "breaker_total": len(breaker),
        "penalty_reports": total("handel_penalty_peer_penalty_reports"),
        "peers_banned": total("handel_penalty_peers_banned"),
        "invalid_packets": total("handel_sigs_invalid_packet_ct"),
        "net_sent": total("handel_net_sent_packets"),
        "net_rcvd": total("handel_net_rcvd_packets"),
        "net_dropped": total("handel_net_dropped_packets"),
        "verifier_launches": total("handel_device_verifier_verifier_launches"),
        "occupancy": mean("handel_device_verifier_verifier_occupancy"),
        # lifecycle plane (lifecycle/, via the verifier values()):
        # registry epoch, plane-quiesce count + last gate-closed stall, SLO
        # admission shedding, and autoscaler lane churn
        "epoch": first("handel_device_verifier_epoch"),
        "quiesce_ct": total("handel_device_verifier_quiesce_ct"),
        "quiesce_stall_ms": first(
            "handel_device_verifier_last_quiesce_stall_ms"
        ),
        "admission_shed": total("handel_device_verifier_admission_shed"),
        "shed_rate": mean("handel_device_verifier_shed_rate"),
        "lanes_added": total("handel_device_verifier_lanes_added"),
        "lanes_removed": total("handel_device_verifier_lanes_removed"),
        # latency plane / dual-mode scheduling (parallel/mesh_plane.py)
        "mesh_lanes": total("handel_device_verifier_mesh_lanes"),
        "mesh_launches": total("handel_device_verifier_mesh_launches"),
        "mode_latency": total(
            "handel_device_verifier_mode_latency_launches"
        ),
        "mode_throughput": total(
            "handel_device_verifier_mode_throughput_launches"
        ),
        "mesh_fallbacks": total("handel_device_verifier_mesh_fallbacks"),
        # flight-recorder plane (core/trace.py values()): ring fill, drops
        # and the spans/s emit rate — the satellite-1 observability row
        "trace_events": total("handel_trace_trace_events"),
        "trace_dropped": total("handel_trace_trace_dropped"),
        "trace_rate": mean("handel_trace_trace_span_rate"),
        # geo-federation plane (service/federation.py) + the open-loop
        # load harness's own gauges (sim/load.py values())
        "regions": regions,
        "fed_regions_total": first_global("handel_federation_regions_total"),
        "fed_regions_healthy": first_global(
            "handel_federation_regions_healthy"
        ),
        "fed_retries": total("handel_federation_front_door_retries"),
        "fed_spillovers": total("handel_federation_spillover_ct"),
        "fed_sheds": total("handel_federation_front_door_sheds"),
        "fed_failures": total("handel_federation_front_door_failures"),
        "fed_epoch": first_global("handel_federation_epoch"),
        "load_arrivals": first("handel_load_arrivals"),
        "load_p50": first("handel_load_open_loop_p50_s"),
        "load_p99": first("handel_load_open_loop_p99_s"),
        "load_goodput": first("handel_load_goodput"),
        # hierarchical roll-up plane (obs/rollup.py): per-host digest rows
        # plus the master FleetRollup's merge aggregates — the watch
        # surface stays O(hosts) no matter how many identities run
        "fleet_hosts": fleet_hosts,
        "fleet_hosts_total": first("handel_fleet_hosts_total"),
        "fleet_hosts_up": first("handel_fleet_hosts_up"),
        "fleet_hosts_down": first("handel_fleet_hosts_down"),
        "fleet_series_total": first("handel_fleet_series_total"),
        "fleet_ingests": total("handel_fleet_ingests_ct"),
        "fleet_ingest_bytes": total("handel_fleet_ingest_bytes_ct"),
        "fleet_merge_ms": first("handel_fleet_last_merge_ms"),
        # alert/incident plane (obs/): burn-rule rows plus the
        # incident-lifecycle counters — the `sim watch` alerting surface
        "alert_rules": alert_rules,
        "alerts_warn": total("handel_alerts_rules_warn"),
        "alerts_page": total("handel_alerts_rules_page"),
        "series_total": total("handel_alerts_series_total"),
        "series_anomalous": total("handel_alerts_series_anomalous"),
        "incidents_open": total("handel_incidents_incidents_open"),
        "incidents_opened": total("handel_incidents_opened_ct"),
        "incidents_closed": total("handel_incidents_closed_ct"),
        "incidents_flaps": total("handel_incidents_flap_ct"),
        "families": len(fams),
    }


# -- rendering ----------------------------------------------------------------


def _ms(v) -> str:
    return "  --  " if v is None else f"{v * 1e3:6.1f}ms"


def _num(v) -> str:
    return "--" if v is None else f"{v:.0f}"


def _bar(filled: int, total: int, width: int = 24) -> str:
    if total <= 0:
        return "." * width
    n = round(width * filled / total)
    return "#" * n + "." * (width - n)


#: handel_service_state code -> display name (service/session.py STATE_CODE)
_STATE_NAMES = {0: "spawned", 1: "running", 2: "done", 3: "expired",
                4: "evicted"}

TOP_K_SESSIONS = 8


def render_sessions(model: dict) -> list[str]:
    """Per-session row block: top-K sessions by pending work, each with
    its state and completion wave (nodes at threshold / committee size)."""
    sessions = model.get("sessions") or {}
    if not sessions and model.get("service_live") is None:
        return []
    lines = [
        f"sessions  live {_num(model.get('service_live'))}  "
        f"done {_num(model.get('service_completed'))}  "
        f"expired {_num(model.get('service_expired'))}  "
        f"evicted {_num(model.get('service_evicted'))}   "
        f"completion p50 {_ms(model.get('service_p50'))}  "
        f"p99 {_ms(model.get('service_p99'))}"
    ]
    top = sorted(
        sessions.items(),
        key=lambda kv: kv[1].get("pending", 0.0),
        reverse=True,
    )[:TOP_K_SESSIONS]
    for sid, row in top:
        state = _STATE_NAMES.get(int(row.get("state", 0)), "?")
        nodes = int(row.get("nodes", 0))
        done = int(row.get("nodes_done", 0))
        lines.append(
            f"  {sid:>8} {state:<8} pending {int(row.get('pending', 0)):>6}"
            f"  wave {_bar(done, nodes, 16)} {done}/{nodes}"
            f"  best {int(row.get('best', 0))}/{int(row.get('threshold', 0))}"
        )
    if len(sessions) > len(top):
        lines.append(f"  ... {len(sessions) - len(top)} more sessions")
    return lines


_BREAKER_NAMES = {0.0: "closed", 0.5: "half", 1.0: "open"}


def render_devices(model: dict) -> list[str]:
    """Per-device row block (fleet-of-chips verifier plane): scheduling
    mode, occupancy, fill and breaker state per plane lane, from the
    `device` label. Mesh lanes (latency plane, parallel/mesh_plane.py)
    render `mesh` in the mode column; their mean fill plus the service's
    mode-split counters make up the summary line."""
    devices = model.get("devices") or {}
    if not devices:
        return []
    mesh_rows = [r for r in devices.values() if r.get("mode", 0.0) >= 1.0]
    head = f"devices  ({len(devices)} verifier lanes"
    if mesh_rows:
        head += f", {len(mesh_rows)} mesh"
    lines = [head + ")"]
    for did in sorted(devices, key=lambda d: (len(d), d)):
        row = devices[did]
        fill = row.get("fill")
        breaker = _BREAKER_NAMES.get(row.get("breaker", 0.0), "?")
        mode = "mesh" if row.get("mode", 0.0) >= 1.0 else "lane"
        # batch-check mode column (models/rlc.py): rlc lanes also show
        # their bisection recheck count beside the verdict launches
        check = "rlc" if row.get("check", 0.0) >= 1.0 else "percand"
        bis = ""
        if check == "rlc":
            bis = f"  bisect {int(row.get('bisections', 0)):>4}"
        lines.append(
            f"  dev {did:>3} mode {mode}"
            f"  check {check:<7}"
            f"  launches {int(row.get('launches', 0)):>6}"
            f"  inflight {int(row.get('inflight', 0)):>2}"
            f"  load {int(row.get('load', 0)):>2}"
            f"  fill {('--' if fill is None else f'{fill:.2f}')}"
            f"  retries {int(row.get('retries', 0)):>3}"
            f"  breaker {breaker}{bis}"
        )
    if mesh_rows:
        fills = [r["fill"] for r in mesh_rows if r.get("fill") is not None]
        mesh_fill = sum(fills) / len(fills) if fills else None
        lat = model.get("mode_latency")
        thr = model.get("mode_throughput")
        fb = model.get("mesh_fallbacks")
        lines.append(
            f"  mesh     launches {int(model.get('mesh_launches') or 0):>6}"
            f"  fill {('--' if mesh_fill is None else f'{mesh_fill:.2f}')}"
            f"  modes latency {int(lat or 0)}"
            f" / throughput {int(thr or 0)}"
            f"  fallbacks {int(fb or 0)}"
        )
    return lines


def render_federation(model: dict) -> list[str]:
    """Geo-federation row block (service/federation.py): front-door
    aggregates, one row per region from the `region` label, and the
    open-loop arrival gauges — the `sim watch` surface of a
    `sim load` run (sim/load.py) with --metrics-port."""
    regions = model.get("regions") or {}
    if not regions and model.get("fed_regions_total") is None:
        return []
    lines = [
        f"federation  regions "
        f"{_num(model.get('fed_regions_healthy'))}/"
        f"{_num(model.get('fed_regions_total'))} healthy  "
        f"spillovers {_num(model.get('fed_spillovers'))}  "
        f"retries {_num(model.get('fed_retries'))}  "
        f"sheds {_num(model.get('fed_sheds'))}  "
        f"failures {_num(model.get('fed_failures'))}  "
        f"epoch {_num(model.get('fed_epoch'))}"
    ]
    for rid in sorted(regions):
        row = regions[rid]
        up = "up" if row.get("healthy", 0.0) >= 1.0 else "DOWN"
        sr = row.get("shed_rate")
        lines.append(
            f"  {rid:>10} {up:<4}"
            f"  live {int(row.get('live', 0)):>4}"
            f"  done {int(row.get('completed', 0)):>6}"
            f"  spill-in {int(row.get('spill_in', 0)):>4}"
            f"  shed {('--' if sr is None else f'{sr:.1%}')}"
            f"  kills {int(row.get('kills', 0))}"
        )
    if model.get("load_arrivals") is not None:
        gp = model.get("load_goodput")
        lines.append(
            f"  open-loop  arrivals {_num(model.get('load_arrivals'))}"
            f"  p50 {_ms(model.get('load_p50'))}"
            f"  p99 {_ms(model.get('load_p99'))}"
            f"  goodput {('--' if gp is None else f'{gp:.1%}')}"
        )
    return lines


def render_fleet(model: dict) -> list[str]:
    """Hierarchical roll-up block (obs/rollup.py): the master
    FleetRollup's O(hosts) view — hosts up/down, merged series count,
    wire ingest volume, one row per host digest, and the top anomalous
    host by its detectors' strongest z-score. The burn state beside it
    comes from the same AlertPlane the roll-ups feed (render_alerts)."""
    hosts = model.get("fleet_hosts") or {}
    if not hosts and model.get("fleet_hosts_total") is None:
        return []
    top = None
    for hid, row in hosts.items():
        z = row.get("top_z")
        if z is not None and (top is None or abs(z) > abs(top[1])):
            top = (hid, z)
    mm = model.get("fleet_merge_ms")
    head = (
        f"fleet    hosts {_num(model.get('fleet_hosts_up'))}/"
        f"{_num(model.get('fleet_hosts_total'))} up"
        f" ({_num(model.get('fleet_hosts_down'))} down)  "
        f"series {_num(model.get('fleet_series_total'))}  "
        f"ingests {_num(model.get('fleet_ingests'))} "
        f"({_num(model.get('fleet_ingest_bytes'))} B)  "
        f"merge {('--' if mm is None else f'{mm:.2f}ms')}"
    )
    if model.get("alerts_page") is not None:
        burn = "PAGE" if model["alerts_page"] else (
            "warn" if model.get("alerts_warn") else "ok"
        )
        head += f"  burn {burn}"
    lines = [head]
    if top is not None:
        lines.append(f"  top anomalous host {top[0]}  z {top[1]:+.2f}")
    for hid in sorted(hosts):
        row = hosts[hid]
        up = "up" if row.get("up", 0.0) >= 1.0 else "DOWN"
        lines.append(
            f"  {hid:>10} {up:<4}"
            f"  seq {int(row.get('seq', 0)):>5}"
            f"  series {int(row.get('series', 0)):>4}"
            f"  top-z {row.get('top_z', 0.0):+.2f}"
        )
    return lines


#: handel_alerts_alert_state code -> display name (obs/slo.py STATE_CODE)
_ALERT_STATE_NAMES = {0.0: "ok", 1.0: "WARN", 2.0: "PAGE"}


def render_alerts(model: dict) -> list[str]:
    """Alerts/incidents row block (obs/): rule states with
    their fast/slow burn multiples, anomalous detector series, and the
    incident-lifecycle counters — non-ok rules render first."""
    rules = model.get("alert_rules") or {}
    if not rules and model.get("incidents_opened") is None:
        return []
    open_ct = model.get("incidents_open")
    lines = [
        f"alerts   warn {_num(model.get('alerts_warn'))}  "
        f"page {_num(model.get('alerts_page'))}  "
        f"anomalous {_num(model.get('series_anomalous'))}/"
        f"{_num(model.get('series_total'))} series   "
        f"incidents {'OPEN' if open_ct else 'none open'}  "
        f"opened {_num(model.get('incidents_opened'))}  "
        f"closed {_num(model.get('incidents_closed'))}  "
        f"flaps {_num(model.get('incidents_flaps'))}"
    ]
    for rid in sorted(
        rules, key=lambda r: (-rules[r].get("state", 0.0), r)
    ):
        row = rules[rid]
        state = _ALERT_STATE_NAMES.get(row.get("state", 0.0), "?")
        lines.append(
            f"  {rid:>16} {state:<4}"
            f"  burn fast {row.get('burn_fast', 0.0):7.2f}x"
            f"  slow {row.get('burn_slow', 0.0):7.2f}x"
        )
    return lines


def render(model: dict, endpoints: list[str], up: int, tick: int) -> str:
    """One dashboard frame as plain text (the caller adds ANSI)."""
    lines = [
        f"handel-tpu live telemetry — {up}/{len(endpoints)} endpoints up, "
        f"{model['families']} families, scrape #{tick} "
        f"@ {time.strftime('%H:%M:%S')}",
        "",
    ]
    levels = model["levels"]
    if levels:
        max_l = int(max(levels.values()) or 0)
        lines.append(f"aggregation wave ({model['nodes']} nodes reporting)")
        for l in range(1, max_l + 1):
            done = sum(1 for v in levels.values() if v >= l)
            lines.append(
                f"  level {l:>2} complete {_bar(done, len(levels))} "
                f"{done}/{len(levels)}"
            )
        if model["best_min"] is not None:
            lines.append(
                f"  best cardinality  min {_num(model['best_min'])}  "
                f"max {_num(model['best_max'])}"
            )
        if model["wave_p50"] is not None:
            lines.append(
                f"  level-complete    p50 {_ms(model['wave_p50'])}  "
                f"p99 {_ms(model['wave_p99'])}"
            )
    elif not model.get("sessions"):
        lines.append("aggregation wave: no sigs plane scraped yet")
    srows = render_sessions(model)
    if srows:
        lines.append("")
        lines.extend(srows)
    drows = render_devices(model)
    if drows:
        lines.append("")
        lines.extend(drows)
    frows = render_federation(model)
    if frows:
        lines.append("")
        lines.extend(frows)
    flrows = render_fleet(model)
    if flrows:
        lines.append("")
        lines.extend(flrows)
    arows = render_alerts(model)
    if arows:
        lines.append("")
        lines.extend(arows)
    lines.append("")
    lines.append(
        f"verify   p50 {_ms(model['verify_p50'])}  "
        f"p99 {_ms(model['verify_p99'])}   "
        f"queue wait p50 {_ms(model['queue_p50'])}  "
        f"p99 {_ms(model['queue_p99'])}"
    )
    dd = model["dedup_rate"]
    occ = model["occupancy"]
    fill = model.get("launch_fill")
    lines.append(
        f"verifier launches {_num(model['verifier_launches'])}  "
        f"occupancy {('--' if occ is None else f'{occ:.2f}')}  "
        f"fill {('--' if fill is None else f'{fill:.2f}')}  "
        f"dedup hit rate {('--' if dd is None else f'{dd:.1%}')}"
    )
    if model["breaker_total"]:
        state = (
            f"{model['breaker_open']} open / {model['breaker_half']} "
            f"half-open / {model['breaker_total']} total"
        )
    else:
        state = "no verifier plane"
    lines.append(f"breakers {state}")
    if model.get("epoch") is not None:
        sr = model.get("shed_rate")
        stall = model.get("quiesce_stall_ms")
        lines.append(
            f"lifecycle epoch {_num(model['epoch'])}  "
            f"quiesces {_num(model.get('quiesce_ct'))}"
            f" (last stall "
            f"{('--' if stall is None else f'{stall:.1f}ms')})  "
            f"shed {_num(model.get('admission_shed'))} "
            f"({('--' if sr is None else f'{sr:.1%}')})  "
            f"lanes +{_num(model.get('lanes_added'))}"
            f"/-{_num(model.get('lanes_removed'))}"
        )
    lines.append(
        f"penalties reports {_num(model['penalty_reports'])}  "
        f"peers banned {_num(model['peers_banned'])}  "
        f"invalid packets {_num(model['invalid_packets'])}"
    )
    lines.append(
        f"network  sent {_num(model['net_sent'])}  "
        f"rcvd {_num(model['net_rcvd'])}  "
        f"dropped {_num(model['net_dropped'])}"
    )
    if model.get("trace_events") is not None:
        rate = model.get("trace_rate")
        lines.append(
            f"tracing  spans {_num(model['trace_events'])}  "
            f"dropped {_num(model['trace_dropped'])}  "
            f"rate {('--' if rate is None else f'{rate:,.0f}/s')}"
        )
    return "\n".join(lines)


# -- the loop -----------------------------------------------------------------


def watch_loop(
    workdir: str,
    interval: float,
    done: threading.Event | None = None,
    snapshot: str = "",
    max_seconds: float = 0.0,
    out=sys.stdout,
) -> int:
    """Scrape-and-render until `done` is set (and endpoints drain) or
    `max_seconds` elapses. Returns the number of successful scrape rounds."""
    tick = 0
    rounds = 0
    last_raw: dict[str, str] = {}
    ansi = out.isatty() if hasattr(out, "isatty") else False
    t0 = time.monotonic()
    try:
        while True:
            endpoints = discover_endpoints(workdir)
            results = [(a, scrape(a)) for a in endpoints]
            parsed = [r[0] for _, r in results if r is not None]
            for a, r in results:
                if r is not None:
                    last_raw[a] = r[1]
            tick += 1
            if parsed:
                rounds += 1
                frame = render(aggregate(parsed), endpoints, len(parsed), tick)
                if ansi:
                    out.write("\x1b[2J\x1b[H" + frame + "\n")
                else:
                    out.write(frame + "\n" + "-" * 72 + "\n")
                out.flush()
            finished = done is not None and done.is_set()
            if finished and not parsed:
                break  # run over and every endpoint drained
            if max_seconds and time.monotonic() - t0 > max_seconds:
                break
            if done is None and tick > 3 and not parsed:
                break  # attach mode: nothing answering any more
            time.sleep(interval if not finished else min(interval, 0.2))
    except KeyboardInterrupt:
        pass
    if snapshot and last_raw:
        with open(snapshot, "w") as f:
            for addr in sorted(last_raw):
                f.write(f"# scrape http://{addr}/metrics\n")
                f.write(last_raw[addr])
                f.write("\n")
        print(f"snapshot: {snapshot} ({len(last_raw)} endpoints)",
              file=sys.stderr)
    return rounds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m handel_tpu_torch.sim watch",
        description="live dashboard over a simulation's /metrics endpoints",
    )
    ap.add_argument("config", nargs="?", help="simulation TOML to launch")
    ap.add_argument("--attach", default="",
                    help="scrape an existing run dir instead of launching")
    ap.add_argument("--workdir", default="sim_out")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--snapshot", default="",
                    help="write the final raw /metrics scrape here")
    ap.add_argument("--max-seconds", type=float, default=0.0,
                    help="stop watching after this long (0 = until run end)")
    args = ap.parse_args(argv)

    if args.attach:
        watch_loop(args.attach, args.interval, done=None,
                   snapshot=args.snapshot, max_seconds=args.max_seconds)
        return 0

    if not args.config:
        ap.error("need a config to launch, or --attach <workdir>")

    from handel_tpu_torch.sim.config import load_config
    from handel_tpu_torch.sim.platform import run_simulation

    cfg = load_config(args.config)
    cfg.metrics = True  # the whole point of watching
    # keep endpoints up past END long enough for a final full scrape
    cfg.metrics_linger_s = max(cfg.metrics_linger_s, 2.0 * args.interval)

    done = threading.Event()
    results: list = []

    def run() -> None:
        try:
            results.extend(
                asyncio.run(run_simulation(cfg, args.workdir))
            )
        finally:
            done.set()

    t = threading.Thread(target=run, name="sim-run", daemon=True)
    t.start()
    watch_loop(args.workdir, args.interval, done=done,
               snapshot=args.snapshot, max_seconds=args.max_seconds)
    t.join(timeout=cfg.max_timeout_s * (len(cfg.runs) + 1))
    ok = bool(results) and all(r.ok for r in results)
    for i, r in enumerate(results):
        print(f"run {i}: {'success' if r.ok else 'FAILED'} -> {r.csv_path}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
