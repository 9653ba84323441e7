"""The port's serve plane (handel_tpu_torch/service/: session.py, driver.py
`MultiSessionCluster` / `merge_summaries` / `run_service`, worker.py; the
`serve` subcommand; core/penalty.py `SessionScorers`;
sim/report_checks.py) against the JAX package's.

The same seeded inputs go through both packages: per-session scorers,
session lifecycles over a stub device, the multi-session cluster's
summary and session-labeled families, the summary merge, the report
checks, and `run_service` / `python -m ... serve` at 4 sessions of 8 nodes
on the fake scheme, in one process and in two. Tolerance: exact for every
deterministic field (counts, states, verdicts, family names, messages);
walls and latencies ride the host clock and are only held to be set.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

import handel_tpu.core.penalty as jpenalty
import handel_tpu.service.driver as jdriver
import handel_tpu.service.session as jsession
import handel_tpu.sim.report_checks as jchecks
import handel_tpu_torch.core.penalty as ppenalty
import handel_tpu_torch.service.driver as pdriver
import handel_tpu_torch.service.session as psession
import handel_tpu_torch.sim.report_checks as pchecks
from handel_tpu.core import metrics as jmetrics
from handel_tpu.parallel.batch_verifier import BatchVerifierService as JService
from handel_tpu.sim import config as jconfig
from handel_tpu_torch.core import metrics as pmetrics
from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
from handel_tpu_torch.sim import config as pconfig

REF = SimpleNamespace(penalty=jpenalty, session=jsession, driver=jdriver, checks=jchecks,
                      metrics=jmetrics, Service=JService, config=jconfig, pkg="handel_tpu")
PORT = SimpleNamespace(penalty=ppenalty, session=psession, driver=pdriver, checks=pchecks,
                       metrics=pmetrics, Service=BatchVerifierService, config=pconfig,
                       pkg="handel_tpu_torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# summary fields that do not ride the host clock
DETERMINISTIC = ("sessions", "nodes_per_session", "completed", "expired", "ok", "workers",
                 "devices", "admission_refused", "admission_shed", "scheme")


def both(case, *args):
    got, ref = case(PORT, *args), case(REF, *args)
    assert got == ref
    return got


class MultiStubDevice:
    """tests/test_service.py's dispatch_multi stub."""

    def __init__(self, batch_size: int = 32):
        self.batch_size = batch_size
        self.dispatched = 0

    def dispatch_multi(self, items):
        self.dispatched += 1
        return [True] * len(items)

    def fetch(self, handle):
        return handle


# -- per-session scorers ------------------------------------------------------------


def scorers(pkg):
    s = pkg.penalty.SessionScorers()
    a, b = s.for_session("A"), s.for_session("B")
    for _ in range(10):
        a.report(7)
    out = [a is not b, s.for_session("A") is a, a.banned(7), b.banned(7),
           s.labeled_values(), s.values(), sorted(s.gauge_keys())]
    out += [s.drop("A"), s.for_session("A") is not a, s.drop("missing")]
    small = pkg.penalty.SessionScorers(capacity=2)
    s1 = small.for_session("s1")
    small.for_session("s2")
    small.for_session("s3")
    out += [len(small), small.evicted, small.for_session("s1") is not s1]
    with pytest.raises(ValueError):
        pkg.penalty.SessionScorers(capacity=0)
    return out


def test_session_scorers_as_the_reference():
    got = both(scorers)
    assert got[:4] == [True, True, True, False]
    assert got[4]["A"]["peersBanned"] == 1.0 and got[-3:] == [2, 1, True]


# -- sessions -------------------------------------------------------------------------


def lifecycle(pkg):
    async def go():
        svc = pkg.Service(MultiStubDevice(32), max_delay_ms=0.2)
        mgr = pkg.session.SessionManager(service=svc, max_sessions=4)
        s = mgr.spawn(8)
        states = [s.state]
        mgr.start(s.sid)
        states.append(s.state)
        await mgr.wait_all(20.0)
        states.append(s.state)
        svc.stop()
        vals = mgr.values()
        row = mgr.labeled_values()[s.sid]
        return {
            "states": states, "sid": s.sid, "msg": s.msg, "threshold": s.threshold,
            "epochs": sorted({h.c.epoch for h in s.cluster.handels.values()}),
            "sessions": sorted({h.c.session for h in s.cluster.handels.values()}),
            "counts": {k: v for k, v in vals.items() if not k.startswith("sessionCompletion")},
            "done in": s.completion_s() > 0 and vals["sessionCompletionP50S"] > 0,
            "released": s.sid not in svc.tenant_candidates,
            "row keys": sorted(row), "row state": row["state"], "nodes done": row["nodesDone"],
            "gauges": sorted(mgr.gauge_keys()), "labeled gauges": sorted(mgr.labeled_gauge_keys()),
        }

    return asyncio.run(go())


def test_session_lifecycle_as_the_reference():
    got = both(lifecycle)
    assert got["states"] == ["spawned", "running", "threshold-reached"]
    assert got["sessions"] == [got["sid"]] and got["done in"] and got["released"]
    assert got["counts"]["sessionsCompleted"] == 1.0


def expiry_and_admission(pkg):
    async def go():
        out = {}
        mgr = pkg.session.SessionManager(max_sessions=2, session_ttl_s=0.3)
        s = mgr.spawn(8, threshold=8, offline=(3,))
        mgr.start(s.sid)
        await mgr.wait_all(10.0)
        out["expired"] = (s.state, mgr.expired_ct, mgr.completed_ct)

        mgr = pkg.session.SessionManager(max_sessions=2)
        s1 = mgr.spawn(4)
        mgr.spawn(4)
        refused = []
        try:
            mgr.spawn(4)
        except pkg.session.AdmissionRefused as e:
            refused.append(str(e))
        mgr.start(s1.sid)
        await mgr.wait_all(10.0)
        held = s1.sid in mgr.sessions
        s3 = mgr.spawn(4)
        try:
            mgr.spawn(4)
        except pkg.session.AdmissionRefused as e:
            refused.append(str(e))
        out["admission"] = (refused, mgr.refused_ct, held, s1.sid in mgr.sessions,
                            s3.sid, [(sid, st) for sid, st, _ in mgr.retired])

        svc = pkg.Service(MultiStubDevice(32), max_delay_ms=0.2)
        mgr = pkg.session.SessionManager(service=svc, max_sessions=4)
        s = mgr.spawn(16)
        mgr.start(s.sid)
        await asyncio.sleep(0.01)
        out["evict"] = (mgr.evict(s.sid), s.state, mgr.evicted_ct, s.sid in mgr.sessions,
                        mgr.evict(s.sid))
        svc.stop()
        mgr.stop()
        return out

    return asyncio.run(go())


def test_expiry_admission_and_eviction_as_the_reference():
    got = both(expiry_and_admission)
    assert got["expired"] == ("expired", 1, 0)
    refused, n, held, still, _, retired = got["admission"]
    assert len(refused) == 2 and n == 2 and held and not still
    assert retired == [("s1", "threshold-reached")]
    assert got["evict"] == (True, "evicted", 1, False, False)


def test_sessions_spawn_under_the_current_epoch():
    for pkg in (REF, PORT):
        mgr = pkg.session.SessionManager(service=pkg.Service(MultiStubDevice()),
                                         max_sessions=4)
        mgr.epoch = 3
        s = mgr.spawn(4)
        assert s.epoch == 3
        assert all(h.c.epoch == 3 and h.c.session == s.sid for h in s.cluster.handels.values())
        assert all(h.proc._span_tags == {"session": s.sid, "epoch": 3}
                   for h in s.cluster.handels.values())
        assert all(h._sargs == {"session": s.sid, "epoch": 3}
                   for h in s.cluster.handels.values())


# -- the multi-session cluster ----------------------------------------------------------


def cluster(pkg, with_alerts):
    async def go():
        al = pkg.config.AlertParams(tick_interval_s=0.01) if with_alerts else None
        c = pkg.driver.MultiSessionCluster(4, 8, batch_size=32, metrics_port=0, alert_p=al)
        try:
            summary = await c.run(30.0)
            text = c.metrics.exposition()
            return summary, text, c.alerts is not None
        finally:
            c.stop()

    summary, text, wired = asyncio.run(go())
    fams = pkg.metrics.parse_exposition(text)
    states = sorted(v for _, v in fams["handel_service_state"]["samples"])
    return ({k: summary[k] for k in summary if k in DETERMINISTIC},
            sorted(summary), sorted(fams), states, wired)


@pytest.mark.parametrize("with_alerts", [False, True])
def test_multi_session_cluster_as_the_reference(with_alerts):
    fields, keys, fams, states, wired = both(cluster, with_alerts)
    assert fields["completed"] == 4 and fields["expired"] == 0 and fields["devices"] == 1
    assert states == [2.0] * 4 and wired == with_alerts
    assert "handel_service_pending" in fams and "handel_service_sessions_completed" in fams
    assert ("handel_alerts_series_total" in fams) == with_alerts
    assert "tier_quantiles" in keys


def test_the_mesh_lane_is_refused_until_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        pdriver.MultiSessionCluster(1, 4, mesh_devices=2)


# -- merge_summaries and the report checks ------------------------------------------------


def summaries(seed):
    rng = random.Random(seed)
    out = []
    for _ in range(rng.randrange(1, 5)):
        out.append({
            "sessions": rng.randrange(1, 8), "nodes_per_session": 8,
            "completed": rng.randrange(0, 8), "expired": rng.randrange(0, 2),
            "wall_s": rng.randrange(1, 100) / 8, "aggregates_per_s": rng.randrange(1, 50) / 4,
            "session_p50_s": rng.randrange(1, 64) / 16, "session_p99_s": rng.randrange(1, 64) / 8,
            "verifier_launches": rng.randrange(0, 40),
            "verifier_candidates": rng.randrange(0, 400),
            "coalesced_launches": rng.randrange(0, 10),
            "launch_fill_ratio": rng.randrange(0, 17) / 16,
            "dedup_hit_rate": rng.randrange(0, 17) / 16,
            "admission_refused": rng.randrange(0, 3), "admission_shed": rng.randrange(0, 3),
            "shed_rate": rng.randrange(0, 9) / 8, "devices": rng.randrange(1, 3),
            "device_launches": [rng.randrange(0, 9)], "sched_idle_violations": 0,
        })
    return out


@pytest.mark.parametrize("seed", range(4))
def test_merge_summaries_as_the_reference(seed):
    parts = summaries(seed)
    got = pdriver.merge_summaries(parts)
    assert got == jdriver.merge_summaries(parts)
    assert got["workers"] == len(parts)
    assert got["sessions"] == sum(p["sessions"] for p in parts)


def soak_report(rng, passing=False):
    if passing:
        return {"soak": {"expired": 0, "unresolved": 0, "epoch_rotations": 1,
                         "summary": {"epoch": 1, "devices": 2}, "swap_gap_bound_ms": 50.0,
                         "gaps": {"swap_gap_ms": 4.0}, "lanes_replaced": 1,
                         "devices_floor": 2, "tiers": {"gold": {"met": True}}},
                "epoch_swap_stall_ms": 2.0}
    return {
        "soak": {"expired": rng.randrange(0, 2), "unresolved": rng.randrange(0, 2),
                 "epoch_rotations": rng.randrange(0, 3),
                 "summary": {"epoch": rng.randrange(0, 3), "devices": rng.randrange(1, 4)},
                 "swap_gap_bound_ms": 50.0, "gaps": {"swap_gap_ms": rng.randrange(0, 80) * 1.0},
                 "lanes_replaced": rng.randrange(0, 2), "devices_floor": 2,
                 "tiers": {"gold": {"met": rng.random() < 0.7}}},
        "epoch_swap_stall_ms": rng.randrange(0, 80) * 1.0,
    }


def federation_report(rng, passing=False):
    if passing:
        return {"federation": {"unaccounted": 0, "unresolved": 0, "arrivals": 40,
                               "tiers": {"gold": {"met": True}}, "shed_ceiling": 0.1,
                               "spillovers": 1, "kill": None}, "shed_rate": 0.05}
    kill = None if rng.random() < 0.3 else {
        "killed_at_s": rng.choice([None, 1.0]), "unhealthy_detected_s": rng.choice([None, 1.5]),
        "recovery_s": rng.choice([None, 3.0]), "post_recovery_completed": rng.randrange(0, 3)}
    return {
        "federation": {"unaccounted": rng.randrange(0, 2), "unresolved": rng.randrange(0, 2),
                       "arrivals": 40, "tiers": {"gold": {"met": rng.random() < 0.7}},
                       "shed_ceiling": 0.1, "spillovers": rng.randrange(0, 3), "kill": kill},
        "shed_rate": rng.randrange(0, 20) / 100,
    }


def checks(pkg, seed):
    rng = random.Random(seed)
    out = []
    for make, table in ((soak_report, pkg.checks.SOAK_CHECKS),
                        (federation_report, pkg.checks.FEDERATION_CHECKS)):
        for i in range(16):
            r = pkg.checks.attach(make(rng, passing=i == 0), table)
            failures = []
            for c in table:
                try:
                    pkg.checks.assert_checks(r, [c])
                except AssertionError as e:
                    failures.append(str(e))
            out.append((r["checks"], r["ok"], failures,
                        [c.describe(r) for c in table]))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_report_checks_as_the_reference(seed):
    got = both(checks, seed)
    assert any(ok for _, ok, _, _ in got) and any(not ok for _, ok, _, _ in got)
    for verdicts, ok, failures, _ in got:
        assert ok == all(verdicts.values()) and len(failures) == list(verdicts.values()).count(
            False)


# -- run_service and the serve CLI ------------------------------------------------------


def service_cfg(pkg, processes, scheme="fake"):
    return pkg.config.SimConfig(
        scheme=scheme,
        service=pkg.config.ServiceParams(sessions=4, nodes=8, processes=processes,
                                         session_ttl_s=30.0, batch_size=32),
        max_timeout_s=60.0,
    )


def serve(pkg, processes, tmp_path):
    work = tmp_path / f"{pkg.pkg}-{processes}"
    summary = asyncio.run(pkg.driver.run_service(service_cfg(pkg, processes), str(work)))
    written = json.loads((work / "service_summary.json").read_text())
    assert written == summary
    return {k: summary[k] for k in DETERMINISTIC}, sorted(summary)


@pytest.mark.parametrize("processes", [1, 2])
def test_run_service_as_the_reference(processes, tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", ROOT)
    fields, keys = both(serve, processes, tmp_path)
    assert fields["ok"] and fields["completed"] == 4 and fields["workers"] == processes


@pytest.mark.parametrize("processes", [1, 2])
def test_serve_cli_as_the_reference(processes, tmp_path):
    out = {}
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    for pkg in (PORT, REF):
        cfg = tmp_path / f"{pkg.pkg}.toml"
        cfg.write_text(pkg.config.dump_config(service_cfg(pkg, processes)))
        work = tmp_path / f"{pkg.pkg}-out"
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg.pkg}.sim", "serve", str(cfg), "--workdir", str(work)],
            capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=240,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        assert summary == json.loads((work / "service_summary.json").read_text())
        assert summary["wall_s"] <= time.time() - t0
        out[pkg.pkg] = {k: summary[k] for k in DETERMINISTIC}
    assert out["handel_tpu_torch"] == out["handel_tpu"]
    assert out["handel_tpu_torch"]["ok"] and out["handel_tpu_torch"]["workers"] == processes


def refusal(pkg):
    with pytest.raises(ValueError) as ei:
        asyncio.run(pkg.driver.run_in_process(service_cfg(pkg, 1, scheme="bn254-jax")))
    return str(ei.value)


def test_device_scheme_is_refused_as_the_reference():
    msg = both(refusal)
    assert msg.startswith("sim serve: device scheme 'bn254-jax' needs a shared registry")


def test_serve_without_a_service_section_fails_as_the_reference(tmp_path):
    for pkg in (REF, PORT):
        with pytest.raises(ValueError, match="no \\[service\\] section"):
            asyncio.run(pkg.driver.run_service(pkg.config.SimConfig(), str(tmp_path)))
