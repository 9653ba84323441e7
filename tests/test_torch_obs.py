"""The port's detection-and-incident plane (handel_tpu_torch/obs/: slo,
detect, incidents, plane) against the JAX package's handel_tpu/obs/.

Each case of tests/test_obs.py runs on both packages with the same seeded
series and the same manual clock, and the port must give what the
reference gives: the burn rates and rule states, the z traces and
firings, the incident events, timelines and reports, the drill's
detection tick and attribution, the exposition families, and the /alerts
body. Tolerance: exact (every clock is manual and every series seeded).
"""

from __future__ import annotations

import json
import random
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

import handel_tpu.obs as jobs
import handel_tpu_torch.obs as pobs
from handel_tpu.core import metrics as jmetrics
from handel_tpu.core import trace as jtrace
from handel_tpu.lifecycle import autoscaler as jautoscaler
from handel_tpu.sim import config as jconfig
from handel_tpu_torch.core import metrics as pmetrics
from handel_tpu_torch.core import trace as ptrace
from handel_tpu_torch.lifecycle import autoscaler as pautoscaler
from handel_tpu_torch.sim import config as pconfig

REF = SimpleNamespace(obs=jobs, metrics=jmetrics, trace=jtrace,
                      autoscaler=jautoscaler, config=jconfig)
PORT = SimpleNamespace(obs=pobs, metrics=pmetrics, trace=ptrace,
                       autoscaler=pautoscaler, config=pconfig)


def both(case, *args):
    """The case on the port, after asserting it equals the reference's."""
    got, ref = case(PORT, *args), case(REF, *args)
    assert got == ref
    return got


# -- burn-rate math -------------------------------------------------------------


def constant_error(pkg, frac, budget=0.01, page_x=14.4, warn_x=6.0):
    ev = pkg.obs.BurnRateEvaluator(fast_window_s=60.0, slow_window_s=900.0,
                                   clock=lambda: 0.0)
    state = {"t": 0.0}

    def src():
        total = state["t"] * 10.0
        return total * (1.0 - frac), total * frac

    ev.add_rule(pkg.obs.BurnRule("r", budget=budget, page_x=page_x, warn_x=warn_x), src)
    for t in range(0, 1801, 30):
        state["t"] = float(t)
        ev.tick(now=float(t))
    return {"burns": ev.burns("r"), "states": ev.states(), "firing": ev.firing(),
            "values": ev.values(), "rows": ev.labeled_values()}


@pytest.mark.parametrize("frac,state", [(0.01, "ok"), (0.06, "warn"), (0.144, "page")])
def test_burn_oracle(frac, state):
    got = both(constant_error, frac)
    fast, slow = got["burns"]
    assert fast == pytest.approx(frac / 0.01) and slow == pytest.approx(frac / 0.01)
    assert got["states"]["r"] == state


def multiwindow(pkg):
    """A burst that burns the fast window only, then a sustained burn."""
    ev = pkg.obs.BurnRateEvaluator(fast_window_s=60.0, slow_window_s=900.0,
                                   clock=lambda: 0.0)
    c = {"good": 0.0, "bad": 0.0}
    ev.add_rule(pkg.obs.BurnRule("r", budget=0.01), lambda: (c["good"], c["bad"]))
    out = []
    for t in range(0, 2400, 30):
        bad = 0.5 if 900 <= t < 960 or t >= 1500 else 0.0
        c["good"] += 300.0 * (1 - bad)
        c["bad"] += 300.0 * bad
        ev.tick(now=float(t))
        out.append((t, ev.states()["r"], ev.burns("r")))
    return out


def test_burn_multiwindow_gates_on_both():
    got = both(multiwindow)
    # the burst burns the fast window alone: the slow one keeps it off page
    assert {st for t, st, _ in got if 900 <= t < 990} <= {"ok", "warn"}
    assert got[-1][1] == "page"


def test_burn_rule_validation():
    for pkg in (REF, PORT):
        for kw in ({"budget": 0.0}, {"budget": 1.5}, {"budget": 0.1, "warn_x": 20.0}):
            with pytest.raises(ValueError):
                pkg.obs.BurnRule("r", **kw)


def window_scale(pkg):
    ev = pkg.obs.BurnRateEvaluator(fast_window_s=60.0, slow_window_s=900.0,
                                   window_scale=0.01, clock=lambda: 0.0)
    c = {"g": 0.0, "b": 0.0}
    ev.add_rule(pkg.obs.BurnRule("r", budget=0.01), lambda: (c["g"], c["b"]))
    seen = []
    for i in range(400):
        c["g"] += 8.0
        c["b"] += 2.0 if i >= 200 else 0.0
        ev.tick(now=i * 0.05)
        seen.append(ev.states()["r"])
    return seen, ev.burns("r"), ev.values()


def test_burn_window_scale_compresses_the_drill():
    seen, burns, _ = both(window_scale)
    assert seen[199] == "ok" and seen[-1] == "page"
    assert burns[0] == pytest.approx(20.0)


def source_exception(pkg):
    ev = pkg.obs.BurnRateEvaluator(clock=lambda: 0.0)
    calls = {"n": 0}

    def bad():
        calls["n"] += 1
        raise RuntimeError("source down")

    ev.add_rule(pkg.obs.BurnRule("broken", budget=0.01), bad)
    ev.add_rule(pkg.obs.BurnRule("fine", budget=0.01), lambda: (100.0, 0.0))
    for t in range(5):
        ev.tick(now=float(t))
    return calls["n"], ev.states(), ev.values()


def test_burn_source_exception_skips_rule():
    n, states, _ = both(source_exception)
    assert n == 5 and states["fine"] == "ok"


# -- detectors -------------------------------------------------------------------


def stream():
    rng = random.Random(4)
    base = [rng.gauss(10.0, 0.5) for _ in range(60)]
    return base + [25.0] * 10 + [rng.gauss(10.0, 0.5) for _ in range(20)]


def detectors(pkg):
    s = stream()
    ew = pkg.obs.EwmaDetector(alpha=0.3, z_threshold=6.0)
    mads = [pkg.obs.MadDetector(seed=k) for k in (7, 7, 8)]
    warm = pkg.obs.EwmaDetector(alpha=0.3, z_threshold=1.0, warmup=5)
    return {
        "ewma": [ew.update(x) for x in s],
        "mad": [[d.update(x) for x in s] for d in mads],
        "warm": [warm.update(x) for x in (1.0, 9.0, 1.0, 9.0, 1.0, 100.0)],
    }


def test_detectors_replay_as_the_reference():
    got = both(detectors)
    assert max(got["ewma"][:60]) < 6.0 < got["ewma"][60]
    m7, m7b, m8 = got["mad"]
    assert m7 == m7b and m7 != m8 and m7[60] > 6.0
    assert got["warm"][:5] == [0.0] * 5 and got["warm"][5] != 0.0


def bank_case(pkg):
    bank = pkg.obs.DetectorBank(clock=lambda: 0.0)
    vals = {"x": 10.0, "y": 10.0}
    cond = {"broken": False}
    bank.attach("up-only", lambda: vals["x"],
                pkg.obs.EwmaDetector(alpha=0.3, z_threshold=6.0, warmup=2),
                min_consecutive=2, direction="up")
    bank.attach("s", lambda: vals["y"],
                pkg.obs.EwmaDetector(alpha=0.3, z_threshold=6.0, warmup=2),
                min_consecutive=1, opens_incident=True, direction="down",
                hold_while=lambda: cond["broken"])
    fired = []
    for t in range(30):
        fired.append([d.name for d in bank.tick(now=float(t))])
    vals["x"] = 0.0
    vals["y"] = 0.0
    cond["broken"] = True
    for t in range(30, 50):
        fired.append([(d.name, d.opens_incident) for d in bank.tick(now=float(t))])
    cond["broken"] = False
    vals["y"] = 10.0
    for _ in range(5):
        fired.append([d.name for d in bank.tick(now=50.0)])
    errors = []
    for kw in ({"name": "up-only"}, {"name": "bad-dir", "direction": "sideways"}):
        try:
            bank.attach(kw.pop("name"), lambda: 0.0, pkg.obs.EwmaDetector(), **kw)
        except ValueError as e:
            errors.append(str(e))
    return fired, bank.values(), bank.labeled_values(), bank.top_anomalous(3), errors


def test_detector_bank_as_the_reference():
    fired, vals, _, _, errors = both(bank_case)
    assert all(f == [] for f in fired[:30])
    assert fired[30] == [("s", True)] and all(f == [("s", True)] for f in fired[31:50])
    assert fired[-1] == [] and vals["seriesAnomalous"] == 0.0
    assert len(errors) == 2


def sources(pkg):
    class Rep:
        def values(self):
            return {"depth": 7.0}

    h = pkg.trace.LogHistogram()
    for v in (0.01, 0.02, 0.04):
        h.add(v)
    t, c = {"now": 0.0}, {"v": 0.0}
    rate = pkg.obs.counter_rate(lambda: c["v"], clock=lambda: t["now"])
    first = rate()
    c["v"], t["now"] = 30.0, 10.0
    return (pkg.obs.reporter_key_source(Rep(), "depth")(),
            pkg.obs.reporter_key_source(Rep(), "missing")(),
            pkg.obs.histogram_quantile_source(lambda: h, 0.5)(),
            pkg.obs.histogram_quantile_source(lambda: None, 0.5)(),
            first, rate())


def test_source_factories():
    got = both(sources)
    assert got[0] == 7.0 and got[1] is None and got[3] is None
    assert got[4] is None and got[5] == pytest.approx(3.0)


# -- incidents -------------------------------------------------------------------


def incidents(pkg):
    out = {}
    events = []
    log = pkg.obs.IncidentLog(snapshot_fn=lambda: {"cause": "unit-test"},
                              min_hold_s=2.0, cooldown_s=5.0, clock=lambda: 0.0)
    log.add_listener(lambda ev, inc: events.append((ev, inc.id)))
    for now, firing in ((0.0, [("goodput", "warn")]),
                        (1.0, [("goodput", "warn"), ("tier-gold-p99", "warn")]),
                        (2.0, [("goodput", "page")]), (3.0, [("goodput", "page")]),
                        (4.0, []), (5.0, []), (6.1, [])):
        log.observe(firing, now=now)
    out["lifecycle"] = (events, log.to_report(t0=0.0), log.values())

    flap = pkg.obs.IncidentLog(min_hold_s=1.0, cooldown_s=5.0, clock=lambda: 0.0)
    ids = []
    for now, firing in ((0.0, [("r", "page")]), (1.0, []), (2.5, []), (4.5, [("r", "page")]),
                        (5.0, []), (6.5, []), (60.0, [("r", "page")])):
        flap.observe(firing, now=now)
        ids.append(None if flap.current is None else (flap.current.id, flap.current.flaps))
    out["flap"] = (ids, flap.opened, flap.flapped)

    hold = pkg.obs.IncidentLog(min_hold_s=2.0, cooldown_s=5.0, clock=lambda: 0.0)
    open_after = []
    for now, firing in ((0.0, [("r", "warn")]), (1.0, []), (2.0, [("r", "warn")]),
                        (3.0, []), (4.5, []), (5.1, [])):
        hold.observe(firing, now=now)
        open_after.append(hold.current is not None)
    out["hold"] = open_after

    rebase = pkg.obs.IncidentLog(min_hold_s=1.0, clock=lambda: 0.0)
    for now, firing in ((100.0, [("r", "page")]), (101.0, []), (102.5, [])):
        rebase.observe(firing, now=now)
    out["report"] = rebase.to_report(t0=100.0)

    rec = pkg.trace.FlightRecorder(capacity=256)
    traced = pkg.obs.IncidentLog(recorder=rec, min_hold_s=1.0, clock=lambda: 0.0)
    for now, firing in ((0.0, [("r", "warn")]), (0.5, [("r", "page")]), (1.0, []), (2.5, [])):
        traced.observe(firing, now=now)
    out["instants"] = [(e["name"], e.get("args")) for e in rec.export()["traceEvents"]
                       if e.get("cat") == "incident"]
    return out


def test_incidents_as_the_reference():
    got = both(incidents)
    events, report, _ = got["lifecycle"]
    assert [e for e, _ in events] == ["open", "escalate", "close"]
    names = [e["event"] for e in report["incidents"][0]["timeline"]]
    assert names == ["open", "correlate", "escalate", "close"]
    ids, opened, flapped = got["flap"]
    assert ids[3] == (ids[0][0], 1) and opened == 2 and flapped == 1
    assert got["hold"] == [True, True, True, True, True, False]
    assert got["report"]["incidents"][0]["closed_at"] == pytest.approx(2.5)
    assert [n for n, _ in got["instants"]] == [
        "incident_open", "incident_escalate", "incident_close"]


# -- the AlertPlane ----------------------------------------------------------------


class _Params:
    """Duck-typed AlertParams, as tests/test_obs.py has it."""

    enabled = True
    fast_window_s = 0.6
    slow_window_s = 9.0
    window_scale = 1.0
    page_x = 14.4
    warn_x = 6.0
    z_threshold = 6.0
    ewma_alpha = 0.3
    min_consecutive = 1
    seed = 0
    min_hold_s = 0.5
    cooldown_s = 2.0
    tick_interval_s = 0.05


def drilled_plane(pkg):
    t = {"now": 0.0}
    plane = pkg.obs.AlertPlane.from_params(_Params(), clock=lambda: t["now"])
    health = {"regions": 3.0}
    plane.detectors.attach(
        "region-health", lambda: health["regions"],
        pkg.obs.EwmaDetector(alpha=0.3, z_threshold=6.0),
        min_consecutive=1, opens_incident=True, direction="down",
        hold_while=lambda: health["regions"] < 3.0,
    )
    plane.add_context("unhealthy_regions",
                      lambda: ["us-east"] if health["regions"] < 3.0 else [])
    counts = {"good": 0.0, "bad": 0.0}
    plane.evaluator.add_rule(pkg.obs.BurnRule("goodput", budget=0.05),
                             lambda: (counts["good"], counts["bad"]))
    return plane, t, health, counts


def drill(pkg):
    plane, t, health, counts = drilled_plane(pkg)
    ticks = []

    def run_until(end):
        while t["now"] < end:
            counts["good"] += 5.0
            ticks.append((round(t["now"], 6), plane.tick(),
                          plane.incidents.current is not None))
            t["now"] += 0.05

    run_until(3.0)
    health["regions"] = 2.0
    run_until(t["now"] + 2.0)
    inc = plane.incidents.current
    attribution = inc.attribution if inc is not None else None
    health["regions"] = 3.0
    run_until(t["now"] + 2.0)
    return ticks, attribution, plane.values(), plane.alerts_payload()


def test_alert_plane_drill_as_the_reference():
    ticks, attribution, vals, payload = both(drill)
    kill = next(i for i, (now, _, _) in enumerate(ticks) if now >= 3.0)
    opened = next(i for i, (_, _, open_) in enumerate(ticks) if open_)
    assert kill <= opened <= kill + 4
    assert attribution["unhealthy_regions"] == ["us-east"]
    assert any(s["series"] == "region-health" for s in attribution["top_anomalous"])
    assert ticks[-1][2] is False
    assert payload["open"] is False and len(payload["incidents"]) == 1
    assert payload["incidents"][0]["state"] == "closed"


def get(addr, path):
    try:
        with urllib.request.urlopen(f"http://{addr}{path}", timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def families_and_endpoint(pkg):
    plane, t, _, counts = drilled_plane(pkg)
    counts["good"] = 100.0
    plane.tick()
    t["now"] += 0.05
    plane.tick()
    reg = pkg.metrics.MetricsRegistry()
    plane.register_metrics(reg)
    text = reg.exposition()
    srv = pkg.metrics.MetricsServer(reg, port=0).start()
    bare = pkg.metrics.MetricsServer(pkg.metrics.MetricsRegistry(), port=0).start()
    try:
        wired, unwired = get(srv.address, "/alerts"), get(bare.address, "/alerts")
    finally:
        srv.stop()
        bare.stop()
    return text, pkg.metrics.parse_exposition(text), wired, unwired


def test_alert_plane_families_and_alerts_endpoint_as_the_reference():
    text, fams, (code, payload), (code_bare, _) = both(families_and_endpoint)
    for name in ("handel_alerts_rules_total", "handel_alerts_eval_ticks_ct",
                 "handel_alerts_series_total", "handel_alerts_firings_ct",
                 "handel_incidents_incidents_open", "handel_incidents_opened_ct"):
        assert name in fams
    assert {l.get("rule") for l, _ in fams["handel_alerts_burn_fast"]["samples"]} == {"goodput"}
    assert fams["handel_alerts_eval_ticks_ct"]["type"] == "counter"
    assert code == 200 and payload["open"] is False and payload["incidents"] == []
    assert "goodput" in payload["rules"] and "region-health" in payload["series"]
    assert code_bare == 501


def config_round_trip(pkg, tmp_path):
    cfg = pkg.config.SimConfig()
    default = cfg.alerts == pkg.config.AlertParams()
    cfg.alerts.window_scale = 0.02
    cfg.alerts.z_threshold = 8.0
    cfg.alerts.min_hold_s = 1.5
    path = tmp_path / f"alerts-{id(pkg)}.toml"
    path.write_text(pkg.config.dump_config(cfg))
    errors = []
    for body in ("[alerts]\nfast_window_s = 900.0\nslow_window_s = 60.0\n",
                 "[alerts]\nwarn_x = 20.0\npage_x = 14.4\n", "[alerts]\ngoodput_slo = 1.5\n"):
        bad = tmp_path / "bad.toml"
        bad.write_text(body)
        try:
            pkg.config.load_config(str(bad))
        except ValueError as e:
            errors.append(str(e))
    return default, path.read_text(), vars(pkg.config.load_config(str(path)).alerts), errors


def test_alerts_config_as_the_reference(tmp_path):
    default, _, loaded, errors = both(config_round_trip, tmp_path)
    assert default and loaded["window_scale"] == 0.02 and loaded["page_x"] == 14.4
    assert len(errors) == 3


def nudge(pkg):
    class _Svc:
        fill_sum = 0.0
        fill_launches = 0

        class plane:
            lanes: list = []

        def queue_depth(self):
            return 0

    sc = pkg.autoscaler.LaneAutoscaler(_Svc(), engine_factory=lambda: None, cooldown_s=3600.0)
    before = sc.values()["incidentNudgesCt"]
    sc.notify_incident("breaker-storm")
    return before, sc.incident_nudges, sc._repair_first, sc.values()


def test_autoscaler_incident_nudge_as_the_reference():
    before, nudges, repair_first, _ = both(nudge)
    assert before == 0.0 and nudges == 1 and repair_first
