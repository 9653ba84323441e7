"""The port's hierarchical roll-ups (handel_tpu_torch/obs/rollup.py) against
the JAX package's handel_tpu/obs/rollup.py.

The cases of tests/test_rollup.py run on both packages with the same
seeded surfaces, histograms and manual clocks: host digests, chunked
deltas, the master's merged state under shuffled and repeated delivery,
stale drops and heartbeats, the trace digest, the host-kill drill fed
only from roll-ups, and the handel_fleet_* families and /fleet body must
be what the reference gives. Tolerance: exact (values on the 1/1024 grid,
so float sums are associative).
"""

from __future__ import annotations

import json
import random
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from handel_tpu.core import metrics as jmetrics
from handel_tpu.core import trace as jtrace
from handel_tpu.obs import plane as jplane
from handel_tpu.obs import rollup as jrollup
from handel_tpu.obs import slo as jslo
from handel_tpu.sim import config as jconfig
from handel_tpu.sim import monitor as jmonitor
from handel_tpu_torch.core import metrics as pmetrics
from handel_tpu_torch.core import trace as ptrace
from handel_tpu_torch.obs import plane as pplane
from handel_tpu_torch.obs import rollup as prollup
from handel_tpu_torch.obs import slo as pslo
from handel_tpu_torch.sim import config as pconfig
from handel_tpu_torch.sim import monitor as pmonitor

REF = SimpleNamespace(rollup=jrollup, metrics=jmetrics, trace=jtrace, plane=jplane,
                      slo=jslo, config=jconfig, monitor=jmonitor)
PORT = SimpleNamespace(rollup=prollup, metrics=pmetrics, trace=ptrace, plane=pplane,
                       slo=pslo, config=pconfig, monitor=pmonitor)


def plain(x):
    """Histograms as their sparse wire form, so results compare by value."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if hasattr(x, "to_sparse"):
        return ("hist", x.to_sparse())
    return x


def both(case, *args):
    got, ref = plain(case(PORT, *args)), plain(case(REF, *args))
    assert got == ref
    return got


def exact(rng):
    return rng.randrange(1, 1 << 20) / 1024.0


def surfaces(rng, n):
    return [({"msgSentCt": exact(rng), "verifiedCt": exact(rng), "levelRate": exact(rng)},
             {"levelRate"}) for _ in range(n)]


def mk_host(pkg, name, surf, hist_values):
    hr = pkg.rollup.HostRollup(name, clock=lambda: 0.0)
    hr.attach_fold("swarm", lambda: list(surf))

    class _Rep:
        def values(self):
            return {"launchesCt": sum(v[0]["msgSentCt"] for v in surf)}

        def gauge_keys(self):
            return set()

        def histograms(self):
            h = pkg.trace.LogHistogram()
            for v in hist_values:
                h.add(v)
            return {"verifyLatencyS": h}

    hr.attach_reporter("device", _Rep())
    return hr


def histograms(pkg):
    rng = random.Random(11)
    parts = []
    for _ in range(8):
        h = pkg.trace.LogHistogram()
        for _ in range(rng.randrange(1, 200)):
            h.add(exact(rng))
        parts.append(h)
    merges = []
    for seed in range(6):
        order = list(range(len(parts)))
        random.Random(seed).shuffle(order)
        m = pkg.trace.LogHistogram()
        for i in order:
            m.merge(parts[i])
        merges.append(m.to_sparse())
    back = pkg.trace.LogHistogram.from_sparse(merges[0])
    return merges, back.to_sparse(), back.copy().to_sparse()


def test_histogram_merges_as_the_reference():
    merges, back, copied = both(histograms)
    assert all(m == merges[0] for m in merges) and back == copied == merges[0]


def two_level(pkg):
    rng = random.Random(42)
    per_host = [surfaces(rng, 16) for _ in range(4)]
    per_hist = [[exact(rng) for _ in range(50)] for _ in range(4)]
    fleet = pkg.rollup.FleetRollup(clock=lambda: 0.0)
    digests = []
    for i in range(4):
        d = mk_host(pkg, f"h{i}", per_host[i], per_hist[i]).digest()
        digests.append(d)
        fleet.ingest_digest(d)
    flat = pkg.rollup.HostRollup("flat", clock=lambda: 0.0)
    flat_surfaces = [s for hs in per_host for s in hs]
    flat.attach_fold("swarm", lambda: list(flat_surfaces))
    return digests, fleet.merged(), flat.digest()


def test_two_level_merge_as_the_reference():
    _, two, flat = both(two_level)
    for k in ("swarm.msgSentCt", "swarm.verifiedCt"):
        assert two["counters"][k] == flat["counters"][k]
    assert two["gauges"]["swarm.levelRate"] == flat["gauges"]["swarm.levelRate"]


def over_wire(pkg):
    rng = random.Random(7)
    hosts = [mk_host(pkg, f"h{i}", surfaces(rng, 8), [exact(rng) for _ in range(400)])
             for i in range(3)]
    ref = pkg.rollup.FleetRollup(clock=lambda: 0.0)
    chunk_sets = []
    for hr in hosts:
        ref.ingest_digest(hr.digest())
        chunk_sets.append(pkg.rollup.chunk_delta(hr.delta()))
    states = []
    for seed in range(4):
        srng = random.Random(seed)
        chunks = [c for cs in chunk_sets for c in cs]
        chunks = chunks + srng.sample(chunks, len(chunks) // 2)
        srng.shuffle(chunks)
        fleet = pkg.rollup.FleetRollup(clock=lambda: 0.0)
        for c in chunks:
            fleet.ingest(json.loads(json.dumps(c)))
        states.append(fleet.merged())
    return chunk_sets, states, ref.merged()


def test_chunked_delivery_as_the_reference():
    chunk_sets, states, ref = both(over_wire)
    assert all(len(json.dumps(c).encode()) <= prollup.MAX_DATAGRAM
               for cs in chunk_sets for c in cs)
    for st in states:
        assert {k: st[k] for k in ("counters", "gauges", "hists")} == {
            k: ref[k] for k in ("counters", "gauges", "hists")}


def bounded(pkg):
    out = {}
    for n in (64, 4096):
        rng = random.Random(9)
        hr = pkg.rollup.HostRollup(f"host-{n}", clock=lambda: 0.0)
        surf = surfaces(rng, n)
        hr.attach_fold("swarm", lambda surf=surf: list(surf))
        out[n] = (hr.series_count(), [len(json.dumps(c).encode())
                                      for c in pkg.rollup.chunk_delta(hr.delta())],
                  hr.digest()["surfaces"])
    return out


def test_digest_bounded_as_the_reference():
    got = both(bounded)
    assert got[64][0] == got[4096][0] == 3 and got[4096][2] == 4096


def redelivery(pkg):
    state = {"v": 0.0}
    hr = pkg.rollup.HostRollup("h0", clock=lambda: 0.0)
    hr.attach_fold("svc", lambda: [({"workCt": state["v"], "depth": state["v"] / 2.0},
                                    {"depth"})])
    once = pkg.rollup.FleetRollup(clock=lambda: 0.0)
    twice = pkg.rollup.FleetRollup(clock=lambda: 0.0)
    for step in range(5):
        state["v"] += 16.0
        chunks = pkg.rollup.chunk_delta(hr.delta())
        for c in chunks:
            once.ingest(c)
        dup = chunks * 2
        random.Random(step).shuffle(dup)
        for c in dup:
            twice.ingest(c)
    return once.merged(), twice.merged(), twice.stale_drops


def test_delta_redelivery_as_the_reference():
    a, b, stale = both(redelivery)
    assert a["counters"] == b["counters"] and a["gauges"] == b["gauges"] and stale == 0


def stale_and_heartbeat(pkg):
    state = {"v": 1.0}
    hr = pkg.rollup.HostRollup("h0", clock=lambda: 0.0)
    hr.attach_fold("svc", lambda: [({"workCt": state["v"]}, set())])
    fleet = pkg.rollup.FleetRollup(clock=lambda: 0.0)
    first = pkg.rollup.chunk_delta(hr.delta())
    for c in first:
        fleet.ingest(c, now=1.0)
    state["v"] = 2.0
    for c in pkg.rollup.chunk_delta(hr.delta()):
        fleet.ingest(c, now=2.0)
    late = fleet.ingest(first[0], now=3.0)
    quiet = pkg.rollup.chunk_delta(hr.delta())
    beat = fleet.ingest(quiet[0], now=4.0)
    return (late, fleet.stale_drops, fleet.merged()["counters"], quiet, beat,
            fleet.lost_hosts(now=4.1))


def test_stale_drop_and_heartbeat_as_the_reference():
    late, drops, counters, quiet, beat, lost = both(stale_and_heartbeat)
    assert late is False and drops == 1 and counters["svc.workCt"] == 2.0
    assert len(quiet) == 1 and set(quiet[0]["rollup"]) == {"host", "seq"}
    assert beat is True and lost == []


def host_kill(pkg):
    t = {"now": 0.0}
    ap = pkg.config.AlertParams(window_scale=0.01, min_hold_s=0.5, cooldown_s=2.0)
    plane = pkg.plane.AlertPlane.from_params(ap, clock=lambda: t["now"])
    fleet = pkg.rollup.FleetRollup(top_k=4, stale_after_s=0.5, clock=lambda: t["now"])
    counts = {f"h{i}": 0.0 for i in range(4)}
    hosts = {}
    for name in counts:
        hr = pkg.rollup.HostRollup(name, clock=lambda: t["now"])
        hr.attach_fold("svc", lambda name=name: [({"goodCt": counts[name], "badCt": 0.0},
                                                  set())])
        hosts[name] = hr
    fleet.attach_alerts(plane, burn_rules=[(pkg.slo.BurnRule("fleet-goodput", budget=0.05),
                                            "svc.goodCt", "svc.badCt")])
    log = []

    def step(emit=frozenset(counts)):
        for name in counts:
            counts[name] += 5.0
        for name in sorted(emit):
            hosts[name].emit(fleet.ingest)
        plane.tick()
        log.append((round(t["now"], 6), fleet.hosts_up(), plane.incidents.current is not None))
        t["now"] += 0.05

    while t["now"] < 2.0:
        step()
    kill_t = t["now"]
    live = frozenset(n for n in counts if n != "h2")
    while t["now"] < kill_t + 2.0:
        step(emit=live)
    inc = plane.incidents.current
    attribution = None if inc is None else {k: inc.attribution[k]
                                            for k in ("lost_hosts", "fleet")}
    recover_t = t["now"]
    while t["now"] < recover_t + 2.0:
        step()
    return log, attribution, plane.incidents.opened, plane.alerts_payload()["incidents"]


def test_host_kill_drill_as_the_reference():
    log, attribution, opened, incidents = both(host_kill)
    assert attribution["lost_hosts"] == ["h2"] and attribution["fleet"]["hosts_up"] == 3
    assert opened == 1 and incidents[0]["state"] == "closed"
    assert log[-1][1:] == (4, False)


def trace_digests(pkg):
    events = [{"ph": "X", "name": ("verify", "pack", "gossip")[i % 3], "ts": float(i * 10),
               "dur": 8.0, "pid": 0, "tid": 0} for i in range(5000)]
    d = pkg.rollup.trace_digest(events)
    slow = dict(d, wall_ms=d["wall_ms"] * 3)
    return d, pkg.rollup.merge_trace_digests([("fast", d), ("slow", slow)])


def test_trace_digest_as_the_reference():
    d, m = both(trace_digests)
    assert d["spans"] == 5000 and len(d["chain_tail"]) <= 8
    assert m["slowest_host"] == "slow" and m["spans"] == 10000


def fleet_surfaces(pkg):
    fleet = pkg.rollup.FleetRollup(top_k=4, clock=lambda: 0.0)
    for name in ("hostA", "hostB"):
        hr = pkg.rollup.HostRollup(name, clock=lambda: 0.0)
        hr.attach_fold("svc", lambda: [({"launchesCt": 5.0, "queueDepth": 2.0},
                                        {"queueDepth"})])
        hr.tick()
        hr.emit(fleet.ingest)
    fleet.mark_lost("hostB")
    reg = pkg.metrics.MetricsRegistry()
    fleet.register_metrics(reg)
    text = reg.exposition()
    srv = pkg.metrics.MetricsServer(reg, port=0).start()
    bare = pkg.metrics.MetricsServer(pkg.metrics.MetricsRegistry(), port=0).start()
    try:
        with urllib.request.urlopen(f"http://{srv.address}/fleet", timeout=5) as r:
            body = json.loads(r.read())
        try:
            urllib.request.urlopen(f"http://{bare.address}/fleet", timeout=5)
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
    finally:
        srv.stop()
        bare.stop()
    # the master's merge wall is the one value on a real clock
    text = "\n".join(l for l in text.splitlines() if "last_merge_ms" not in l)
    body = {k: v for k, v in body.items() if k != "last_merge_ms"}
    return text, body, code


def test_fleet_families_and_endpoint_as_the_reference():
    text, body, code = both(fleet_surfaces)
    fams = pmetrics.parse_exposition(text)
    rows = {l["host"]: v for l, v in fams["handel_fleet_host_up"]["samples"]}
    assert rows == {"hostA": 1.0, "hostB": 0.0}
    assert body["hosts_up"] == 1 and body["lost_hosts"] == ["hostB"]
    assert code == 501


def test_rollup_budget_matches_both_monitor_sinks():
    assert prollup.MAX_DATAGRAM == pmonitor.MAX_DATAGRAM == jrollup.MAX_DATAGRAM


def rollup_config(pkg, tmp_path):
    cfg = pkg.config.SimConfig()
    cfg.alerts.series_cap = 512
    cfg.alerts.rollup_top_k = 4
    cfg.alerts.rollup_interval_s = 0.5
    cfg.alerts.rollup_stale_s = 2.5
    path = tmp_path / "rollup.toml"
    path.write_text(pkg.config.dump_config(cfg))
    loaded = pkg.config.load_config(str(path))
    errors = []
    for body in ("[alerts]\nseries_cap = -1\n", "[alerts]\nrollup_top_k = 0\n",
                 "[alerts]\nrollup_interval_s = 0.0\n", "[alerts]\nrollup_stale_s = -2.0\n"):
        bad = tmp_path / "bad.toml"
        bad.write_text(body)
        with pytest.raises(ValueError) as ei:
            pkg.config.load_config(str(bad))
        errors.append(str(ei.value))
    return path.read_text(), vars(loaded.alerts), errors


def test_rollup_config_as_the_reference(tmp_path):
    _, loaded, errors = both(rollup_config, tmp_path)
    assert loaded["series_cap"] == 512 and loaded["rollup_stale_s"] == 2.5
    assert len(errors) == 4
