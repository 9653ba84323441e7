"""The port's metrics plane (handel_tpu_torch/core/metrics.py) and device
telemetry (parallel/telemetry.py) against the JAX package's: the same
registered values give the same exposition text, the parse round trip and
the merged histograms agree, the per-process port plan is the same, the
health and readiness endpoints move through the same states, and a
disabled plane starts no thread and opens no socket.

Tolerance: exposition text, parsed families and port plans identical;
HTTP status codes and bodies identical.
"""

import asyncio
import json
import os
import random
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from handel_tpu.core import metrics as jmetrics
from handel_tpu.core.bitset import BitSet as JBitSet
from handel_tpu.core.test_harness import LocalCluster as JLocalCluster
from handel_tpu.core.trace import FlightRecorder as JFlightRecorder
from handel_tpu.core.trace import LogHistogram as JLogHistogram
from handel_tpu.models import fake as jfake
from handel_tpu.parallel.batch_verifier import BatchVerifierService as JService
from handel_tpu.parallel.plane import host_plane as jhost_plane
from handel_tpu.parallel.telemetry import DeviceTelemetry as JDeviceTelemetry
from handel_tpu.sim import config as jconfig
from handel_tpu.sim import platform as jplatform
from handel_tpu.utils.breaker import CircuitBreaker as JCircuitBreaker
from handel_tpu_torch.core import metrics as pmetrics
from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.test_harness import LocalCluster
from handel_tpu_torch.core.trace import FlightRecorder, LogHistogram
from handel_tpu_torch.models import fake
from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
from handel_tpu_torch.parallel.plane import host_plane
from handel_tpu_torch.parallel.telemetry import DeviceTelemetry
from handel_tpu_torch.sim import config as pconfig
from handel_tpu_torch.sim import platform as pplatform
from handel_tpu_torch.utils.breaker import CircuitBreaker

PORT = SimpleNamespace(m=pmetrics, Hist=LogHistogram, Breaker=CircuitBreaker,
                       Service=BatchVerifierService, config=pconfig, platform=pplatform,
                       Cluster=LocalCluster, Recorder=FlightRecorder, host_plane=host_plane,
                       BitSet=BitSet, fake=fake)
REF = SimpleNamespace(m=jmetrics, Hist=JLogHistogram, Breaker=JCircuitBreaker,
                      Service=JService, config=jconfig, platform=jplatform,
                      Cluster=JLocalCluster, Recorder=JFlightRecorder, host_plane=jhost_plane,
                      BitSet=JBitSet, fake=jfake)


def get(addr: str, path: str, method: str = "GET", timeout: float = 5):
    req = urllib.request.Request(f"http://{addr}{path}", method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class Reporter:
    """Seeded counters, gauges, labeled rows and histograms."""

    def __init__(self, pkg, seed: int):
        rng = random.Random(seed)
        self.vals = {k: float(rng.randrange(1000)) for k in (
            "msgSentCt", "sigCheckedCt", "dedupHitRate", "queueOccupancy",
            "bestCardinality", "breakerState", "hostPackMsPerLaunch")}
        self.vals["weird"] = rng.choice([float("nan"), float("inf"), -0.0, 1e-300])
        self.rows = {f"s{i}": {"queueDepth": float(rng.randrange(50)),
                               "candidates": float(rng.randrange(500))} for i in range(4)}
        self.hists = {"verifyLatencyS": pkg.Hist(), "queueWaitS": pkg.Hist()}
        for h in self.hists.values():
            for _ in range(rng.randrange(1, 200)):
                h.add(rng.lognormvariate(-4.0, 1.5))

    def values(self):
        return dict(self.vals)

    def gauge_keys(self):
        return {"bestCardinality", "hostPackMsPerLaunch"}

    def labeled_values(self):
        return self.rows

    def labeled_gauge_keys(self):
        return {"queueDepth"}

    def histograms(self):
        return self.hists


def registry(pkg, seed: int, cap: int = 0):
    reg = pkg.m.MetricsRegistry(series_cap=cap)
    for node in range(3):
        rep = Reporter(pkg, seed + node)
        reg.register_values("sigs", rep, labels={"node": str(node)})
        reg.register_histograms("sigs", rep, labels={"node": str(node)})
    reg.register_labeled_values("service", Reporter(pkg, seed + 9), label="session")
    c = reg.counter("handel_test_events", "events seen")
    c.inc(3)
    reg.gauge("handel_test_depth", "queue depth").set(7)
    h = reg.histogram("handel_test_latency_s")
    for v in (0.001, 0.002, 0.5):
        h.observe(v)
    return reg


@pytest.mark.parametrize("seed, cap", [(0, 0), (1, 0), (2, 2)])
def test_exposition_text_identical(seed, cap):
    ours, theirs = registry(PORT, seed, cap).exposition(), registry(REF, seed, cap).exposition()
    assert ours == theirs
    fams = pmetrics.parse_exposition(ours)
    # repr: NaN samples compare equal as text, never as floats
    assert repr(fams) == repr(jmetrics.parse_exposition(theirs))
    assert fams["handel_test_events"]["type"] == "counter"


@pytest.mark.parametrize("seed", range(3))
def test_parse_round_trip_and_merged_histograms(seed):
    text = registry(PORT, seed).exposition()
    fams, jfams = pmetrics.parse_exposition(text), jmetrics.parse_exposition(text)
    for name in ("handel_sigs_verify_latency_s", "handel_sigs_queue_wait_s",
                 "handel_test_latency_s"):
        ours, theirs = pmetrics.merged_histogram(fams, name), jmetrics.merged_histogram(jfams, name)
        assert (ours.counts, ours.count, ours.sum, ours.lo, ours.hi) == \
            (theirs.counts, theirs.count, theirs.sum, theirs.lo, theirs.hi)
        for q in (0.5, 0.9, 0.99):
            assert ours.quantile(q) == theirs.quantile(q)


@pytest.mark.parametrize("key", ["msgSentCt", "levelCompleteS", "dedupHitRate",
                                 "HTTPServerCt", "kernelLibsLoaded", "a_b-c"])
def test_names_and_gauge_rule_identical(key):
    assert pmetrics.snake(key) == jmetrics.snake(key)
    assert pmetrics.metric_name("device_verifier", key) == jmetrics.metric_name("device_verifier", key)
    for declared in (None, set(), {key}):
        assert pmetrics.is_gauge_key(key, declared) == jmetrics.is_gauge_key(key, declared)


def endpoint_script(pkg):
    """The reference's healthz/readyz transition: alive at once, not ready
    until warm, not ready while the breaker is open, ready after; 404 and
    501 where nothing is wired; the profile hook's reply."""
    state = {"warmed": False}
    breaker = pkg.Breaker(threshold=1, cooldown_s=3600)
    reg = pkg.m.MetricsRegistry()
    reg.add_readiness("scheme_warmed", lambda: state["warmed"])
    reg.add_readiness("breaker_closed", lambda: breaker.state != "open")
    srv = pkg.m.MetricsServer(reg, port=0).start()
    steps = []
    try:
        addr = srv.address
        steps += [get(addr, "/healthz"), get(addr, "/readyz")]
        breaker.record_failure()
        state["warmed"] = True
        steps.append(get(addr, "/readyz"))
        breaker.record_success()
        steps += [get(addr, "/readyz"), get(addr, "/nope"), get(addr, "/alerts"),
                  get(addr, "/fleet"), get(addr, "/debug/profile?seconds=0.1", "POST")]
        srv.set_profiler(lambda s: f"prof-{s}")
        steps += [get(addr, "/debug/profile?seconds=0.1", "POST"),
                  get(addr, "/debug/profile?seconds=x", "POST")]
    finally:
        srv.stop()
    return steps


def test_health_and_readiness_transitions_match():
    ours = endpoint_script(PORT)
    assert ours == endpoint_script(REF)
    assert [code for code, _ in ours] == [200, 503, 503, 200, 404, 501, 501, 501, 200, 400]


@pytest.mark.parametrize("base_port, nodes, nprocs", [(21000, 16, 4), (30000, 64, 4),
                                                      (65500, 40, 2), (0, 8, 0)])
def test_metrics_port_plan_identical(base_port, nodes, nprocs):
    def plan(pkg, metrics):
        cfg = pkg.config.SimConfig(metrics=metrics, base_port=base_port)
        try:
            return pkg.platform.metrics_port_plan(cfg, nodes, nprocs)
        except ValueError as e:
            return str(e)

    for metrics in (False, True):
        assert plan(PORT, metrics) == plan(REF, metrics)
    assert plan(PORT, False) == []


def test_write_metrics_ports_identical(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    ours = pplatform.write_metrics_ports(str(tmp_path / "p"), 2, {1: 9001, 0: 9000})
    theirs = jplatform.write_metrics_ports(str(tmp_path / "r"), 2, {1: 9001, 0: 9000})
    assert open(ours).read() == open(theirs).read()


def test_disabled_plane_starts_no_thread_and_opens_no_socket():
    def fds():
        return len(os.listdir("/proc/self/fd"))

    threads, files = threading.active_count(), fds()
    cluster = LocalCluster(4)
    assert cluster.metrics is None and cluster.metrics_server is None
    assert threading.active_count() == threads and fds() == files
    assert pplatform.metrics_port_plan(pconfig.SimConfig(), 8, 2) == []


class StubDevice:
    batch_size = 8

    def dispatch(self, msg, reqs):
        return len(reqs)

    def fetch(self, handle):
        return [True] * handle


def scrape_cluster(pkg):
    """A traced 8-node cluster with a shared stub verifier and its metrics
    endpoint: readiness before and after start, and one scrape."""
    async def go():
        svc = pkg.Service(StubDevice(), max_delay_ms=0.1)
        cluster = pkg.Cluster(8, recorder=pkg.Recorder(capacity=1 << 14), metrics_port=0,
                              verifier_service=svc)
        addr = cluster.metrics_server.address
        codes = [get(addr, "/healthz")[0], get(addr, "/readyz")[0]]
        cluster.start()
        codes.append(get(addr, "/readyz")[0])
        await cluster.wait_complete_success(10)
        text = get(addr, "/metrics")[1]
        svc.stop()
        cluster.stop()
        return codes, text, addr

    return asyncio.run(go())


def test_cluster_scrape_has_the_reference_families():
    codes, text, addr = scrape_cluster(PORT)
    jcodes, jtext, _ = scrape_cluster(REF)
    assert codes == jcodes == [200, 503, 200]
    fams, jfams = pmetrics.parse_exposition(text), jmetrics.parse_exposition(jtext)
    assert {n: f["type"] for n, f in fams.items()} == {n: f["type"] for n, f in jfams.items()}
    sent = fams["handel_sigs_msg_sent_ct"]["samples"]
    assert {lbl["node"] for lbl, _ in sent} == {str(i) for i in range(8)}
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://{addr}/healthz", timeout=0.5)


def host_service(pkg):
    """A service over a two-lane host plane that has taken one launch."""
    fk = pkg.fake
    svc = pkg.Service(pkg.host_plane(fk.FakeConstructor(), devices=2, batch_size=4),
                      max_delay_ms=0.1)
    bs = pkg.BitSet(4)
    bs.set(1, True)

    async def go():
        await svc.verify(b"m", [fk.FakePublic(True)] * 4, [(bs, fk.FakeSignature(True))])

    asyncio.run(go())
    svc.stop()
    return svc


# the reference's keys whose counterparts the port reads from torch and from
# kernels/build.py instead of XLA (parallel/telemetry.py)
XLA_KEYS = {"xlaCompileCt", "xlaCompileTimeMs", "liveArrays", "liveArrayBytes"}
PORT_KEYS = {"kernelLibsBuilt", "kernelLibsLoaded", "kernelBuildTimeMs", "memBytesReserved",
             "memBytesPeak"}


def test_device_telemetry_matches_the_reference_on_service_state():
    """The service-derived gauges read the same on the same service state;
    the reference's XLA keys have the port's own in their place, each one
    classified (declared gauge, or a counter by the naming rule)."""
    ours = DeviceTelemetry(service=host_service(PORT)).values()
    theirs = JDeviceTelemetry(service=host_service(REF)).values()
    assert set(theirs) - XLA_KEYS == set(ours) - PORT_KEYS
    for key in set(theirs) - XLA_KEYS - {"memBytesInUse"}:
        assert ours[key] == theirs[key], key
    assert ours["deviceLanes"] == 2.0 and ours["memBytesInUse"] == 0.0
    tel = DeviceTelemetry()
    assert tel.gauge_keys() <= set(tel.values())
    assert {"kernelLibsBuilt", "kernelLibsLoaded", "memBytesInUse", "memBytesReserved",
            "memBytesPeak"} <= tel.gauge_keys()
    assert not pmetrics.is_gauge_key("kernelBuildTimeMs", tel.gauge_keys())


def test_device_telemetry_on_a_missing_card_raises_not_zero():
    """Asked to read a card that is not there, the memory gauges raise (a
    scrape error) instead of reading 0."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    tel = DeviceTelemetry(device=torch.device("cuda", 0))
    with pytest.raises(RuntimeError):
        tel.values()
    reg = pmetrics.MetricsRegistry()
    reg.register_values("device", tel)
    reg.exposition()
    assert reg.scrape_errors >= 1


def test_profile_endpoint_captures_on_the_cpu(tmp_path):
    """/debug/profile through DeviceTelemetry.profile on a CPU engine: a
    capture directory with the Chrome trace and the activity summary."""
    tel = DeviceTelemetry(trace_dir=str(tmp_path))
    reg = pmetrics.MetricsRegistry()
    reg.register_values("device", tel)
    srv = pmetrics.MetricsServer(reg, port=0, profiler=tel.profile).start()
    try:
        # a CPU torch.profiler capture takes seconds, more under parallel
        # test workers: this request gets its own limit
        code, body = get(srv.address, "/debug/profile?seconds=0.1", "POST", timeout=60)
    finally:
        srv.stop()
    assert code == 200
    out = json.loads(body)["trace"]
    assert os.path.isfile(os.path.join(out, "trace.json"))
    assert isinstance(json.load(open(os.path.join(out, "kernels.json"))), dict)
    assert tel.values()["profileCaptures"] == 1.0
