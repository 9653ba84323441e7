"""The port's flight recorder and trace CLI (handel_tpu_torch/core/trace.py,
sim/trace_cli.py) against the JAX package's, and the span hooks of the
port's Handel, pipeline and shared verifier beside the reference's.

Every case feeds both packages the same seeded inputs. Tolerance: exports,
merged traces and reports are compared as JSON, identical; traced rounds,
whose timestamps are wall-clock reads, are compared by their (name, phase,
category, tid) sets and by the trace CLI's invariants.
"""

import asyncio
import json
import os
import random
import subprocess
import sys
from types import SimpleNamespace

import pytest

from handel_tpu.core.bitset import BitSet as JBitSet
from handel_tpu.core.test_harness import run_cluster as jrun_cluster
from handel_tpu.core.trace import FlightRecorder as JFlightRecorder
from handel_tpu.core.trace import SERVICE_TID as JSERVICE_TID
from handel_tpu.core.trace import merge_traces as jmerge_traces
from handel_tpu.models import fake as jfake
from handel_tpu.parallel.batch_verifier import BatchVerifierService as JService
from handel_tpu.parallel.plane import host_plane as jhost_plane
from handel_tpu.sim import trace_cli as jtrace_cli
from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.test_harness import LocalCluster, run_cluster
from handel_tpu_torch.core.trace import SERVICE_TID, FlightRecorder, merge_traces
from handel_tpu_torch.models import fake
from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
from handel_tpu_torch.parallel.plane import host_plane
from handel_tpu_torch.sim import trace_cli

PORT = SimpleNamespace(Service=BatchVerifierService, host_plane=host_plane, BitSet=BitSet,
                       fake=fake)
REF = SimpleNamespace(Service=JService, host_plane=jhost_plane, BitSet=JBitSet, fake=jfake)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def record(rec, seed: int, n: int = 40) -> None:
    """A seeded script of spans, instants, flows and thread names."""
    rng = random.Random(seed)
    for tid in range(4):
        rec.name_thread(tid, f"node-{tid}")
    rec.name_thread(-1, "batch-verifier")
    t = 1.7e9 + rng.random()
    for i in range(n):
        t += rng.random() * 1e-3
        kind = rng.randrange(4)
        tid = rng.randrange(-1, 4)
        if kind == 0:
            rec.span("verify", t, t + rng.random() * 1e-2, tid=tid, cat="pipeline",
                     args={"origin": rng.randrange(64), "level": rng.randrange(7)})
        elif kind == 1:
            rec.instant("level_complete", ts=t, tid=tid, cat="protocol",
                        args={"level": rng.randrange(7)})
        elif kind == 2:
            rec.flow("contrib", rng.randrange(1, 1 << 50), rng.choice("stf"), t, tid=tid)
        else:
            rec.span("send", t, t + 1e-4, tid=tid)


@pytest.mark.parametrize("seed, capacity", [(0, 1 << 10), (1, 16), (2, 1)])
def test_recorder_exports_identical_json(seed, capacity):
    """Same events, same ring: identical export (ring wrap included), dump
    file, values() keys and gauge keys."""
    ours, theirs = FlightRecorder(capacity=capacity, pid=7), JFlightRecorder(capacity=capacity, pid=7)
    for rec in (ours, theirs):
        record(rec, seed)
        rec.clock_offset = 0.125 * (seed + 1)
    assert json.dumps(ours.export()) == json.dumps(theirs.export())
    assert ours.dropped == theirs.dropped
    assert ours.values().keys() == theirs.values().keys()
    assert ours.values()["traceDropped"] == theirs.values()["traceDropped"]
    assert ours.gauge_keys() == theirs.gauge_keys()
    assert SERVICE_TID == JSERVICE_TID


def test_disabled_recorder_records_nothing():
    ours, theirs = FlightRecorder(enabled=False), JFlightRecorder(enabled=False)
    for rec in (ours, theirs):
        record(rec, 3)
    assert ours.events() == theirs.events() == []


@pytest.mark.parametrize("offsets", [(0.0, 0.0), (0.25, -0.5), (1e-4, 3.0)])
def test_merge_traces_identical_with_offsets(offsets):
    exports = []
    for pid, off in enumerate(offsets):
        rec = FlightRecorder(pid=pid)
        record(rec, 10 + pid)
        rec.clock_offset = off
        exports.append(rec.export())
    twins = json.loads(json.dumps(exports))
    assert json.dumps(merge_traces(exports)) == json.dumps(jmerge_traces(twins))


def span_set(rec) -> set:
    return {(e["name"], e["ph"], e.get("cat", ""), e["tid"]) for e in rec.export()["traceEvents"]}


def test_traced_cluster_has_the_reference_spans():
    """A traced 8-node LocalCluster on the fake scheme records the
    reference's span names, categories and tids per node."""
    ours, theirs = FlightRecorder(), JFlightRecorder()
    asyncio.run(run_cluster(8, recorder=ours))
    asyncio.run(jrun_cluster(8, recorder=theirs))
    assert span_set(ours) == span_set(theirs)
    names = {n for n, *_ in span_set(ours)}
    assert {"send", "net_transit", "recv", "queue", "verify", "merge", "contrib",
            "level_complete", "threshold_reached", "thread_name"} <= names


@pytest.fixture(scope="module")
def traced_dirs(tmp_path_factory):
    """Trace files of a 16-node traced round of each package."""
    out = {}
    for label, rec, runner in (("port", FlightRecorder(pid=1), run_cluster),
                               ("ref", JFlightRecorder(pid=2), jrun_cluster)):
        asyncio.run(runner(16, recorder=rec))
        d = tmp_path_factory.mktemp(f"trace_{label}")
        rec.dump(str(d / "trace_0.json"))
        out[label] = str(d)
    return out


@pytest.mark.parametrize("which", ["port", "ref"])
def test_trace_clis_give_identical_reports(traced_dirs, which):
    """Both packages' trace CLIs give the same stream_report and
    build_report for the same trace files, from either package's round."""
    d = traced_dirs[which]
    assert trace_cli.stream_report([d]) == jtrace_cli.stream_report([d])
    exports = trace_cli.load_exports([d])
    events = merge_traces(exports)["traceEvents"]
    jevents = jmerge_traces(jtrace_cli.load_exports([d]))["traceEvents"]
    assert trace_cli.build_report(events, exports) == jtrace_cli.build_report(jevents, exports)


def test_critical_path_covers_time_to_threshold(traced_dirs):
    """The reference's acceptance on the port's own round: one causal chain
    from the first threshold_reached covering 90% of the wall or more, and
    every recv linked to its sender's span."""
    events = trace_cli.load_traces([traced_dirs["port"]])
    cp = trace_cli.critical_path(events)
    assert cp is not None and cp["chain"] and cp["coverage"] >= 0.90
    assert {"recv", "verify", "merge", "net_transit"} <= {e["name"] for e in cp["chain"]}
    frac, _linked, total = trace_cli.flow_linkage(events)
    assert total > 0 and frac >= 0.95


def test_trace_subcommand_writes_the_report(traced_dirs, tmp_path):
    report = tmp_path / "r.json"
    out = subprocess.run(
        [sys.executable, "-m", "handel_tpu_torch.sim", "trace", traced_dirs["port"],
         "--critical-path", "--report", str(report)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "critical path to threshold" in out.stdout
    rep = json.loads(report.read_text())
    assert rep["backend"] == "trace" and rep["critical_path"]["coverage"] >= 0.90


def traced_service(pkg, rec, devices: int):
    """Four sessions' candidates through a service (traced into `rec`) over
    a host plane of the fake scheme; returns the verdicts."""
    pks = [pkg.fake.FakePublic(True) for _ in range(8)]
    plane = pkg.host_plane(pkg.fake.FakeConstructor(), devices=devices, batch_size=4)

    def req(i):
        bs = pkg.BitSet(8)
        bs.set(i % 8, True)
        return bs, pkg.fake.FakeSignature(i % 3 != 0)

    async def go():
        svc = pkg.Service(plane, recorder=rec, max_delay_ms=0.5)
        try:
            return await asyncio.gather(*(
                svc.verify(b"m", pks, [req(4 * s + j) for j in range(4)], session=f"s{s}")
                for s in range(4)))
        finally:
            svc.stop()

    return asyncio.run(go())


@pytest.mark.parametrize("devices", [1, 2])
def test_traced_service_has_the_reference_spans(devices):
    """The service's spans and instants: the same names, categories and
    thread ids (SERVICE_TID and one per lane, named) as the reference's, the
    same verdicts, and one launch span per launch."""
    ours, theirs = FlightRecorder(), JFlightRecorder()
    got = traced_service(PORT, ours, devices)
    want = traced_service(REF, theirs, devices)
    assert got == want
    assert span_set(ours) == span_set(theirs)
    threads = {e["tid"]: e["args"]["name"] for e in ours.export()["traceEvents"] if e["ph"] == "M"}
    assert threads[SERVICE_TID] == "batch-verifier"
    assert {threads[-2 - i] for i in range(devices)} == {f"device-lane-{i}" for i in range(devices)}
    names = [e["name"] for e in ours.export()["traceEvents"]]
    assert names.count("device_verify") == names.count("dispatch_pack") >= 1


def test_untraced_service_and_lane_hold_no_recorder():
    """Untraced, every hook is one `is None` test: the service holds no
    recorder and never stamps a lane's queued time."""
    assert traced_service(PORT, None, 1) == traced_service(REF, None, 1)
    plane = host_plane(fake.FakeConstructor(), devices=1, batch_size=4)
    svc = BatchVerifierService(plane)
    assert svc.rec is None and plane.lanes[0].queued_ts == 0.0
    assert plane.lanes[0].trace_tid == -2


def test_untraced_cluster_records_nothing():
    cluster = LocalCluster(4)
    assert all(h.rec is None and h.proc.rec is None for h in cluster.handels.values())


def test_trace_smoke(tmp_path, capsys):
    """The port's counterpart of scripts/trace_smoke.py at its default size
    (16 nodes): every check passes and the report is written."""
    from handel_tpu_torch.scripts import trace_smoke

    assert trace_smoke.main(["--artifact-dir", str(tmp_path)]) == 0
    assert "trace smoke OK" in capsys.readouterr().out
    report = json.loads((tmp_path / "trace_report.json").read_text())
    assert report["backend"] == "trace" and report["critical_path_coverage"] >= 0.90
