"""The port's virtual-node swarm (handel_tpu_torch/swarm/, the swarm half of
sim/monitor.py and the `swarm` subcommand) against the JAX package's, after
tests/test_swarm.py.

Tolerance: exact for everything that does not follow the host's timing:
router frames byte for byte (and across the packages on real sockets),
router, pager and wheel counters, `_split`, `merge_summaries`, the monitor
`Rollup`, `deep_size` on plain data, and the vnode wiring. Swarm runs
verify on executor threads and stamp wall clocks, so a run is held by its
invariants: every vnode completes, the summaries carry the same keys, and
where every vnode needs every signature (threshold = committee) both
packages retire every level, so `retired_level_ct` is equal.
"""

import asyncio
import json
import os
import random
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from handel_tpu.core import store as jstore
from handel_tpu.core import timeout as jtimeout
from handel_tpu.core.bitset import BitSet as JBitSet
from handel_tpu.core.net import Packet as JPacket
from handel_tpu.models import fake as jfake
from handel_tpu.parallel import batch_verifier as jbatch_verifier
from handel_tpu.service import driver as jservice
from handel_tpu.sim import config as rconfig
from handel_tpu.sim import monitor as rmonitor
from handel_tpu.swarm import driver as rdriver
from handel_tpu.swarm import mem as rmem
from handel_tpu.swarm import pager as rpager
from handel_tpu.swarm import router as rrouter
from handel_tpu.swarm import vnode as rvnode
from handel_tpu_torch.core import store, timeout
from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.net import Packet
from handel_tpu_torch.models import fake
from handel_tpu_torch.parallel import batch_verifier
from handel_tpu_torch.service import driver as service_driver
from handel_tpu_torch.sim import config as pconfig
from handel_tpu_torch.sim import monitor as pmonitor
from handel_tpu_torch.swarm import driver as pdriver
from handel_tpu_torch.swarm import mem as pmem
from handel_tpu_torch.swarm import pager as ppager
from handel_tpu_torch.swarm import router as prouter
from handel_tpu_torch.swarm import vnode as pvnode

ROOT = Path(__file__).resolve().parents[1]
PORT = SimpleNamespace(router=prouter, pager=ppager, driver=pdriver, vnode=pvnode,
                       Packet=Packet, BitSet=BitSet, config=pconfig, monitor=pmonitor,
                       store=store, timeout=timeout, fake=fake,
                       batch_verifier=batch_verifier, service=service_driver)
REF = SimpleNamespace(router=rrouter, pager=rpager, driver=rdriver, vnode=rvnode,
                      Packet=JPacket, BitSet=JBitSet, config=rconfig, monitor=rmonitor,
                      store=jstore, timeout=jtimeout, fake=jfake,
                      batch_verifier=jbatch_verifier, service=jservice)
SIDES = pytest.mark.parametrize("side", [PORT, REF], ids=["port", "ref"])


def run(coro):
    return asyncio.run(coro)


class _Sink:
    def __init__(self):
        self.got = []

    def new_packet(self, p):
        self.got.append(p)


class _Wire:
    """A transport that keeps every datagram it is handed."""

    def __init__(self):
        self.sent = []

    def sendto(self, data, addr):
        self.sent.append((data, addr))

    def close(self):
        pass


def _idents(*ids):
    return [SimpleNamespace(id=i) for i in ids]


# -- router ----------------------------------------------------------------


@SIDES
def test_router_local_short_circuit_shares_one_packet(side):
    async def go():
        r = side.router.SwarmRouter(block=16)
        sinks = {i: _Sink() for i in (0, 1, 2)}
        for i, s in sinks.items():
            r.register(i, s)
        p = side.Packet(origin=5, level=1, multisig=b"\x00\x08\xff")
        r.route(_idents(0, 1, 2), p)
        await asyncio.sleep(0)  # call_soon drains on the next loop turn
        for s in sinks.values():
            assert len(s.got) == 1
            assert s.got[0] is p  # the SAME object, no encode/decode
        return r.values()

    v = run(go())
    assert v["swarmLocalDelivered"] == 3.0
    assert v["swarmUdpSent"] == 0.0


def test_router_unknown_recipient_counted_not_raised():
    async def go(side):
        r = side.router.SwarmRouter(block=16)  # no ports, no socket
        r.route(_idents(99), side.Packet(origin=0, level=1, multisig=b""))
        return r.values()

    ours, theirs = run(go(PORT)), run(go(REF))
    assert ours == theirs
    assert ours["swarmUnknownRecipient"] == 1.0


@pytest.mark.parametrize("seed", range(4))
def test_router_frames_are_the_references_byte_for_byte(seed):
    """Seeded packets to seeded recipients over a 4-process layout: the
    datagrams (recipient frame + Packet encoding) and their addresses, and
    every counter, equal the reference's."""
    rng = random.Random(seed)
    ports = [40001, 40002, 40003, 40004]
    plan = []
    for _ in range(30):
        origin, level = rng.randrange(64), rng.randrange(1, 7)
        payload = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40)))
        span, hop = rng.choice([0, rng.randrange(1, 1 << 40)]), rng.randrange(3)
        to = rng.sample(range(72), rng.randrange(1, 6))  # ids >= 64: nobody hosts them
        plan.append((origin, level, payload, span, hop, to))

    async def go(side):
        r = side.router.SwarmRouter(block=16, ports=ports)
        r._transport = _Wire()
        for i in range(16):  # this process hosts ids 0..15
            r.register(i, _Sink())
        for origin, level, payload, span, hop, to in plan:
            r.route(_idents(*to), side.Packet(origin=origin, level=level, multisig=payload,
                                              sent_ts=1.5, span_id=span, hop=hop))
        await asyncio.sleep(0)
        return r._transport.sent, r.values()

    ours, theirs = run(go(PORT)), run(go(REF))
    assert ours == theirs
    assert ours[1]["swarmUdpSent"] > 0 and ours[1]["swarmUnknownRecipient"] > 0


def test_router_udp_cross_process_frame_between_the_packages():
    """Two routers on real sockets, one of each package: a packet for the
    other block rides the shared socket with the recipient-id frame and
    decodes on arrival, both ways."""
    from handel_tpu_torch.sim.platform import free_ports

    async def go():
        ports = free_ports(2)
        a = prouter.SwarmRouter(block=4, ports=ports)
        b = rrouter.SwarmRouter(block=4, ports=ports)
        await a.open(ports[0])
        await b.open(ports[1])
        try:
            to_b, to_a = _Sink(), _Sink()
            b.register(5, to_b)  # id 5 // block 4 -> process 1
            a.register(2, to_a)
            p = Packet(origin=0, level=2, multisig=b"\x00\x08\x0f")
            q = JPacket(origin=7, level=3, multisig=b"\x00\x10\xff\x01")
            a.route(_idents(5), p)
            b.route(_idents(2), q)
            for _ in range(100):
                if to_b.got and to_a.got:
                    break
                await asyncio.sleep(0.01)
            return to_b.got, to_a.got, a.values(), b.values()
        finally:
            a.close()
            b.close()

    got_b, got_a, va, vb = run(go())
    assert [(x.origin, x.level, x.multisig) for x in got_b] == [(0, 2, b"\x00\x08\x0f")]
    assert [(x.origin, x.level, x.multisig) for x in got_a] == [(7, 3, b"\x00\x10\xff\x01")]
    assert va["swarmUdpSent"] == vb["swarmUdpSent"] == 1.0
    assert va["swarmUdpRcvd"] == vb["swarmUdpRcvd"] == 1.0


@pytest.mark.parametrize("datagram", [
    b"", b"\x00",  # shorter than the frame header
    b"\x00\x00\x00\x63junk",  # unknown recipient 99
    b"\x00\x00\x00\x01\xff",  # undecodable Packet payload
    b"\x00\x00\x00\x01" + bytes(range(40)),
])
def test_router_bad_datagrams_dropped_and_counted_alike(datagram):
    out = []
    for side in (PORT, REF):
        r = side.router.SwarmRouter(block=4)
        sink = _Sink()
        r.register(1, sink)
        r._on_datagram(datagram)
        out.append((r.values(), len(sink.got)))
    assert out[0] == out[1]
    assert out[0][0]["swarmUdpRcvd"] + out[0][0]["swarmUdpRcvdBad"] \
        + out[0][0]["swarmUnknownRecipient"] == 1.0


# -- registry pager --------------------------------------------------------


@pytest.mark.parametrize("seed, chunk_bits", [(0, 6), (1, 6), (2, 7), (3, 9)])
def test_pager_touched_chunks_equal_over_seeded_bitsets(seed, chunk_bits):
    rng = random.Random(seed)
    for _ in range(20):
        n = rng.choice([64, 200, 512, 1000, 4096])
        bits = rng.sample(range(n), rng.randrange(0, min(n, 40)))
        chunks = []
        for side in (PORT, REF):
            bs = side.BitSet(n)
            for b in bits:
                bs.set(b)
            chunks.append(side.pager.RegistryPager(chunk_bits=chunk_bits).touched_chunks(bs))
        assert chunks[0] == chunks[1] == {b >> chunk_bits for b in bits}


@pytest.mark.parametrize("seed, budget", [(0, 1), (1, 2), (2, 4), (3, 8)])
def test_pager_lru_counters_equal_over_seeded_sequences(seed, budget):
    rng = random.Random(seed)
    seq = [set(rng.sample(range(12), rng.randrange(0, 5))) for _ in range(60)]
    out = []
    for side in (PORT, REF):
        committed = []
        pager = side.pager.RegistryPager(
            chunk_bits=6, budget_chunks=budget,
            on_commit=lambda lo, hi, c=committed: c.append((lo, hi)),
        )
        trail = []
        for chunks in seq:
            pager.ensure(chunks)
            trail.append((pager.resident_chunks(), list(pager._resident)))
        out.append((committed, trail, pager.values(), pager.gauge_keys()))
    assert out[0] == out[1]
    assert out[0][2]["pageEvictions"] > 0 or budget >= 12
    with pytest.raises(ValueError, match="chunk_bits"):
        ppager.RegistryPager(chunk_bits=5)


def test_pager_lru_eviction_and_hits():
    committed = []
    pager = ppager.RegistryPager(
        chunk_bits=6, budget_chunks=2,
        on_commit=lambda lo, hi: committed.append((lo, hi)),
    )
    pager.ensure({0, 1})
    pager.ensure({0})  # hit, refreshes 0
    pager.ensure({2})  # evicts 1 (LRU), not 0
    assert pager.resident_chunks() == 2
    assert committed == [(0, 64), (64, 128), (128, 192)]
    v = pager.values()
    assert (v["pageHits"], v["pagesCommitted"], v["pageEvictions"]) == (1.0, 3.0, 1.0)


@SIDES
def test_paged_device_pages_before_launch(side):
    class _Engine:
        batch_size = 4

        def __init__(self):
            self.launched = []

        def dispatch_multi(self, items):
            self.launched.append(len(items))
            return "h"

        def fetch(self, handle):
            return [True]

    eng = _Engine()
    pager = side.pager.RegistryPager(chunk_bits=6, budget_chunks=4)
    dev = side.pager.PagedDevice(eng, pager)
    bs = side.BitSet(256)
    bs.set(100)
    assert dev.batch_size == 4
    assert dev.dispatch_multi([(b"m", None, bs, None)]) == "h"
    assert dev.fetch("h") == [True]
    assert eng.launched == [1]
    assert pager.resident_chunks() == 1  # chunk 1 (ids 64-127)


# -- share splitting / summary merge / memory walk --------------------------


def test_split_contiguous_shares_exact():
    assert pdriver._split(10, 3) == [4, 3, 3]
    assert pdriver._split(3, 5) == [1, 1, 1, 0, 0]
    for total in (0, 1, 7, 64, 4096, 65536, 65537):
        for parts in (0, 1, 2, 3, 7, 16):
            assert pdriver._split(total, parts) == rdriver._split(total, parts)
    assert sum(pdriver._split(65536, 7)) == 65536


@pytest.mark.parametrize("seed", range(4))
def test_merge_summaries_exact(seed):
    rng = random.Random(seed)
    parts = []
    for i in range(rng.randrange(1, 5)):
        ids = rng.randrange(1, 5000)
        parts.append({
            "threshold": 3, "identities": ids, "completed": rng.choice([ids, ids - 1]),
            "rss_bytes": rng.randrange(1, 1 << 30), "wall_s": rng.uniform(0, 60),
            "ttt_max_s": rng.uniform(0, 60), "ttt_p50_s": rng.uniform(0, 9),
            "ttt_p90_s": rng.uniform(0, 9), "vnode_bytes_mean": rng.uniform(0, 1e4),
            "stale_retired_ct": rng.randrange(100), "retired_level_ct": rng.randrange(100),
            "verifier_launches": rng.randrange(100), "verifier_candidates": rng.randrange(999),
            "dedup_hits": rng.randrange(99), "swarmLocalDelivered": float(rng.randrange(999)),
            "swarmUdpSent": float(rng.randrange(99)), "pagesCommitted": float(rng.randrange(9)),
            "pageHits": float(rng.randrange(99)), "proc_index": i,
        })
    ours, theirs = pdriver.merge_summaries(parts), rdriver.merge_summaries(parts)
    assert json.dumps(ours) == json.dumps(theirs)
    assert pdriver.merge_summaries([]) == rdriver.merge_summaries([])


def test_merge_summaries():
    base = {
        "threshold": 3, "vnode_bytes_mean": 100.0, "stale_retired_ct": 0,
        "retired_level_ct": 2, "verifier_launches": 1,
        "verifier_candidates": 2, "dedup_hits": 0,
        "swarmLocalDelivered": 10.0, "swarmUdpSent": 0.0,
        "swarmUdpRcvd": 0.0, "swarmUdpBytesSent": 0.0,
        "pagesCommitted": 1.0, "pageHits": 0.0,
    }
    parts = [
        {**base, "identities": 4, "completed": 4, "rss_bytes": 1000, "ttt_max_s": 1.0,
         "wall_s": 2.0, "ttt_p50_s": 0.5, "ttt_p90_s": 0.8},
        {**base, "identities": 4, "completed": 3, "rss_bytes": 1000, "ttt_max_s": 2.0,
         "wall_s": 2.5, "ttt_p50_s": 0.6, "ttt_p90_s": 0.9},
    ]
    m = pdriver.merge_summaries(parts)
    assert (m["swarm_identities"], m["completed"], m["ok"]) == (8, 7, False)
    assert m["mem_bytes_per_identity"] == 250.0
    assert m["swarm_time_to_threshold_s"] == 2.0


def test_deep_size_equal_on_plain_data():
    import numpy as np

    shared = [1, 2, 3]
    obj = {"a": [1, 2.5, "x", b"yy", (3, 4)], "b": {"c": np.zeros(16, dtype=np.uint64)},
           "s": shared, "ns": SimpleNamespace(k=[shared, {5, 6}])}
    assert pmem.deep_size(obj, shared=[shared]) == rmem.deep_size(obj, shared=[shared])
    assert pmem.deep_size(obj) == rmem.deep_size(obj) > pmem.deep_size(obj, shared=[shared])
    assert pmem.process_rss_bytes() > 0


# -- the monitor's swarm half ----------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_monitor_rollup_record_exact(seed):
    count = random.Random(seed).randrange(5, 30)
    gauges = {"bestCardinality", "sigQueueSize"}
    records = []
    for mon in (pmonitor, rmonitor):
        r = mon.Rollup(top_k=4)
        rng2 = random.Random(seed)
        for vid in range(count):
            vals = {k: float(rng2.randrange(100)) for k in
                    ("msgSentCt", "bestCardinality", "sigQueueSize", "dedupSize", "x_p99")}
            r.add(vid, vals, gauge_keys=gauges,
                  slow_value=None if rng2.random() < 0.2 else rng2.uniform(0, 5))
        records.append(r.record())
    assert records[0] == records[1]


def test_monitor_keeps_rollup_datagrams_out_of_its_stats():
    """A host digest's `{"rollup": ...}` chunks, sent to the master's
    monitor, add no Stats column in the port, as in the reference's
    monitor without a fleet; a good measure after them still lands, in
    both alike. (The fleet route itself is not ported: nothing calls it.)"""
    from handel_tpu_torch.obs.rollup import HostRollup

    hr = HostRollup("proc0", top_k=4)
    hr.attach_fold("swarm", lambda: [({"msgSentCt": 3.0, "bestCardinality": 7.0},
                                       frozenset({"bestCardinality"}))])
    hr.tick(now=1.0)
    chunks = []
    assert hr.emit(chunks.append) > 0
    assert chunks and all("rollup" in c for c in chunks)
    seen = []
    for mon_mod in (pmonitor, rmonitor):
        mon = mon_mod.Monitor(0)
        proto = mon_mod._SinkProto(mon)
        for c in chunks:
            proto.datagram_received(json.dumps(c).encode(), ("127.0.0.1", 1))
        proto.datagram_received(json.dumps({"rollup": "junk"}).encode(), ("127.0.0.1", 1))
        before = mon.stats.columns()
        proto.datagram_received(json.dumps({"name": "sigen", "values": {"wall": 1.5}}).encode(),
                                ("127.0.0.1", 1))
        seen.append((before, mon.stats.columns(), mon.stats.row()))
    assert seen[0] == seen[1]
    assert seen[0][0] == [] and seen[0][1]


# -- vnode wiring ----------------------------------------------------------


@SIDES
def test_build_vnode_swarm_wiring(side):
    """The knobs the memory budget depends on: windowed store, shared rand,
    no shuffling, no scorer, member-id session over a committee-wide dedup
    scope, the level timeout on the shared wheel."""
    async def go():
        registry, secrets = side.driver.fake_committee(16)
        cons = side.fake.FakeConstructor()
        router = side.router.SwarmRouter(block=16)
        wheel = side.timeout.TimerWheel(tick_s=0.01)
        service = side.batch_verifier.BatchVerifierService(
            side.service.HostDevice(cons, batch_size=4))
        shared = random.Random(0)
        v = side.vnode.build_vnode(
            registry.identity(3), secrets[3], registry, cons, b"m",
            router, wheel, service,
            threshold=9, update_period=0.05, level_timeout=0.05,
            shared_rand=shared, fast_path=2,
        )
        h = v.handel
        try:
            assert h.c.session == "3"
            assert h.c.disable_shuffling is True
            assert (h.c.fast_path, h.c.contributions, h.c.batch_size, h.c.max_pending) \
                == (2, 9, 64, 256)
            assert h.c.rand is shared
            assert isinstance(h.store, side.store.WindowedSignatureStore)
            assert isinstance(h.timeout, side.timeout.WheelTimeout) and h.timeout.wheel is wheel
            assert h.scorer is None
            assert router.local.get(3) is h  # listener registered under our id
            assert (v.id, v.reached_threshold, v.time_to_threshold()) == (3, False, 0.0)
        finally:
            service.stop()

    run(go())


def test_swarm_dedup_scope_shared():
    assert pvnode.SWARM_DEDUP_SCOPE == rvnode.SWARM_DEDUP_SCOPE == "swarm"


# -- end-to-end single-process host ----------------------------------------


def host_run(side, n, **kw):
    async def go():
        host = side.driver.SwarmHost(n, 0, n, update_period=0.5, **kw)
        return host, await host.run(timeout=60.0)

    return run(go())


@SIDES
def test_swarm_host_small_committee_completes(side):
    _, s = host_run(side, 64)
    assert s["completed"] == s["identities"] == 64
    assert s["ttt_max_s"] > 0.0
    assert s["retired_level_ct"] > 0
    assert s["swarmLocalDelivered"] > 0
    assert s["swarmUdpSent"] == 0.0  # single process: all local


def test_swarm_host_summaries_match_the_reference():
    """64 identities in each package with threshold = committee: every
    vnode needs every level, so both retire all 6 levels of all 64 vnodes,
    with the same summary keys."""
    (ph, ours), (rh, theirs) = host_run(PORT, 64, threshold=64), host_run(REF, 64, threshold=64)
    assert sorted(ours) == sorted(theirs)
    assert ours["completed"] == theirs["completed"] == 64
    assert ours["threshold"] == theirs["threshold"] == 64
    assert ours["retired_level_ct"] == theirs["retired_level_ct"] == 64 * 6
    assert ours["vnode_bytes_sample_n"] == theirs["vnode_bytes_sample_n"] == 16
    assert ours["verifier_launches"] > 0 and ours["wheelFiredCt"] > 0
    assert ph.host_rollup.digest().keys() == rh.host_rollup.digest().keys()


@SIDES
def test_swarm_host_traced_run_streams_report(side, tmp_path):
    from handel_tpu_torch.sim.trace_cli import stream_report

    host, s = host_run(side, 32, trace=True, trace_capacity=1 << 15)
    assert s["completed"] == 32
    path = host.recorder.dump(str(tmp_path / "swarm_trace_0.json"))
    rep = stream_report([path], top_k=3)
    assert rep["events"] > 0
    assert rep["time_to_threshold_s"] >= 0.0
    assert rep["level_wave"]  # the per-level completion wave
    assert rep["chains"]["count"] > 0


def test_traced_swarm_reports_have_the_references_shape(tmp_path):
    from handel_tpu.sim.trace_cli import stream_report as rstream
    from handel_tpu_torch.sim.trace_cli import stream_report as pstream

    reps = []
    for name, side in (("port", PORT), ("ref", REF)):
        host, _ = host_run(side, 32, trace=True, trace_capacity=1 << 15)
        path = host.recorder.dump(str(tmp_path / f"{name}_swarm_trace_0.json"))
        # each package's report over each package's dump
        reps.append((pstream([path], top_k=3), rstream([path], top_k=3)))
    for ours, theirs in reps:
        assert sorted(ours) == sorted(theirs)
        assert ours["level_wave"] == theirs["level_wave"]
        assert ours["critical_path_len"] == theirs["critical_path_len"]
    assert sorted(reps[0][0]["level_wave"]) == sorted(reps[1][0]["level_wave"])


@SIDES
def test_swarm_host_rollup_shape(side):
    host, _ = host_run(side, 32)
    r = host.rollup(top_k=4)
    assert r["vnodes"] == 32
    assert r["unfinished"] == 0
    assert len(r["slowest"]) == 4
    slow = [e["slow_s"] for e in r["slowest"]]
    assert slow == sorted(slow, reverse=True)
    assert "counters" in r and "gauges" in r


def test_swarm_host_rollups_have_the_same_keys():
    (ph, _), (rh, _) = host_run(PORT, 32), host_run(REF, 32)
    ours, theirs = ph.rollup(top_k=4), rh.rollup(top_k=4)
    assert sorted(ours) == sorted(theirs)
    assert sorted(ours["counters"]) == sorted(theirs["counters"])
    assert sorted(ours["gauges"]) == sorted(theirs["gauges"])


# -- barrier release count (sim/sync.py) -----------------------------------


def test_sync_master_small_fleet_needs_everyone():
    """expected=2 must NOT release after one READY: the ceiling keeps a
    block from gossiping before its sibling binds."""
    from handel_tpu_torch.sim.sync import STATE_START, SyncMaster

    sent = []
    master = SyncMaster(0, expected=2)
    master._transport = SimpleNamespace(sendto=lambda d, a: sent.append(a))
    master._on_ready(STATE_START, 0, ("127.0.0.1", 1))
    assert not master._event(STATE_START).is_set()
    master._on_ready(STATE_START, 1, ("127.0.0.1", 2))
    assert master._event(STATE_START).is_set()


# -- run_swarm and the subcommand ------------------------------------------


def swarm_cfg(mod, identities, processes, trace):
    return mod.SimConfig(
        trace=trace, trace_capacity=1 << 16, max_timeout_s=120.0,
        swarm=mod.SwarmParams(identities=identities, processes=processes, period_ms=10000.0,
                              timeout_ms=50.0, fast_path=3, timeout_s=120.0),
    )


def test_run_swarm_two_processes_beside_the_reference(tmp_path, monkeypatch):
    """256 identities over 2 worker processes in each package, traced: every
    vnode completes, blocks cross the shared sockets, the merged summaries,
    their per-process parts and trace reports carry the same keys, and
    the workdirs hold the same files."""
    monkeypatch.chdir(ROOT)  # the workers run `python -m <package>.swarm.worker`
    out = {}
    for name, side in (("port", PORT), ("ref", REF)):
        work = tmp_path / name
        out[name] = (run(side.driver.run_swarm(swarm_cfg(side.config, 256, 2, True), str(work))),
                     sorted(os.listdir(work)))
    (ours, files_o), (theirs, files_t) = out["port"], out["ref"]
    for s in (ours, theirs):
        assert s["ok"] and s["completed"] == s["swarm_identities"] == 256
        assert s["processes"] == 2 and s["udp_sent"] > 0
        assert s["retired_level_ct"] > 0 and s["fleet_hosts"] == 2
        assert s["trace_report"]["level_wave"]
    assert sorted(ours) == sorted(theirs)
    assert [sorted(p) for p in ours["per_process"]] == [sorted(p) for p in theirs["per_process"]]
    assert sorted(ours["trace_report"]) == sorted(theirs["trace_report"])
    assert files_o == files_t
    assert json.loads((tmp_path / "port" / "swarm_summary.json").read_text())["ok"]


def test_swarm_subcommand_beside_the_reference(tmp_path):
    """`python -m <package>.sim swarm <toml> --workdir W` in each package on
    a 128-identity committee: exit 0, the summary line last on stdout, the
    same keys."""
    toml = tmp_path / "swarm.toml"
    toml.write_text(pconfig.dump_config(swarm_cfg(pconfig, 128, 1, False)))
    lines = []
    for pkg in ("handel_tpu_torch", "handel_tpu"):
        out = subprocess.run(
            [sys.executable, "-m", f"{pkg}.sim", "swarm", str(toml),
             "--workdir", str(tmp_path / pkg)],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert out.returncode == 0, out.stderr[-3000:]
        lines.append(json.loads(out.stdout.strip().splitlines()[-1]))
    ours, theirs = lines
    assert ours["ok"] and ours["completed"] == 128
    assert sorted(ours) == sorted(theirs)


def test_swarm_subcommand_refuses_a_config_without_a_swarm(tmp_path):
    cfg = pconfig.SimConfig(runs=[pconfig.RunConfig()])
    with pytest.raises(ValueError, match=r"no \[swarm\] section"):
        run(pdriver.run_swarm(cfg, str(tmp_path)))
