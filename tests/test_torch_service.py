"""The port's shared batch verifier against the JAX package's: the circuit
breaker, the deficit-round-robin tenant queue, the device plane and the
`BatchVerifierService` on host stub devices, with the same seeded inputs
handed to both packages.

Twins of the plane cases of tests/test_plane.py, of the service cases of
tests/test_dedup.py and of the queue and service cases of
tests/test_service.py: each runs its scenario through both packages and
holds the port's outcome to the reference's and to what the reference's
test asserts. Tolerance: exact equality for states, counters, queue
orders and verdicts; the only timed values (`hostPackMs` and the like)
are left out of every comparison.
"""

from __future__ import annotations

import asyncio
import random
import threading
import time
from types import SimpleNamespace

import pytest

from handel_tpu.core.bitset import BitSet as JBitSet
from handel_tpu.core.store import VerifiedAggCache as JVerifiedAggCache
from handel_tpu.core.test_harness import FakeScheme as JFakeScheme
from handel_tpu.models import fake as jfake
from handel_tpu.parallel.batch_verifier import BatchVerifierService as JService
from handel_tpu.parallel.plane import DeviceLane as JDeviceLane
from handel_tpu.parallel.plane import DevicePlane as JDevicePlane
from handel_tpu.parallel.plane import host_plane as jhost_plane
from handel_tpu.service.driver import HostDevice as JHostDevice
from handel_tpu.service.fairness import SloTier as JSloTier
from handel_tpu.service.fairness import TenantQueue as JTenantQueue
from handel_tpu.utils.breaker import CircuitBreaker as JCircuitBreaker
from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.store import VerifiedAggCache
from handel_tpu_torch.models import fake
from handel_tpu_torch.models.fake import FakeScheme
from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
from handel_tpu_torch.parallel.plane import DeviceLane, DevicePlane, host_plane
from handel_tpu_torch.service import SloTier, TenantQueue
from handel_tpu_torch.service.driver import HostDevice
from handel_tpu_torch.utils.breaker import CircuitBreaker

PORT = SimpleNamespace(
    BitSet=BitSet, Cache=VerifiedAggCache, FakeScheme=FakeScheme, fake=fake,
    Service=BatchVerifierService, DeviceLane=DeviceLane, DevicePlane=DevicePlane,
    host_plane=host_plane, HostDevice=HostDevice, SloTier=SloTier,
    TenantQueue=TenantQueue, CircuitBreaker=CircuitBreaker,
)
REF = SimpleNamespace(
    BitSet=JBitSet, Cache=JVerifiedAggCache, FakeScheme=JFakeScheme, fake=jfake,
    Service=JService, DeviceLane=JDeviceLane, DevicePlane=JDevicePlane,
    host_plane=jhost_plane, HostDevice=JHostDevice, SloTier=JSloTier,
    TenantQueue=JTenantQueue, CircuitBreaker=JCircuitBreaker,
)

# values() keys that read a clock; every other key is compared exactly
TIMED = {"hostPackMs", "hostPackMsPerLaunch", "hostDispatchMs",
         "hostDispatchMsPerLaunch", "lastQuiesceStallMs"}


def run(coro):
    return asyncio.run(coro)


def both(scenario):
    """The scenario's outcome in the port and in the reference, checked
    equal; returns the port's."""
    ours, theirs = scenario(PORT), scenario(REF)
    assert ours == theirs
    return ours


def untimed(values: dict) -> dict:
    return {k: v for k, v in values.items() if k not in TIMED}


class _Sig:
    """Marshal-able stand-in signature with identity-distinct bytes."""

    def __init__(self, tag: int = 0):
        self.tag = tag

    def marshal(self) -> bytes:
        return self.tag.to_bytes(4, "big")


def _req(pkg, tag: int, n: int = 16):
    bs = pkg.BitSet(n)
    bs.set(tag % n, True)
    return (bs, _Sig(tag))


class StubDevice:
    """Single-message device (no dispatch_multi): per-msg launch groups."""

    batch_size = 16

    def __init__(self, gate: threading.Event | None = None):
        self.dispatched = 0
        self.lanes: list[int] = []
        self.gate = gate

    def dispatch(self, msg, reqs):
        if self.gate is not None:
            self.gate.wait(5.0)
        self.dispatched += 1
        self.lanes.append(len(reqs))
        return len(reqs)

    def fetch(self, handle):
        return [True] * handle


class MultiStubDevice:
    """dispatch_multi-capable stub: whole mixed batches as one launch."""

    def __init__(self, batch_size: int = 16, launch_s: float = 0.0):
        self.batch_size = batch_size
        self.launch_s = launch_s
        self.dispatched = 0
        self.lanes: list[int] = []

    def dispatch_multi(self, items):
        if self.launch_s:
            time.sleep(self.launch_s)
        self.dispatched += 1
        self.lanes.append(len(items))
        return [True] * len(items)

    def fetch(self, handle):
        return handle


# -- CircuitBreaker -----------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_breaker_script_matches_reference(seed):
    """A seeded script of failures, successes, probes and clock steps on an
    injected clock: state, transitions, open count and every allow() the
    same, step by step."""

    def scenario(pkg):
        rng = random.Random(seed)
        now = [0.0]
        edges = []
        br = pkg.CircuitBreaker(
            threshold=1 + seed % 3, cooldown_s=0.5 + seed,
            clock=lambda: now[0], on_transition=lambda a, b: edges.append((a, b)),
        )
        trace = []
        for _ in range(200):
            op = rng.choice(["fail", "fail", "ok", "tick", "allow", "state"])
            out = None
            if op == "fail":
                br.record_failure()
            elif op == "ok":
                br.record_success()
            elif op == "tick":
                now[0] += rng.uniform(0.0, 2.0 + seed)
            elif op == "allow":
                out = br.allow()
            else:
                out = br.state
            trace.append((op, out, br.failures, br.open_count, br.transitions))
        return trace, edges, br.state

    trace, edges, _ = both(scenario)
    assert ("closed", "open") in edges
    assert any(op == "allow" and out is False for op, out, *_ in trace)


def test_breaker_rejects_zero_threshold():
    for pkg in (PORT, REF):
        with pytest.raises(ValueError, match="threshold"):
            pkg.CircuitBreaker(threshold=0)


# -- TenantQueue: deficit round robin ----------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_tenant_queue_script_matches_reference(seed):
    """A seeded push/take/drop script over tiered tenants, with a per-tenant
    bound and a global shedding capacity: the same take orders, depths,
    refusals, sheds and shed rate."""

    def scenario(pkg):
        rng = random.Random(seed)
        q = pkg.TenantQueue(quantum=1 + seed % 4, max_pending=5 + seed,
                            capacity=0 if seed % 2 else 24)
        tenants = [f"t{i}" for i in range(5)]
        for t, tier in zip(tenants, ["gold", "silver", "bronze", "standard"]):
            q.set_tier(t, tier)
        q.set_tier("t4", pkg.SloTier("custom", weight=3, shed_at=0.5))
        trace, item = [], 0
        for _ in range(300):
            op = rng.random()
            if op < 0.75:
                t = rng.choice(tenants)
                trace.append(("push", t, q.push(t, item)))
                item += 1
            elif op < 0.93:
                trace.append(("take", q.take(rng.randrange(0, 6))))
            elif op < 0.97:
                trace.append(("drop", q.drop_tenant(rng.choice(tenants))))
            else:
                trace.append(("tier", q.tier_of(rng.choice(tenants)).name))
            trace.append((q.depths(), len(q), q.tenants()))
        return trace, q.pushed, q.refused, q.shed, q.taken, q.shed_rate(), list(q.drain())

    trace, pushed, refused, shed, taken, _, _ = both(scenario)
    assert pushed and taken and refused
    assert shed if seed % 2 == 0 else shed == 0


def test_drr_single_tenant_fifo():
    def scenario(pkg):
        q = pkg.TenantQueue(quantum=4)
        pushed = [q.push("a", i) for i in range(10)]
        return pushed, q.take(6), q.take(10), len(q)

    pushed, first, second, left = both(scenario)
    assert all(pushed)
    assert first == [0, 1, 2, 3, 4, 5]
    assert second == [6, 7, 8, 9]
    assert left == 0


def test_drr_fair_share_across_tenants():
    def scenario(pkg):
        q = pkg.TenantQueue(quantum=2)
        for i in range(6):
            q.push("a", f"a{i}")
            q.push("b", f"b{i}")
        return q.take(8)

    assert both(scenario) == ["a0", "a1", "b0", "b1", "a2", "a3", "b2", "b3"]


def test_drr_hot_tenant_cannot_starve_cold():
    def scenario(pkg):
        q = pkg.TenantQueue(quantum=8)
        for i in range(2000):
            q.push("hot", ("hot", i))
        for c in range(15):
            for i in range(8):
                q.push(f"cold{c}", (f"cold{c}", i))
        served = q.take(64) + q.take(64)
        return served, q.depth("hot")

    served, hot_left = both(scenario)
    cold = [it for it in served if it[0] != "hot"]
    hot = [it for it in served if it[0] == "hot"]
    assert len(cold) == 15 * 8, "a cold tenant was starved"
    assert 0 < len(hot) <= 2 * 8
    assert hot_left == 2000 - len(hot)


def test_drr_deficit_continues_across_takes():
    def scenario(pkg):
        q = pkg.TenantQueue(quantum=4)
        for i in range(8):
            q.push("a", f"a{i}")
            q.push("b", f"b{i}")
        return q.take(2), q.take(4)

    assert both(scenario) == (["a0", "a1"], ["a2", "a3", "b0", "b1"])


def test_tenant_bound_refuses_push():
    def scenario(pkg):
        q = pkg.TenantQueue(quantum=4, max_pending=3)
        return [q.push("a", i) for i in range(3)], q.push("a", 99), q.refused, q.push("b", 0)

    assert both(scenario) == ([True] * 3, False, 1, True)


def test_drop_tenant_returns_items():
    def scenario(pkg):
        q = pkg.TenantQueue()
        q.push("a", 1)
        q.push("b", 2)
        return q.drop_tenant("a"), q.depths(), q.take(4)

    assert both(scenario) == ([1], {"b": 1}, [2])


def test_tenant_queue_rejects_bad_knobs():
    for pkg in (PORT, REF):
        for kw in ({"quantum": 0}, {"max_pending": 0}, {"capacity": -1}):
            with pytest.raises(ValueError):
                pkg.TenantQueue(**kw)


# -- DevicePlane (twins of tests/test_plane.py) --------------------------------


class _Engine:
    batch_size = 4

    def __init__(self):
        self.dispatched = 0

    def dispatch_multi(self, items):
        self.dispatched += 1
        return [True] * len(items)

    def fetch(self, handle):
        return handle


def _plane(pkg, k, breakers=None):
    return pkg.DevicePlane([_Engine() for _ in range(k)], breakers=breakers)


def _pks(pkg):
    return [pkg.fake.FakePublic(True) for _ in range(16)]


def _fake_req(pkg, tag: int, n: int = 16):
    bs = pkg.BitSet(n)
    bs.set(tag % n, True)
    return (bs, pkg.fake.FakeSignature(True))


def test_pick_prefers_idle_lane():
    def scenario(pkg):
        plane = _plane(pkg, 3)
        plane.lanes[0].dispatching = ["x"]
        plane.lanes[1].fetching = ["y"]
        return plane.pick().index, plane.idle_violations

    assert both(scenario) == (2, 0)


def test_pick_least_loaded_then_lowest_index():
    def scenario(pkg):
        plane = _plane(pkg, 3)
        for lane, tag in zip(plane.lanes, "abc"):
            lane.fetching = [tag]
        return plane.pick().index

    assert both(scenario) == 0


def test_pick_skips_breaker_open_lane():
    def scenario(pkg):
        breakers = [pkg.CircuitBreaker(cooldown_s=600.0) for _ in range(2)]
        plane = _plane(pkg, 2, breakers=breakers)
        for _ in range(breakers[0].threshold):
            breakers[0].record_failure()
        return plane.pick().index, plane.values()["devicesAvailable"], len(plane.allowed())

    assert both(scenario) == (1, 1.0, 1)


def test_pick_none_when_all_occupied():
    def scenario(pkg):
        plane = _plane(pkg, 2)
        for lane in plane.lanes:
            lane.dispatching = ["x"]
        return plane.pick()

    assert both(scenario) is None


def test_host_cost_sums_over_engines():
    def scenario(pkg):
        plane = _plane(pkg, 2)
        for i, lane in enumerate(plane.lanes):
            lane.engine.host_pack_ms = 2.0 + i
            lane.engine.host_pack_launches = 1 + i
            lane.engine.host_dispatch_ms = 10.0
            lane.engine.host_dispatch_launches = 2
        return plane.host_cost()

    assert both(scenario) == {"pack_ms": 5.0, "pack_launches": 3.0,
                              "dispatch_ms": 20.0, "dispatch_launches": 4.0}


def test_labeled_values_one_row_per_device():
    def scenario(pkg):
        plane = _plane(pkg, 3)
        plane.lanes[1].launches = 4
        plane.lanes[1].fill_sum = 3.0
        return plane.labeled_values(), plane.labeled_gauge_keys()

    rows, gauges = both(scenario)
    assert set(rows) == {"0", "1", "2"}
    assert rows["1"]["launches"] == 4.0
    assert rows["1"]["fillRatio"] == 0.75
    assert gauges <= set(rows["0"])


def test_plane_requires_engines_and_matched_breakers():
    for pkg in (PORT, REF):
        with pytest.raises(ValueError, match="at least one"):
            pkg.DevicePlane([])
        with pytest.raises(ValueError, match="1:1"):
            pkg.DevicePlane([_Engine()], breakers=[])


def test_lane_values_shape():
    def scenario(pkg):
        return pkg.DeviceLane(0, _Engine()).values()

    vals = both(scenario)
    assert vals["breakerState"] == 0.0
    assert vals["load"] == 0.0


def test_service_fleet_uses_every_lane():
    """A flood of distinct aggregates over a 4-lane plane reaches every lane
    and keeps the scheduler audit clean."""

    def scenario(pkg):
        plane = _plane(pkg, 4)
        pks = _pks(pkg)

        async def go():
            svc = pkg.Service(plane, max_delay_ms=0.1)
            try:
                out = await asyncio.gather(*(
                    svc.verify(i.to_bytes(2, "big"), pks, [_fake_req(pkg, i)], session="s")
                    for i in range(64)
                ))
                return out, svc.values()
            finally:
                svc.stop()

        out, vals = run(go())
        return (out, [lane.engine.dispatched >= 1 for lane in plane.lanes],
                vals["devicesTotal"], vals["schedIdleViolations"],
                sum(lane.launches for lane in plane.lanes) == vals["verifierLaunches"])

    out, used, total, violations, summed = both(scenario)
    assert all(v == [True] for v in out)
    assert all(used) and total == 4.0 and violations == 0.0 and summed


def test_service_fleet_degrades_to_healthy_lanes():
    def scenario(pkg):
        breakers = [pkg.CircuitBreaker(cooldown_s=600.0) for _ in range(3)]
        plane = _plane(pkg, 3, breakers=breakers)
        for _ in range(breakers[1].threshold):
            breakers[1].record_failure()
        pks = _pks(pkg)

        async def go():
            svc = pkg.Service(plane, max_delay_ms=0.1)
            try:
                out = await asyncio.gather(*(
                    svc.verify(i.to_bytes(2, "big"), pks, [_fake_req(pkg, i)], session="s")
                    for i in range(24)
                ))
                return out, svc.values()
            finally:
                svc.stop()

        out, vals = run(go())
        return (out, [lane.engine.dispatched >= 1 for lane in plane.lanes],
                plane.lanes[1].engine.dispatched, vals["devicesAvailable"],
                vals["failoverBatches"])

    out, used, tripped, available, failovers = both(scenario)
    assert all(v == [True] for v in out)
    assert used == [True, False, True] and tripped == 0
    assert available == 2.0 and failovers == 0.0


def test_single_device_wrap_keeps_identities():
    for pkg in (PORT, REF):
        eng, br = _Engine(), pkg.CircuitBreaker()
        svc = pkg.Service(eng, breaker=br)
        assert len(svc.plane) == 1
        assert svc.device is eng and svc.breaker is br
        assert svc.plane.lanes[0].breaker is br


def test_host_plane_builds_k_host_devices():
    def scenario(pkg):
        plane = pkg.host_plane(pkg.FakeScheme().constructor, 3, batch_size=8)
        return len(plane), plane.batch_size, [type(l.engine).__name__ for l in plane.lanes]

    assert both(scenario) == (3, 8, ["HostDevice"] * 3)


# -- service dedup (twins of tests/test_dedup.py's service cases) -------------


class GatedStub:
    batch_size = 8

    def __init__(self, gate=None):
        self.gate = gate
        self.dispatched = 0

    def dispatch(self, msg, reqs):
        if self.gate is not None:
            self.gate.wait(5.0)
        self.dispatched += len(reqs)
        return len(reqs)

    def fetch(self, handle):
        return [True] * handle


def _dreq(pkg, i=0, width=4):
    bs = pkg.BitSet(width)
    bs.set(i % width, True)
    return (bs, pkg.fake.FakeSignature(True))


def test_service_dedups_across_nodes():
    def scenario(pkg):
        async def go():
            svc = pkg.Service(GatedStub(), max_delay_ms=0.5)
            a = await svc.verify(b"m", [], [_dreq(pkg, 0)])
            b = await svc.verify(b"m", [], [_dreq(pkg, 0)])
            vals = svc.values()
            svc.stop()
            return a, b, svc.device.dispatched, vals["dedupHits"], vals["dedupHitRate"]

        return run(go())

    assert both(scenario) == ([True], [True], 1, 1.0, 0.5)


def test_service_coalesces_concurrent_duplicates():
    def scenario(pkg):
        async def go():
            svc = pkg.Service(GatedStub(), max_delay_ms=0.5)
            r = await asyncio.gather(*(svc.verify(b"m", [], [_dreq(pkg, 1)]) for _ in range(3)))
            svc.stop()
            return r, svc.device.dispatched, svc.cache.hits

        return run(go())

    assert both(scenario) == ([[True]] * 3, 1, 2)


def test_service_distinct_messages_not_deduped():
    def scenario(pkg):
        async def go():
            svc = pkg.Service(GatedStub(), max_delay_ms=0.5)
            await svc.verify(b"m1", [], [_dreq(pkg, 0)])
            await svc.verify(b"m2", [], [_dreq(pkg, 0)])
            svc.stop()
            return svc.device.dispatched

        return run(go())

    assert both(scenario) == 2


def test_stop_mid_dispatch_fails_waiters_not_hangs():
    """stop() while the collector's batch sits in the dispatch executor
    fails that batch's futures instead of stranding the callers."""

    def scenario(pkg):
        async def go():
            gate = threading.Event()
            svc = pkg.Service(GatedStub(gate=gate), max_delay_ms=0.5)
            task = asyncio.ensure_future(svc.verify(b"m", [], [_dreq(pkg, 0)]))
            for _ in range(200):
                await asyncio.sleep(0.005)
                if svc._collecting is not None:
                    break
            took = svc._collecting is not None
            svc.stop()
            gate.set()
            with pytest.raises(RuntimeError, match="stopped"):
                await asyncio.wait_for(task, timeout=2.0)
            return took

        return run(go())

    assert both(scenario) is True


def test_stop_with_pending_queue_still_fails_everyone():
    def scenario(pkg):
        async def go():
            gate = threading.Event()
            svc = pkg.Service(GatedStub(gate=gate), max_delay_ms=0.5)
            tasks = [
                asyncio.ensure_future(svc.verify(b"m", [], [_dreq(pkg, 0)])),
                asyncio.ensure_future(svc.verify(b"m", [], [_dreq(pkg, 0)])),  # coalesced
                asyncio.ensure_future(svc.verify(b"m", [], [_dreq(pkg, 1)])),
            ]
            await asyncio.sleep(0.05)
            svc.stop()
            gate.set()
            failed = 0
            for t in tasks:
                with pytest.raises(RuntimeError, match="stopped"):
                    await asyncio.wait_for(t, timeout=2.0)
                failed += 1
            return failed

        return run(go())

    assert both(scenario) == 3


# -- service sessions, fill and admission (twins of tests/test_service.py) ----


def test_per_tenant_dedup_isolation():
    def scenario(pkg):
        async def go():
            svc = pkg.Service(StubDevice(), max_delay_ms=0.1)
            await svc.verify(b"m", [], [_req(pkg, 1)], session="A")
            await svc.verify(b"m", [], [_req(pkg, 1)], session="B")  # not cross-dedup
            await svc.verify(b"m", [], [_req(pkg, 1)], session="A")  # intra-session hit
            svc.stop()
            return svc.device.dispatched, svc.cache.hits, svc.tenant_dedup_hits

        return run(go())

    assert both(scenario) == (2, 1, {"A": 1})


def test_forget_session_drops_state_and_fails_queued():
    def scenario(pkg):
        async def go():
            gate = threading.Event()
            gate.set()
            svc = pkg.Service(StubDevice(gate=gate), max_delay_ms=0.1)
            await svc.verify(b"m", [], [_req(pkg, 1)], session="A")  # cached verdict
            gate.clear()
            blocker = asyncio.ensure_future(svc.verify(b"mC", [], [_req(pkg, 9)], session="C"))
            await asyncio.sleep(0.05)
            t_a = asyncio.ensure_future(svc.verify(b"m", [], [_req(pkg, 2)], session="A"))
            t_b = asyncio.ensure_future(svc.verify(b"m", [], [_req(pkg, 3)], session="B"))
            await asyncio.sleep(0.02)
            had_a = any(k[0] == "A" for k in svc.cache._map)
            dropped = svc.forget_session("A")
            cache_clean = not any(k[0] == "A" for k in svc.cache._map)
            gate.set()
            with pytest.raises(RuntimeError, match="evicted"):
                await asyncio.wait_for(t_a, 2.0)
            b = await asyncio.wait_for(t_b, 2.0)
            c = await asyncio.wait_for(blocker, 2.0)
            svc.stop()
            return had_a, dropped, cache_clean, b, c, "A" in svc.tenant_candidates

        return run(go())

    assert both(scenario) == (True, 1, True, [True], [True], False)


def test_launch_fill_ratio_coalesced():
    """4 sessions' 4 candidates each fill one 16-lane launch end to end."""

    def scenario(pkg):
        async def go():
            svc = pkg.Service(MultiStubDevice(16), max_delay_ms=5.0)
            results = await asyncio.gather(*(
                svc.verify(f"m{s}".encode(), [], [_req(pkg, s * 10 + i) for i in range(4)],
                           session=f"s{s}")
                for s in range(4)
            ))
            svc.stop()
            vals = svc.values()
            return (results, svc.device.dispatched, svc.fill_launches,
                    vals["launchFillRatio"], vals["lastLaunchFill"], svc.coalesced_launches)

        return run(go())

    results, dispatched, fills, ratio, last, coalesced = both(scenario)
    assert all(r == [True] * 4 for r in results)
    assert (dispatched, fills, ratio, last, coalesced) == (1, 1, 1.0, 1.0, 1)


def test_single_msg_device_groups_by_msg():
    def scenario(pkg):
        async def go():
            svc = pkg.Service(StubDevice(), max_delay_ms=5.0)
            await asyncio.gather(
                svc.verify(b"m1", [], [_req(pkg, 1)], session="A"),
                svc.verify(b"m2", [], [_req(pkg, 2)], session="B"),
            )
            svc.stop()
            return (svc.device.dispatched, svc.fill_launches, svc.coalesced_launches,
                    svc.values()["launchFillRatio"])

        return run(go())

    assert both(scenario) == (2, 2, 0, 1 / 16)


def test_admission_bound_fails_future_immediately():
    def scenario(pkg):
        async def go():
            svc = pkg.Service(MultiStubDevice(4, launch_s=0.05), max_delay_ms=0.1,
                              max_pending_per_session=2)
            with pytest.raises(RuntimeError, match="queue full"):
                await svc.verify(b"m", [], [_req(pkg, i) for i in range(8)], session="hot")
            vals = svc.values()
            svc.stop()
            return vals["admissionRefused"] >= 1

        return run(go())

    assert both(scenario) is True


def test_service_hot_session_no_starvation():
    """500 hot candidates + 15 cold sessions x 4: every cold session
    resolves while most of the hot backlog is still queued."""

    def scenario(pkg):
        async def go():
            svc = pkg.Service(MultiStubDevice(64, launch_s=0.002), max_delay_ms=0.5, quantum=8)
            hot = [asyncio.ensure_future(
                svc.verify(b"hot", [], [_req(pkg, i, 1024)], session="hot"))
                for i in range(500)]
            await asyncio.sleep(0)
            cold = [asyncio.ensure_future(svc.verify(
                f"c{c}".encode(), [], [_req(pkg, c * 100 + i, 1024) for i in range(4)],
                session=f"cold{c}")) for c in range(15)]
            await asyncio.wait_for(asyncio.gather(*cold), 10.0)
            hot_unresolved = sum(1 for f in hot if not f.done())
            await asyncio.wait_for(asyncio.gather(*hot), 20.0)
            svc.stop()
            return hot_unresolved > 250

        return run(go())

    assert both(scenario) is True


def test_cache_drop_scope_plain_and_tuple():
    def scenario(pkg):
        c = pkg.Cache()
        keys = [("A", b"m", b"w", b"s"), ("B", b"m", b"w", b"s"),
                (("A", 3), b"w", b"s"), (3, b"w", b"s")]
        for k in keys:
            c.put(k, True)
        return c.drop_scope("A"), [k in c._map for k in keys], c.gauge_keys()

    dropped, kept, _ = both(scenario)
    assert dropped == 2 and kept == [False, True, False, True]


def test_host_device_verdicts_honest():
    """HostDevice verifies, it does not rubber-stamp: an invalid fake
    signature in one lane fails only that lane."""

    def scenario(pkg):
        dev = pkg.HostDevice(pkg.FakeScheme().constructor, batch_size=8)
        pks = [pkg.fake.FakePublic(True) for _ in range(4)]
        good, bad = pkg.BitSet(4), pkg.BitSet(4)
        good.set(0, True)
        bad.set(1, True)
        return dev.fetch(dev.dispatch_multi([
            (b"m1", pks, good, pkg.fake.FakeSignature(True)),
            (b"m2", pks, bad, pkg.fake.FakeSignature(False)),
        ])), dev.dispatched

    assert both(scenario) == ([True, False], 1)


def test_host_device_epoch_flip_and_rlc_refused():
    """The epoch flip choreography, and RLC mode refused by a scheme with no
    RLC ops table (the fake scheme): the device stays per-candidate, as the
    reference's does. BN254's RLC mode: tests/test_torch_rlc.py."""
    def scenario(pkg):
        dev = pkg.HostDevice(pkg.FakeScheme().constructor)
        with pytest.raises(RuntimeError, match="no staged registry"):
            dev.activate_staged()
        flip = dev.stage_registry([1, 2, 3]), dev.activate_staged(), dev.registry_stagings
        rdev = pkg.HostDevice(pkg.FakeScheme().constructor, batch_check="rlc")
        pks = [pkg.fake.FakePublic(True) for _ in range(4)]
        bs = pkg.BitSet(4)
        bs.set(2, True)
        verdicts = rdev.fetch(rdev.dispatch_multi([
            (b"m1", pks, bs, pkg.fake.FakeSignature(True)),
            (b"m2", pks, bs, pkg.fake.FakeSignature(False)),
        ]))
        st = rdev.rlc_stats
        return (flip, rdev.batch_check, rdev._rlc_ops is None, verdicts,
                (st.rlc_launches, st.miller_lanes, st.final_exp_lanes))

    assert both(scenario) == ((3, 1, 1), "rlc", True, [True, False], (0, 4, 2))
    with pytest.raises(ValueError, match="per_candidate.*rlc"):
        HostDevice(FakeScheme().constructor, batch_check="bogus")


# -- the whole service against the reference's --------------------------------


class VerdictStub:
    """Deterministic single-message device: a lane's verdict is a function of
    its bitset words and its signature's bytes. `fail_launches` lists the
    dispatch calls (0-based) that raise."""

    def __init__(self, batch_size: int, fail_launches=()):
        self.batch_size = batch_size
        self.fail = set(fail_launches)
        self.calls = 0
        self.lanes: list[int] = []

    @staticmethod
    def verdict(bs, sig) -> bool:
        return (int(sum(bin(int(w)).count("1") for w in bs.words())) + sig.tag) % 3 != 0

    def dispatch(self, msg, reqs):
        call = self.calls
        self.calls += 1
        if call in self.fail:
            raise RuntimeError(f"injected fault at dispatch {call}")
        self.lanes.append(len(reqs))
        return [self.verdict(bs, sig) for bs, sig in reqs]

    def fetch(self, handle):
        return handle


def schedule(pkg, seed: int):
    """Seeded waves of verify calls: sessions, messages, width-64 bitsets and
    tags drawn so that waves repeat earlier content (dedup hits), carry
    in-wave duplicates (coalescing) and span several launches."""
    rng = random.Random(seed)
    seen: list[tuple] = []
    waves = []
    for _ in range(6):
        wave = []
        for _ in range(rng.randrange(3, 9)):
            session = rng.choice(["", "s1", "s2"])
            msg = rng.choice([b"m0", b"m1"])
            reqs = []
            for _ in range(rng.randrange(1, 7)):
                if seen and rng.random() < 0.3:
                    bits, tag = rng.choice(seen)
                else:
                    bits = sorted(rng.sample(range(64), rng.randrange(1, 6)))
                    tag = rng.randrange(0, 1000)
                    seen.append((bits, tag))
                bs = pkg.BitSet(64)
                for b in bits:
                    bs.set(b, True)
                reqs.append((bs, _Sig(tag)))
            wave.append((session, msg, reqs))
        waves.append(wave)
    return waves


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("faults", [(), (1, 2)])
def test_service_parity_on_a_deterministic_device(seed, faults):
    """The same request schedule through both services over the same stub
    device: the same verdicts and the same untimed values() (launches,
    candidates, dedup hits and misses, coalesced launches, fill, breaker,
    retries and failovers). With injected dispatch faults the breaker opens
    (threshold 2) and the host fallback answers with the stub's own
    verdict function."""

    def scenario(pkg):
        dev = VerdictStub(batch_size=8, fail_launches=faults)

        def fallback(msg, reqs):
            return [VerdictStub.verdict(bs, sig) for bs, sig in reqs]

        async def go():
            svc = pkg.Service(
                dev, max_delay_ms=1.0, fallback=fallback if faults else None,
                breaker=pkg.CircuitBreaker(threshold=2, cooldown_s=600.0),
                retry_limit=1, backoff_base_s=0.001, backoff_cap_s=0.002,
            )
            out = []
            try:
                for wave in schedule(pkg, seed):
                    out.append(await asyncio.gather(*(
                        svc.verify(msg, [], reqs, session=s) for s, msg, reqs in wave
                    )))
                return out, untimed(svc.values()), dev.lanes
            finally:
                svc.stop()

        return run(go())

    verdicts, values, lanes = both(scenario)
    flat = [v for wave in verdicts for call in wave for v in call]
    assert any(flat) and not all(flat)
    assert values["verifierLaunches"] == len(lanes)
    assert values["dedupHits"] > 0
    if faults:
        assert values["failoverBatches"] > 0 and values["breakerOpenCt"] == 1
    else:
        assert values["failoverBatches"] == 0 and values["deviceRetryCt"] == 0


# -- lifecycle: quiesce, lane attach and drain ----------------------------------


def test_quiesce_and_waits_for_the_plane_then_flips():
    """quiesce_and parks the collector, waits out the launch in flight, runs
    the flip (HostDevice's staged registry) and resumes: no future drops."""

    def scenario(pkg):
        async def go():
            dev = pkg.HostDevice(pkg.FakeScheme().constructor, batch_size=4, launch_ms=30.0)
            svc = pkg.Service(dev, max_delay_ms=0.1)
            pks = _pks(pkg)
            try:
                first = asyncio.ensure_future(svc.verify(b"m", pks, [_fake_req(pkg, 1)]))
                await asyncio.sleep(0.005)  # the launch is in flight
                dev.stage_registry(pks)
                queued = asyncio.ensure_future(svc.verify(b"m", pks, [_fake_req(pkg, 2)]))
                stall = await svc.quiesce_and(dev.activate_staged)
                out = [await first, await queued]
                return (out, dev.epoch, svc.quiesce_ct, stall > 0,
                        svc.queue_depth(), svc.inflight_launches())
            finally:
                svc.stop()

        return run(go())

    assert both(scenario) == ([[True], [True]], 1, 1, True, 0, 0)


def test_attach_then_drain_lane():
    """A lane attached to a running service takes launches; a drained lane
    leaves the plane clean and the rest keep serving."""

    def scenario(pkg):
        async def go():
            svc = pkg.Service(_plane(pkg, 1), max_delay_ms=0.1)
            pks = _pks(pkg)
            try:
                await svc.verify(b"m", pks, [_fake_req(pkg, 0)])
                lane = svc.attach_lane(_Engine())
                out = await asyncio.gather(*(
                    svc.verify(i.to_bytes(2, "big"), pks, [_fake_req(pkg, i)]) for i in range(16)
                ))
                used = lane.engine.dispatched >= 1
                clean = await svc.drain_lane(svc.plane.lanes[0])
                after = await svc.verify(b"after", pks, [_fake_req(pkg, 3)])
                vals = svc.values()
                return (out, used, clean, after, len(svc.plane), svc.plane.lanes[0] is lane,
                        vals["lanesAdded"], vals["lanesRemoved"])
            finally:
                svc.stop()

        return run(go())

    out, used, clean, after, lanes, kept, added, removed = both(scenario)
    assert all(v == [True] for v in out) and after == [True]
    assert used and clean and lanes == 1 and kept and (added, removed) == (1.0, 1.0)


def test_bn254_plane_needs_its_cards():
    """The BN254 plane puts one engine on each card and refuses more lanes
    than cards are visible (on this CPU host: none)."""
    import torch

    from handel_tpu_torch.parallel.plane import bn254_plane

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal needs more lanes than cards")
    with pytest.raises(ValueError, match="only 0 visible"):
        bn254_plane([], 1)


def test_service_smoke(capsys):
    """The port's counterpart of scripts/service_smoke.py at its default
    size: 8 sessions coalesce above a lone session's fill, and the
    2-process serve fleet completes."""
    import json

    from handel_tpu_torch.scripts import service_smoke

    assert service_smoke.main([]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("service smoke OK")
    got = json.loads(out[-2])
    assert got["multi_fill"] > got["baseline_fill"] and got["fleet_completed"] == 4
