"""The port's lifecycle plane (handel_tpu_torch/lifecycle/: autoscaler,
autotune, controller) against the JAX package's handel_tpu/lifecycle/.

The autoscaler, autotuner and controller cases of tests/test_lifecycle.py
run over each package's own shared verifier with the same stub engine and
manual clock, and the port must give what the reference gives: lanes
replaced, grown and shrunk, the actions a tick reports, the collector
window and in-flight moves, and the controller's merged telemetry. The
epoch cases are in tests/test_torch_epoch.py. Tolerance: exact, except
where a value rides the wall clock (the controller's tick count), which
is held to the reference's bounds instead.
"""

from __future__ import annotations

import asyncio
import time
from types import SimpleNamespace

import pytest

import handel_tpu.lifecycle as jlifecycle
import handel_tpu_torch.lifecycle as plifecycle
from handel_tpu.core.bitset import BitSet
from handel_tpu.parallel.batch_verifier import BatchVerifierService as JService
from handel_tpu.parallel.plane import DevicePlane as JPlane
from handel_tpu.service import SessionManager as JSessionManager
from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
from handel_tpu_torch.parallel.plane import DevicePlane
from handel_tpu_torch.service import SessionManager

REF = SimpleNamespace(lc=jlifecycle, Service=JService, Plane=JPlane, Manager=JSessionManager)
PORT = SimpleNamespace(lc=plifecycle, Service=BatchVerifierService, Plane=DevicePlane,
                       Manager=SessionManager)


def both(case, *args):
    got, ref = case(PORT, *args), case(REF, *args)
    assert got == ref
    return got


class _Sig:
    def __init__(self, tag: int = 0):
        self.tag = tag

    def marshal(self) -> bytes:
        return self.tag.to_bytes(4, "big")


def _req(tag: int, n: int = 16):
    bs = BitSet(n)
    bs.set(tag % n, True)
    return (bs, _Sig(tag))


class StubEngine:
    """tests/test_lifecycle.py's dispatch_multi stub."""

    def __init__(self, batch_size: int = 16, launch_s: float = 0.0):
        self.batch_size = batch_size
        self.launch_s = launch_s
        self.dispatched = 0

    def dispatch_multi(self, items):
        if self.launch_s:
            time.sleep(self.launch_s)
        self.dispatched += 1
        return [True] * len(items)

    def fetch(self, handle):
        return handle


# -- the autoscaler ---------------------------------------------------------------


def replace_broken(pkg):
    async def go():
        svc = pkg.Service(pkg.Plane([StubEngine(), StubEngine()]), max_delay_ms=0.1)
        svc.start()
        scaler = pkg.lc.LaneAutoscaler(svc, engine_factory=StubEngine, min_lanes=2,
                                       max_lanes=4)
        broken = svc.plane.lanes[0]
        while broken.breaker.state != "open":
            broken.breaker.record_failure()
        out = await scaler.tick()
        r = await svc.verify(b"m", [], [_req(1)], session="s")
        svc.stop()
        return {"replaced": scaler.lanes_replaced, "gone": broken not in svc.plane.lanes,
                "lanes": len(svc.plane), "verdict": r, "actions": out["actions"],
                "values": scaler.values()}

    return asyncio.run(go())


def test_autoscaler_replaces_breaker_open_lane_as_the_reference():
    got = both(replace_broken)
    assert got["replaced"] == 1 and got["gone"] and got["lanes"] == 2
    assert got["verdict"] == [True] and any("replaced" in a for a in got["actions"])


def grow(pkg):
    async def go():
        svc = pkg.Service(StubEngine(), max_delay_ms=0.1)
        svc.start()
        now = [0.0]
        scaler = pkg.lc.LaneAutoscaler(svc, engine_factory=StubEngine, min_lanes=1,
                                       max_lanes=3, scale_up_depth=1, cooldown_s=10.0,
                                       clock=lambda: now[0])
        fut = asyncio.get_running_loop().create_future()
        bs, sig = _req(1)
        svc.queue.push("t", ("t", b"m", [], bs, sig, fut))
        lanes, actions = [], []
        for t in (0.0, 0.0, 20.0):
            now[0] = t
            actions.append((await scaler.tick())["actions"])
            lanes.append(len(svc.plane))
        fut.cancel()
        svc.queue.drop_tenant("t")
        svc.stop()
        return lanes, actions, scaler.lanes_grown, scaler.values()

    return asyncio.run(go())


def test_autoscaler_grows_on_depth_and_respects_cooldown_as_the_reference():
    lanes, _, grown, _ = both(grow)
    assert lanes == [2, 2, 3] and grown == 2


def shrink(pkg):
    async def go():
        svc = pkg.Service(pkg.Plane([StubEngine(), StubEngine(), StubEngine()]),
                          max_delay_ms=0.1)
        svc.start()
        now = [0.0]
        scaler = pkg.lc.LaneAutoscaler(svc, engine_factory=StubEngine, min_lanes=2,
                                       max_lanes=4, scale_down_depth=8, cooldown_s=1.0,
                                       clock=lambda: now[0])
        out = []
        for t in (2.0, 4.0):
            now[0] = t
            out.append(((await scaler.tick())["actions"], len(svc.plane)))
        svc.stop()
        return out, scaler.lanes_shrunk, scaler.values()

    return asyncio.run(go())


def test_autoscaler_shrinks_idle_plane_to_floor_as_the_reference():
    out, shrunk, _ = both(shrink)
    assert [n for _, n in out] == [2, 2] and shrunk == 1


def test_autoscaler_rejects_bad_bounds():
    for pkg in (REF, PORT):
        svc = pkg.Service(StubEngine())
        for kw in ({"min_lanes": 0}, {"min_lanes": 3, "max_lanes": 2}):
            with pytest.raises(ValueError):
                pkg.lc.LaneAutoscaler(svc, engine_factory=StubEngine, **kw)


# -- the autotuner ----------------------------------------------------------------


def _report(**stages):
    return {"stages_ms": stages}


def tune(pkg, reports, **kw):
    svc = pkg.Service(StubEngine())
    tuner = pkg.lc.CriticalPathAutotuner(svc, **kw)
    actions = [tuner.observe(r) for r in reports]
    return actions, svc.max_delay, svc.max_inflight, tuner.adjustments, tuner.values()


TUNES = {
    "queue dominance shrinks the window": (
        [_report(queue=80.0, device=10.0, net=5.0)] * 2, {"patience": 2}),
    "device dominance grows it to the clamp": (
        [_report(queue=5.0, device=90.0, net=5.0)] * 20, {"patience": 1, "max_delay_s": 0.004}),
    "net dominance raises the in-flight window": (
        [_report(queue=5.0, device=5.0, net=90.0)] * 10, {"patience": 1, "max_inflight_cap": 4}),
    "a stage change resets the streak": (
        [_report(queue=90.0, device=5.0), _report(device=90.0, queue=5.0),
         _report(queue=90.0, device=5.0)], {"patience": 2}),
    "empty and unattributed reports do nothing": (
        [None, {}, _report(verify=95.0, queue=1.0, device=1.0)], {"patience": 1}),
}


@pytest.mark.parametrize("name", list(TUNES))
def test_autotuner_as_the_reference(name):
    reports, kw = TUNES[name]
    got = tune(PORT, reports, **kw)
    assert got == tune(REF, reports, **kw)
    actions, delay, inflight, adjustments, _ = got
    if name == "queue dominance shrinks the window":
        assert actions[0] == "" and "max_delay" in actions[1] and delay < 0.002
        assert adjustments == 1
    elif name == "device dominance grows it to the clamp":
        assert delay == pytest.approx(0.004)
    elif name == "net dominance raises the in-flight window":
        assert inflight == 4
    else:
        assert adjustments == 0 and delay == 0.002


# -- the controller ---------------------------------------------------------------


def controller(pkg):
    async def go():
        svc = pkg.Service(StubEngine(), max_delay_ms=0.1)
        svc.start()
        calls = [0]

        def bad_source():
            calls[0] += 1
            raise OSError("report missing")

        ctl = pkg.lc.LifecycleController(
            svc,
            autoscaler=pkg.lc.LaneAutoscaler(svc, engine_factory=StubEngine, min_lanes=1),
            autotuner=pkg.lc.CriticalPathAutotuner(svc),
            epoch_manager=pkg.lc.EpochManager(svc),
            report_source=bad_source,
            interval_s=0.01,
        )
        ctl.start()
        try:
            ctl.start()
            twice = "started twice"
        except RuntimeError as e:
            twice = str(e)
        await asyncio.sleep(0.08)
        await ctl.stop()
        ticks = ctl.ticks
        await ctl.stop()
        direct = await ctl.tick()
        svc.stop()
        return ctl, ticks, calls[0], twice, direct

    ctl, ticks, calls, twice, direct = asyncio.run(go())
    vals = ctl.values()
    return {"ticks": ticks, "calls": calls, "twice": twice, "direct": sorted(direct),
            "keys": sorted(vals), "gauges": sorted(ctl.gauge_keys()),
            "ticks counted": vals["lifecycleTicks"] == float(ticks + 1)}


def test_controller_ticks_compose_and_survive_bad_reports_as_the_reference():
    got, ref = controller(PORT), controller(REF)
    for d in (got, ref):
        assert d.pop("ticks") >= 3 and d.pop("calls") >= 3
    assert got == ref
    assert "already started" in got["twice"] and got["ticks counted"]
    assert {"lanesReplaced", "autotuneAdjustments", "epochRotations"} <= set(got["keys"])
    assert "fillSignal" in got["gauges"]


def controller_with_alerts(pkg):
    """The controller ticks an alert plane first, as the card phase wires
    it; a broken plane is logged and the loop goes on."""

    class Plane:
        def __init__(self, fail):
            self.fail, self.ticks = fail, 0

        def tick(self):
            self.ticks += 1
            if self.fail:
                raise RuntimeError("plane down")
            return [("r", "warn")]

        def values(self):
            return {"alertTicks": float(self.ticks)}

        def gauge_keys(self):
            return set()

    async def go():
        svc = pkg.Service(StubEngine())
        out = []
        for fail in (False, True):
            plane = Plane(fail)
            ctl = pkg.lc.LifecycleController(svc, alert_plane=plane, interval_s=0.01)
            out.append((await ctl.tick(), ctl.values(), plane.ticks))
        return out

    return asyncio.run(go())


def test_controller_ticks_the_alert_plane_as_the_reference():
    (ok, vals, ticks), (failed, _, _) = both(controller_with_alerts)
    assert ok["alerts"] == [("r", "warn")] and vals["alertTicks"] == 1.0 and ticks == 1
    assert "alerts" not in failed


def test_controller_rejects_a_zero_interval():
    for pkg in (REF, PORT):
        with pytest.raises(ValueError, match="interval_s must be > 0"):
            pkg.lc.LifecycleController(pkg.Service(StubEngine()), interval_s=0.0)


def tier_quantiles(pkg):
    async def go():
        svc = pkg.Service(StubEngine(32), max_delay_ms=0.2)
        mgr = pkg.Manager(service=svc, max_sessions=8)
        for _ in range(2):
            s = mgr.spawn(8, tier="gold")
            mgr.start(s.sid)
        await mgr.wait_all(20.0)
        svc.stop()
        return mgr

    mgr = asyncio.run(go())
    tq = mgr.tier_quantiles()
    return {"completed": tq["gold"]["completed"], "target": tq["gold"]["target_s"],
            "met": tq["gold"]["met"], "within": 0 < tq["gold"]["p99_s"] <= tq["gold"]["target_s"],
            "tiers": mgr.tiers}


def test_manager_tier_quantiles_as_the_reference():
    got = both(tier_quantiles)
    assert got["completed"] == 2.0 and got["met"] == 1.0 and got["within"]
    assert got["tiers"] == {}
