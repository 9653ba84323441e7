"""The port's mesh latency plane (handel_tpu_torch/parallel/mesh_plane.py,
the mesh lane in parallel/plane.py and batch_verifier.py, and the service
driver's `mesh_devices`) against the JAX package's, after
tests/test_mesh_plane.py.

Every case of that file runs on both packages (`side`) with the same
scripts, and must reach the same routing, counters and verdicts: the
policy that decides which launch groups ride the whole mesh, the
scheduler's pick against pick_mesh, fallbacks and breakers, the host mesh
engine, the mode counters, telemetry and `sim watch`'s mode column. The
port's multichip smoke (handel_tpu_torch/scripts/multichip_smoke.py) runs
here on 8 shards of the CPU.
"""

import asyncio
from types import SimpleNamespace

import pytest

from handel_tpu.core import bitset as jbitset
from handel_tpu.core import test_harness as jharness
from handel_tpu.models import fake as jfake
from handel_tpu.parallel import batch_verifier as jbv
from handel_tpu.parallel import mesh_plane as jmesh
from handel_tpu.parallel import plane as jplane
from handel_tpu.parallel import telemetry as jtelemetry
from handel_tpu.service import driver as jdriver
from handel_tpu.service import fairness as jfairness
from handel_tpu.sim import config as rconfig
from handel_tpu.sim import watch_cli as jwatch
from handel_tpu.utils import breaker as jbreaker
from handel_tpu_torch.core import bitset, test_harness
from handel_tpu_torch.models import fake
from handel_tpu_torch.parallel import batch_verifier, mesh_plane, plane, telemetry
from handel_tpu_torch.service import driver, fairness
from handel_tpu_torch.sim import config as pconfig
from handel_tpu_torch.sim import watch_cli
from handel_tpu_torch.utils import breaker

PORT = SimpleNamespace(bitset=bitset, harness=test_harness, fake=fake, bv=batch_verifier,
                       mesh=mesh_plane, plane=plane, telemetry=telemetry, driver=driver,
                       fairness=fairness, config=pconfig, watch=watch_cli, breaker=breaker)
REF = SimpleNamespace(bitset=jbitset, harness=jharness, fake=jfake, bv=jbv, mesh=jmesh,
                      plane=jplane, telemetry=jtelemetry, driver=jdriver, fairness=jfairness,
                      config=rconfig, watch=jwatch, breaker=jbreaker)
SIDES = pytest.mark.parametrize("side", [PORT, REF], ids=["port", "ref"])


class _Engine:
    batch_size = 64

    def __init__(self):
        self.dispatched = 0

    def dispatch_multi(self, items):
        self.dispatched += 1
        return [True] * len(items)

    def fetch(self, handle):
        return handle


def pks(side):
    return [side.fake.FakePublic(True) for _ in range(16)]


def _req(side, tag: int, ok: bool = True, n: int = 16):
    bs = side.bitset.BitSet(n)
    bs.set(tag % n, True)
    return (bs, side.fake.FakeSignature(ok))


def host_mesh(side, devices=4):
    return side.mesh.HostMeshDevice(
        side.harness.FakeScheme().constructor, batch_size=8, devices=devices,
        per_candidate_ms=0.0, collective_ms=0.0,
    )


# -- ModePolicy ----------------------------------------------------------------


@SIDES
def test_mode_policy_routes_by_size_backlog_and_tier(side):
    TIERS = side.fairness.TIERS
    pol = side.mesh.ModePolicy(small_batch_max=64, max_queue_depth=128)
    gold, bronze = TIERS["gold"], TIERS["bronze"]
    L, T = side.mesh.MODE_LATENCY, side.mesh.MODE_THROUGHPUT
    assert pol.pick_mode(8, 0, gold, 64) == L
    assert pol.pick_mode(65, 0, gold, 128) == T  # over the policy's cap
    assert pol.pick_mode(16, 0, gold, 8) == T  # over the mesh engine's batch
    assert pol.pick_mode(8, 129, gold, 64) == T  # deep backlog
    assert pol.pick_mode(8, 0, bronze, 64) == T
    assert pol.pick_mode(8, 0, TIERS["standard"], 64) == T


def test_mode_policy_decisions_equal_the_reference_on_a_grid():
    for cap in (1, 8, 64):
        for n in (0, 1, 8, 9, 64, 65):
            for depth in (0, 128, 129):
                for tier in ("gold", "silver", "bronze", "standard"):
                    for mesh_batch in (4, 8, 128):
                        ours = mesh_plane.ModePolicy(small_batch_max=cap).pick_mode(
                            n, depth, fairness.TIERS[tier], mesh_batch)
                        theirs = jmesh.ModePolicy(small_batch_max=cap).pick_mode(
                            n, depth, jfairness.TIERS[tier], mesh_batch)
                        assert ours == theirs, (cap, n, depth, tier, mesh_batch)


@SIDES
def test_mode_policy_accepts_tier_names_and_custom_tiers(side):
    pol = side.mesh.ModePolicy(latency_tiers=("gold", "silver"))
    assert pol.pick_mode(4, 0, "silver", 64) == side.mesh.MODE_LATENCY
    assert pol.pick_mode(4, 0, side.fairness.TIERS["silver"], 64) == side.mesh.MODE_LATENCY
    assert pol.pick_mode(4, 0, "bronze", 64) == side.mesh.MODE_THROUGHPUT


# -- plane scheduling ------------------------------------------------------------


@SIDES
def test_pick_never_returns_mesh_lane(side):
    p = side.plane.DevicePlane([_Engine(), _Engine()])
    mesh_lane = p.add_lane(_Engine(), mesh=True)
    for _ in range(8):
        assert p.pick() is not mesh_lane
    assert p.mesh_lanes() == [mesh_lane]
    assert p.values()["meshLanes"] == 1.0


@SIDES
def test_pick_mesh_only_returns_free_admissible_mesh_lane(side):
    p = side.plane.DevicePlane([_Engine()])
    br = side.breaker.CircuitBreaker(cooldown_s=600.0)
    mesh_lane = p.add_lane(_Engine(), breaker=br, mesh=True)
    assert p.pick_mesh() is mesh_lane
    assert p.mesh_picks == 1
    mesh_lane.dispatching = ["x"]  # busy: the caller falls back
    assert p.pick_mesh() is None
    mesh_lane.dispatching = None
    for _ in range(br.threshold):
        br.record_failure()
    assert p.pick_mesh() is None
    assert p.values()["meshLanesAvailable"] == 0.0
    assert p.values()["meshLanes"] == 1.0


@SIDES
def test_remove_lane_guards_last_throughput_lane(side):
    p = side.plane.DevicePlane([_Engine()])
    p.add_lane(_Engine(), mesh=True)
    with pytest.raises(ValueError, match="throughput"):
        p.remove_lane(p.lanes[0])
    p.remove_lane(p.lanes[1])
    assert p.mesh_lanes() == []


@SIDES
def test_mesh_only_plane_throughput_pool_falls_back(side):
    p = side.plane.DevicePlane([_Engine()])
    p.lanes[0].mesh = True
    assert p.throughput_pool() == p.lanes
    assert p.pick() is p.lanes[0]


@SIDES
def test_lane_mode_metric_row(side):
    p = side.plane.DevicePlane([_Engine()])
    mesh_lane = p.add_lane(_Engine(), mesh=True)
    assert p.lanes[0].values()["mode"] == 0.0
    assert mesh_lane.values()["mode"] == 1.0
    assert "mode" in p.labeled_gauge_keys()


@SIDES
def test_plane_batch_size_ignores_mesh_lane(side):
    class _Small(_Engine):
        batch_size = 8

    p = side.plane.DevicePlane([_Engine()])
    p.add_lane(_Small(), mesh=True)
    assert p.batch_size == 64


# -- HostMeshDevice --------------------------------------------------------------


@SIDES
def test_host_mesh_device_verdicts_and_counters(side):
    eng = host_mesh(side)
    items = [(b"m", pks(side), *_req(side, i, ok=(i != 3))) for i in range(6)]
    got = eng.fetch(eng.dispatch_multi(items))
    assert got == [True, True, True, False, True, True]
    assert eng.mesh_launches == 1 and eng.mesh_candidates == 6
    # the shard merge keeps item order at every device count
    assert host_mesh(side, devices=1).dispatch_multi(items) == got


@SIDES
def test_host_mesh_device_epoch_parity(side):
    eng = side.mesh.host_mesh_engine(
        side.harness.FakeScheme().constructor, devices=2, per_candidate_ms=0.0,
        collective_ms=0.0,
    )
    with pytest.raises(RuntimeError, match="stage_registry"):
        eng.activate_staged()
    assert eng.stage_registry(pks(side)) == 16
    assert eng.registry_stagings == 1
    assert eng.activate_staged() == 1
    assert eng.epoch == 1


# -- service integration -----------------------------------------------------------


def _mesh_service(side, mesh_eng, lanes=2, policy=None, mesh_breaker=None):
    p = side.plane.DevicePlane([_Engine() for _ in range(lanes)])
    svc = side.bv.BatchVerifierService(p, max_delay_ms=0.1)
    side.mesh.enable_latency_plane(
        svc, mesh_eng, policy=policy or side.mesh.ModePolicy(small_batch_max=8),
        breaker=mesh_breaker,
    )
    svc.queue.set_tier("gold0", "gold")
    return svc, p


def _run(side, svc, msg, count, session):
    async def go():
        try:
            out = await asyncio.gather(*(
                svc.verify(msg, pks(side), [_req(side, i)], session=session)
                for i in range(count)))
            return out, svc.values()
        finally:
            svc.stop()

    return asyncio.run(go())


@SIDES
def test_gold_small_group_rides_mesh_lane(side):
    mesh_eng = host_mesh(side)
    svc, p = _mesh_service(side, mesh_eng)
    out, vals = _run(side, svc, b"gold", 8, "gold0")
    assert all(v == [True] for v in out)
    assert mesh_eng.mesh_launches >= 1
    assert vals["modeLatencyLaunches"] >= 1.0
    assert vals["meshFallbacks"] == 0.0
    assert vals["meshLaunches"] >= 1.0
    assert all(lane.engine.dispatched == 0 for lane in p.lanes if not lane.mesh)


@SIDES
def test_standard_tier_group_stays_on_lanes(side):
    mesh_eng = host_mesh(side)
    svc, p = _mesh_service(side, mesh_eng)
    out, vals = _run(side, svc, b"bulk", 8, "std")
    assert all(v == [True] for v in out)
    assert mesh_eng.mesh_launches == 0
    assert vals["modeLatencyLaunches"] == 0.0
    assert vals["modeThroughputLaunches"] >= 1.0
    assert sum(lane.engine.dispatched for lane in p.lanes if not lane.mesh) >= 1


@SIDES
def test_oversized_gold_group_stays_on_lanes(side):
    """Gold entitlement does not override the size gate."""
    mesh_eng = host_mesh(side)
    svc, _ = _mesh_service(side, mesh_eng, policy=side.mesh.ModePolicy(small_batch_max=64))
    out, vals = _run(side, svc, b"big", 24, "gold0")
    assert all(v == [True] for v in out)
    assert mesh_eng.mesh_launches == 0
    assert vals["modeThroughputLaunches"] >= 1.0


@SIDES
def test_breaker_open_mesh_lane_degrades_to_throughput(side):
    """An open mesh breaker makes latency mode unavailable: groups fall back
    to the lanes (counted), never to failover."""
    br = side.breaker.CircuitBreaker(cooldown_s=600.0)
    for _ in range(br.threshold):
        br.record_failure()
    mesh_eng = host_mesh(side)
    svc, p = _mesh_service(side, mesh_eng, mesh_breaker=br)
    out, vals = _run(side, svc, b"gold", 8, "gold0")
    assert all(v == [True] for v in out)
    assert mesh_eng.mesh_launches == 0
    assert vals["meshFallbacks"] >= 1.0
    assert vals["meshLanesAvailable"] == 0.0
    assert vals["failoverBatches"] == 0.0
    assert sum(lane.engine.dispatched for lane in p.lanes if not lane.mesh) >= 1


@SIDES
def test_service_gauge_keys_and_values_expose_mode_counters(side):
    svc, _ = _mesh_service(side, host_mesh(side, devices=2))
    try:
        vals = svc.values()
        for key in ("modeLatencyLaunches", "modeThroughputLaunches", "meshFallbacks",
                    "meshLanes", "meshLanesAvailable", "meshPicks", "meshLaunches"):
            assert key in vals, key
        assert vals["meshLanes"] == 1.0
        assert {"meshLanes", "meshLanesAvailable"} <= svc.gauge_keys()
    finally:
        svc.stop()


@SIDES
def test_device_telemetry_reports_mesh_census(side):
    svc, _ = _mesh_service(side, host_mesh(side, devices=2))
    try:
        tel = side.telemetry.DeviceTelemetry(service=svc)
        vals = tel.values()
        assert vals["meshLanes"] == 1.0
        assert vals["meshLanesAvailable"] == 1.0
        assert {"meshLanes", "meshLanesAvailable"} <= tel.gauge_keys()
    finally:
        svc.stop()


@SIDES
def test_mesh_knobs_roundtrip_and_cluster_attaches_lane(side, tmp_path):
    """[service] mesh_devices / mesh_batch_size flow through load_config and
    dump_config, and a cluster built with them serves a run with one mesh
    lane beside the throughput lanes."""
    p = tmp_path / "sim.toml"
    p.write_text("[sim]\nnodes = 8\n\n[service]\nsessions = 2\ndevices = 2\n"
                 "mesh_devices = 4\nmesh_batch_size = 8\n")
    cfg = side.config.load_config(str(p))
    assert cfg.service.mesh_devices == 4 and cfg.service.mesh_batch_size == 8
    dumped = side.config.dump_config(cfg)
    assert "mesh_devices = 4" in dumped and "mesh_batch_size = 8" in dumped
    p.write_text("[sim]\nnodes = 8\n\n[service]\nsessions = 1\n")
    assert side.config.load_config(str(p)).service.mesh_devices == 0

    cluster = side.driver.MultiSessionCluster(
        2, 8, devices=2, mesh_devices=4, mesh_batch_size=8, tier_cycle=("gold",),
    )
    try:
        pl = cluster.service.plane
        assert len(pl.mesh_lanes()) == 1 and len(pl.throughput_pool()) == 2
        assert pl.mesh_lanes()[0].engine.mesh_devices == 4
        out = asyncio.run(cluster.run(timeout=60.0))
        assert out["completed"] == 2
    finally:
        cluster.stop()


def test_the_mesh_config_dumps_to_the_same_text_in_both(tmp_path):
    text = pconfig.dump_config(pconfig.load_config(str(_toml(tmp_path))))
    assert text == rconfig.dump_config(rconfig.load_config(str(_toml(tmp_path))))


def _toml(tmp_path):
    p = tmp_path / "mesh.toml"
    p.write_text("mesh_devices = 2\nscheme = \"bn254-cuda\"\n\n[service]\nsessions = 2\n"
                 "mesh_devices = 4\nmesh_batch_size = 8\n\n[[runs]]\nnodes = 8\n")
    return p


@SIDES
def test_watch_renders_mode_column_and_mesh_summary(side):
    text = (
        'handel_device_verifier_launches{device="0"} 5\n'
        'handel_device_verifier_mode{device="0"} 0\n'
        'handel_device_verifier_launches{device="2"} 3\n'
        'handel_device_verifier_fill_ratio{device="2"} 0.75\n'
        'handel_device_verifier_mode{device="2"} 1\n'
        "handel_device_verifier_mesh_lanes 1\n"
        "handel_device_verifier_mesh_launches 3\n"
        "handel_device_verifier_mode_latency_launches 3\n"
        "handel_device_verifier_mode_throughput_launches 5\n"
        "handel_device_verifier_mesh_fallbacks 1\n"
    )
    model = side.watch.aggregate([side.watch.parse_exposition(text)])
    assert model["devices"]["2"]["mode"] == 1.0
    assert (model["mesh_lanes"], model["mesh_launches"]) == (1.0, 3.0)
    assert (model["mode_latency"], model["mode_throughput"]) == (3.0, 5.0)
    assert model["mesh_fallbacks"] == 1.0
    out = side.watch.render(model, ["x"], 1, 1)
    assert "mode mesh" in out and "mode lane" in out and "1 mesh" in out
    assert "latency 3" in out or "3 latency" in out


# -- the multichip smoke, on 8 shards of the CPU ------------------------------------


def test_multichip_smoke_on_eight_cpu_shards(capsys):
    """The port's counterpart of scripts/multichip_smoke.py (phases 1, 2, 3,
    5a and 5b) with `--device cpu`: 8 engines and a mesh of 8 shards on the
    CPU, every aggregate bit-exact against the host oracle."""
    from handel_tpu_torch.scripts import multichip_smoke

    assert multichip_smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "8 engines on ['cpu'], 32 aggregates verified" in out
    assert "whole-mesh engine over 8 shards" in out and "multichip_smoke: OK" in out
