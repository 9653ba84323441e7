"""Fleet and mesh verify-plane smoke — counterpart of scripts/multichip_smoke.py.

    python -m handel_tpu_torch.scripts.multichip_smoke [--device cpu] [--devices 8]

Runs on `--devices` cards (default 8: cuda:0..7; fewer visible cards raise,
naming the count), or, with `--device cpu`, on that many shards of the CPU
(`["cpu"] * 8`, the counterpart of the reference's eight forced host
devices). Five phases, each a line; any failure raises:

1. Kernel fleet: `bn254_plane` puts one BN254 engine on each device, each
   committing the registry to its own device, and drives the aggregation
   stage only (range class, prefix table and hole patch; pairing tails are
   the card smoke's job) at the reference's shape (12 keys, 4 lanes). Every
   aggregate key is checked against the host oracle, and every launch ran
   on its engine's device.
2. Service fleet: a DevicePlane of 8 host-math engines behind ONE
   BatchVerifierService: every lane dispatches at least once and every
   verdict matches the scheme's own serial batch_verify.
3. Degraded fleet: lane 0's breaker forced open before start: the run
   completes on the 7 healthy lanes and lane 0 launches nothing.
5a. Mesh kernel: ONE `BN254Device(mesh_devices=8)` drives a batch-8 launch
   through both aggregation entries — the range class (aggregation on the
   first shard's device) and the dense masked sum over the committed
   registry shards, with the mask padded and placed by partition rule as
   the engine's launch does — on a 70-key registry (70 % 8 = 6: the last
   shard carries 2 edge-padded points); every aggregate bit-exact against
   the host oracle.
5b. Mode pick: a dual-mode service (throughput HostDevice lanes and a
   HostMeshDevice mesh lane) routes a small gold-tier group to the mesh
   lane and a bulk standard-tier flood to the per-lane path, verdicts as
   the scheme's, no mesh fallback.

The reference's phases 4 and 5c are bench gates (bench.py `fleet_bench`,
`small_batch_bench`, scripts/bench_check.py); they come with the port's
benchmark (ROADMAP item 10).
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import random
import sys
import time

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.models.bn254 import BN254PublicKey, BN254Signature
from handel_tpu_torch.ops import bn254_ref as bn

N, C, DEVICES = 12, 4, 8


def host_agg(pks, bs):
    acc = None
    for i in bs.indices():
        acc = pks[i].point if acc is None else bn.g2_add(acc, pks[i].point)
    return acc


def make_keys(n: int, rng: random.Random):
    return [BN254PublicKey(bn.g2_mul(bn.G2_GEN, rng.randrange(1, 1 << 20)))
            for _ in range(n)]


def check_aggregates(curves, agg, pks, reqs, label: str) -> None:
    x, y, inf = curves.g2.to_affine(agg)
    xs, ys = curves.T.f2_unpack(x), curves.T.f2_unpack(y)
    infs = inf.cpu().tolist()
    for j, (bs, _) in enumerate(reqs):
        got = None if infs[j] else (xs[j], ys[j])
        assert got == host_agg(pks, bs), f"{label} candidate {j}: aggregate mismatch"


def range_aggregate(eng, reqs):
    """The engine's range class, aggregation stage alone: (plan, projective
    aggregate keys on the engine's device)."""
    plan = eng._pack_requests(reqs)
    assert plan.kind == "range", plan.kind
    lo, hi, miss_idx, miss_ok = eng._stage_plan(plan)[:4]
    agg = eng._range_aggregate(
        lo, hi, miss_idx, miss_ok, eng._prefix, eng.bank.reg_x, eng.bank.reg_y, plan.miss_k
    )
    return plan, agg


def kernel_fleet_smoke(placement) -> None:
    """Phase 1: one aggregation launch per engine of `bn254_plane`,
    aggregate keys against the host oracle, every launch on its device."""
    from handel_tpu_torch.parallel.plane import bn254_plane

    rng = random.Random(99)
    pks = make_keys(N, rng)
    sig = BN254Signature(bn.G1_GEN)
    plane = bn254_plane(pks, len(placement), batch_size=C, placement=placement,
                        warmup=False)
    t0 = time.perf_counter()
    checked = 0
    for lane in plane.lanes:
        eng = lane.engine
        reqs = []
        for _ in range(C):
            size = rng.randrange(2, N)
            lo = rng.randrange(0, N - size + 1)
            bs = BitSet(N)
            for i in range(lo, lo + size):
                bs.set(i, True)
            reqs.append((bs, sig))
        _plan, agg = range_aggregate(eng, reqs)
        devs = {a.device for a in (agg[0][0], agg[1][1], agg[2][0])}
        assert devs == {eng.device}, f"lane {lane.index}: ran on {devs}, not {eng.device}"
        lane.launches += 1
        check_aggregates(eng.curves, agg, pks, reqs, f"lane {lane.index}")
        checked += len(reqs)
    assert all(lane.launches >= 1 for lane in plane.lanes)
    print(f"multichip_smoke: {len(plane.lanes)} engines on "
          f"{sorted({str(d) for d in placement})}, {checked} aggregates verified "
          f"against the host oracle in {time.perf_counter() - t0:.1f}s", flush=True)


def _service_run(trip_lane: int | None = None) -> dict:
    """One fleet service run over 8 host-math lanes: per-lane launch counts
    and the service's values, verdicts checked. `trip_lane` forces that
    lane's breaker open before the service starts."""
    from handel_tpu_torch.core.test_harness import FakeScheme
    from handel_tpu_torch.models.fake import FakePublic, FakeSignature
    from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
    from handel_tpu_torch.parallel.plane import DevicePlane
    from handel_tpu_torch.service.driver import HostDevice
    from handel_tpu_torch.utils.breaker import CircuitBreaker

    scheme = FakeScheme()
    pks = [FakePublic(True) for _ in range(16)]
    engines = [HostDevice(scheme.constructor, batch_size=4, launch_ms=2.0)
               for _ in range(DEVICES)]
    breakers = [CircuitBreaker(cooldown_s=600.0) for _ in range(DEVICES)]
    plane = DevicePlane(engines, breakers=breakers)
    if trip_lane is not None:
        br = plane.lanes[trip_lane].breaker
        for _ in range(br.threshold):
            br.record_failure()
        assert not br.allow()

    reqs = []
    for i in range(96):
        b = BitSet(16)
        b.set(i % 16, True)
        # an invalid signature every 8th request: the verdict check must
        # see the scheme's own False, not a blanket True
        reqs.append((i.to_bytes(4, "big"), (b, FakeSignature(i % 8 != 7))))
    want = [scheme.constructor.batch_verify(msg, pks, [r])[0] for msg, r in reqs]

    async def go():
        loop = asyncio.get_running_loop()
        loop.set_default_executor(
            concurrent.futures.ThreadPoolExecutor(max_workers=2 * DEVICES + 4))
        svc = BatchVerifierService(plane, max_delay_ms=0.2)
        try:
            got = await asyncio.gather(*(
                svc.verify(msg, pks, [r], session=f"s{i % 4}")
                for i, (msg, r) in enumerate(reqs)))
            return [v[0] for v in got], svc.values()
        finally:
            svc.stop()

    got, vals = asyncio.run(go())
    assert got == want, "fleet verdicts diverge from the host scheme"
    return {"per_lane": [lane.engine.dispatched for lane in plane.lanes], "values": vals}


def service_fleet_smoke() -> None:
    """Phase 2: all 8 lanes dispatch, verdicts match the host scheme."""
    out = _service_run()
    per_lane = out["per_lane"]
    assert all(n >= 1 for n in per_lane), f"idle lane in a flooded fleet: {per_lane}"
    print(f"multichip_smoke: service fleet per-lane launches {per_lane}, "
          f"fill {out['values']['launchFillRatio']:.2f}", flush=True)


def degraded_fleet_smoke() -> None:
    """Phase 3: breaker-open on lane 0 degrades to the 7 healthy lanes."""
    out = _service_run(trip_lane=0)
    per_lane = out["per_lane"]
    assert per_lane[0] == 0, f"breaker-open lane 0 still dispatched: {per_lane}"
    assert all(n >= 1 for n in per_lane[1:]), f"healthy lane idle: {per_lane}"
    assert out["values"]["devicesAvailable"] == DEVICES - 1
    assert out["values"]["failoverBatches"] == 0.0
    print(f"multichip_smoke: degraded fleet completed on {DEVICES - 1} lanes, "
          f"per-lane launches {per_lane}", flush=True)


def mesh_kernel_smoke(placement) -> None:
    """Phase 5a: one whole-mesh engine, batch-8 launches of both aggregation
    classes bit-exact against the host oracle across the edge-padded
    registry shard boundary."""
    import numpy as np

    from handel_tpu_torch.parallel.mesh_plane import bn254_mesh_engine
    from handel_tpu_torch.parallel.sharding import make_mesh

    # 70 % 8 = 6: the last registry shard carries 2 padded points
    n_mesh, c = 70, 8
    rng = random.Random(7)
    pks = make_keys(n_mesh, rng)
    sig = BN254Signature(bn.G1_GEN)
    k = len(placement)
    eng = bn254_mesh_engine(pks, k, batch_size=c, mesh=make_mesh(k, devices=placement))
    assert eng.mesh is not None and eng._mesh_pad == (-n_mesh) % k, eng._mesh_pad
    t0 = time.perf_counter()

    # range class: contiguous signer windows, aggregated on the first
    # shard's device from the prefix table
    reqs = []
    for _ in range(c):
        size = rng.randrange(2, 16)
        lo = rng.randrange(0, n_mesh - size + 1)
        bs = BitSet(n_mesh)
        for i in range(lo, lo + size):
            bs.set(i, True)
        reqs.append((bs, sig))
    _plan, agg = range_aggregate(eng, reqs)
    check_aggregates(eng.curves, agg, pks, reqs, "mesh range")

    # dense class: sparse signers across the whole hull (> MISS_CAP holes):
    # the rule-placed padded mask into the sharded sum, as the launch stages it
    reqs = []
    for _ in range(c):
        bs = BitSet(n_mesh)
        bs.set(0, True)
        bs.set(n_mesh - 1, True)
        for i in rng.sample(range(1, n_mesh - 1), 3):
            bs.set(i, True)
        reqs.append((bs, sig))
    plan = eng._pack_requests(reqs)
    assert plan.kind == "dense", plan.kind
    mask = np.unpackbits(plan.words.view(np.uint8), axis=1, count=n_mesh,
                         bitorder="little").view(np.bool_).T
    mask = np.pad(mask, ((0, eng._mesh_pad), (0, 0)))
    (rx0, rx1), (ry0, ry1) = eng._reg_sharded
    agg = eng._sharded_sum(rx0, rx1, ry0, ry1, eng._mesh_put["mask"](mask))
    check_aggregates(eng.curves, agg, pks, reqs, "mesh dense")
    print(f"multichip_smoke: whole-mesh engine over {k} shards "
          f"({sorted({str(d) for d in placement})}), 2x{c} aggregates (range + "
          f"edge-padded dense) bit-exact against the host oracle in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def mode_pick_smoke() -> None:
    """Phase 5b: gold/small -> mesh lane, bulk -> per-lane, verdicts exact,
    zero fallbacks."""
    from handel_tpu_torch.core.test_harness import FakeScheme
    from handel_tpu_torch.models.fake import FakePublic, FakeSignature
    from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
    from handel_tpu_torch.parallel.mesh_plane import (
        ModePolicy,
        enable_latency_plane,
        host_mesh_engine,
    )
    from handel_tpu_torch.parallel.plane import host_plane

    scheme = FakeScheme()
    pks = [FakePublic(True) for _ in range(16)]
    # lane batch == mesh batch: the collector plans launch groups at the
    # throughput batch size, so a smaller lane batch would split the
    # 8-candidate gold group and the second half would find the mesh busy
    plane = host_plane(scheme.constructor, 2, batch_size=8, launch_ms=1.0)
    mesh_eng = host_mesh_engine(scheme.constructor, devices=DEVICES, batch_size=8,
                                per_candidate_ms=0.2)
    # bulk flood: distinct messages, the default (standard) tier, every 8th
    # signature invalid so that the verdict check is live
    bulk = []
    for i in range(48):
        b = BitSet(16)
        b.set(i % 16, True)
        bulk.append((i.to_bytes(4, "big"), (b, FakeSignature(i % 8 != 7))))
    want_bulk = [scheme.constructor.batch_verify(msg, pks, [r])[0] for msg, r in bulk]
    # small gold group: one message, 8 distinct candidates
    gold = []
    for i in range(8):
        b = BitSet(16)
        b.set(i, True)
        gold.append((b, FakeSignature(True)))

    async def go():
        loop = asyncio.get_running_loop()
        loop.set_default_executor(concurrent.futures.ThreadPoolExecutor(max_workers=24))
        svc = BatchVerifierService(plane, max_delay_ms=0.2)
        enable_latency_plane(svc, mesh_eng, policy=ModePolicy(small_batch_max=8))
        svc.queue.set_tier("gold0", "gold")
        try:
            got_gold = await asyncio.gather(*(
                svc.verify(b"gold-round", pks, [q], session="gold0") for q in gold))
            got_bulk = await asyncio.gather(*(
                svc.verify(msg, pks, [r], session=f"s{i % 4}")
                for i, (msg, r) in enumerate(bulk)))
            return [v[0] for v in got_gold], [v[0] for v in got_bulk], svc.values()
        finally:
            svc.stop()

    got_gold, got_bulk, vals = asyncio.run(go())
    assert all(got_gold), "gold-tier mesh verdicts diverge"
    assert got_bulk == want_bulk, "bulk verdicts diverge from the scheme"
    assert vals["meshLanes"] == 1.0 and vals["meshLanesAvailable"] == 1.0
    assert mesh_eng.mesh_launches >= 1, "small gold-tier group never rode the mesh lane"
    assert vals["modeLatencyLaunches"] >= 1.0, vals
    assert vals["modeThroughputLaunches"] >= 1.0, f"bulk never took the lanes: {vals}"
    assert vals["meshFallbacks"] == 0.0, vals
    per_lane = [lane.engine.dispatched for lane in plane.lanes if not lane.mesh]
    assert all(n >= 1 for n in per_lane), f"idle throughput lane under bulk: {per_lane}"
    print(f"multichip_smoke: mode pick — {vals['modeLatencyLaunches']:.0f} latency "
          f"launches ({mesh_eng.mesh_candidates} candidates on the mesh), "
          f"{vals['modeThroughputLaunches']:.0f} throughput launches across lanes "
          f"{per_lane}, 0 fallbacks", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cards (default) or shards of the CPU")
    ap.add_argument("--devices", type=int, default=DEVICES,
                    help="cards or CPU shards of the fleet and the mesh")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        placement = ["cpu"] * args.devices
    else:
        import torch

        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < args.devices:
            raise ValueError(f"{args.devices} cards requested but only {visible} visible; "
                             f"pass --device cpu for the CPU rehearsal")
        placement = [f"cuda:{i}" for i in range(args.devices)]
    kernel_fleet_smoke(placement)
    service_fleet_smoke()
    degraded_fleet_smoke()
    mesh_kernel_smoke(placement)
    mode_pick_smoke()
    print("multichip_smoke: OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
