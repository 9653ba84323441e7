"""The port's comparison baselines (handel_tpu_torch/baselines/ and the sim
node's baseline path) against the JAX package's, after
tests/test_baselines.py.

Tolerance: exact for what does not follow the host's timing: gossipsub's
control frames byte for byte over a scripted exchange, the counters after
malformed frames, the origin evicted by the aggregate-then-verify
bisection with its check count, and the final aggregate's bytes. Gossip
runs on the in-process router follow the loop's timing, so they are held
by completion, the span names they trace, and the CSV columns of a sim run.
"""

import asyncio
import csv
import os
import struct
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from handel_tpu.baselines import gossip as jgossip
from handel_tpu.baselines import gossipsub as jgossipsub
from handel_tpu.core import bitset as jbitset
from handel_tpu.core import identity as jidentity
from handel_tpu.core import net as jnet
from handel_tpu.core import trace as jtrace
from handel_tpu.models import bn254 as jbn254
from handel_tpu.models import fake as jfake
from handel_tpu.sim import config as rconfig
from handel_tpu_torch.baselines import gossip, gossipsub
from handel_tpu_torch.core import bitset, identity, net, trace
from handel_tpu_torch.models import bn254, fake
from handel_tpu_torch.sim import config as pconfig

ROOT = Path(__file__).resolve().parents[1]
PORT = SimpleNamespace(gossip=gossip, gossipsub=gossipsub, bitset=bitset, identity=identity,
                       net=net, trace=trace, bn254=bn254, fake=fake, config=pconfig,
                       pkg="handel_tpu_torch")
REF = SimpleNamespace(gossip=jgossip, gossipsub=jgossipsub, bitset=jbitset, identity=jidentity,
                      net=jnet, trace=jtrace, bn254=jbn254, fake=jfake, config=rconfig,
                      pkg="handel_tpu")
SIDES = pytest.mark.parametrize("side", [PORT, REF], ids=["port", "ref"])


class RecordingNet:
    """A Network that keeps every send as (recipient ids, packet fields)."""

    def __init__(self):
        self.sent = []

    def register_listener(self, listener):
        pass

    def send(self, identities, packet):
        self.sent.append(([i.id for i in identities], packet.origin, packet.level,
                          packet.multisig))


# -- gossip ----------------------------------------------------------------


@SIDES
def test_gossip_full_mesh(side):
    results = asyncio.run(side.gossip.run_gossip(8, threshold=5, connector="full"))
    assert len(results) == 8
    assert all(ms.bitset.cardinality() >= 5 for ms in results.values())


@SIDES
def test_gossip_random_fanout(side):
    results = asyncio.run(side.gossip.run_gossip(10, threshold=6, connector="random", fanout=4))
    assert len(results) == 10
    assert all(ms.bitset.cardinality() >= 6 for ms in results.values())


def traced_gossip(side):
    rec = side.trace.FlightRecorder(capacity=1 << 15)
    results = asyncio.run(side.gossip.run_gossip(8, threshold=5, connector="full", recorder=rec))
    return results, rec.export()["traceEvents"]


def test_gossip_traced_spans_have_the_references_names():
    """With a recorder attached the baseline emits Handel's pipeline spans,
    flow links and threshold instant, under the reference's names, and
    its flows link up in the port's trace CLI."""
    from handel_tpu_torch.sim import trace_cli

    shapes = []
    for side in (PORT, REF):
        results, events = traced_gossip(side)
        assert len(results) == 8
        shapes.append((
            {e["name"] for e in events if e["ph"] == "X"},
            {e["name"] for e in events if e["ph"] == "i"},
            {e["cat"] for e in events if "cat" in e},
            sorted({str(e["args"].get("name", "")) for e in events if e["ph"] == "M"}),
        ))
        frac, linked, total = trace_cli.flow_linkage(events)
        assert total > 0 and frac >= 0.95, f"{linked}/{total}"
    assert shapes[0] == shapes[1]
    assert {"send", "recv", "verify", "merge", "net_transit"} <= shapes[0][0]
    assert "threshold_reached" in shapes[0][1]
    assert any("gossip-" in name for name in shapes[0][3])


FORGED = 2


def bisect_run(side):
    """One aggregate-then-verify node (id 0) over host BN254 keys, fed by
    hand: origins 1 and 2 reach the threshold of 3 with 2's signature
    forged (over another message), the bisection evicts it, and origin 3
    then completes the aggregate."""
    scheme = side.bn254.BN254Scheme()
    pairs = [scheme.keygen(i) for i in range(4)]
    reg = side.identity.ArrayRegistry(
        [side.identity.Identity(i, f"g-{i}", pk) for i, (_, pk) in enumerate(pairs)])
    msg = b"gossip baseline msg"

    async def go():
        node = side.gossip.GossipAggregator(
            RecordingNet(), reg, reg.identity(0), scheme.constructor, msg,
            pairs[0][0].sign(msg), 3, verify_incoming=False)
        trail = []
        for origin in (1, FORGED, 3):
            sig = pairs[origin][0].sign(b"forged" if origin == FORGED else msg)
            node.new_packet(side.net.Packet(origin=origin, level=side.gossip.GOSSIP_LEVEL,
                                            multisig=sig.marshal()))
            trail.append((sorted(node.sigs), node.values(), node.final.done()))
        return trail, node.final.result().marshal()

    return asyncio.run(go())


def test_aggregate_then_verify_evicts_the_same_forged_origin():
    ours, theirs = bisect_run(PORT), bisect_run(REF)
    assert ours == theirs
    trail, final = ours
    after_forged = trail[1]
    assert after_forged[0] == [0, 1]  # the forged origin was evicted
    assert after_forged[1]["sigEvictedCt"] == 1.0
    assert after_forged[2] is False  # 2 clean < threshold 3: keep gossiping
    assert trail[2][0] == [0, 1, 3] and trail[2][2] is True
    assert final  # the aggregate's bytes, equal in both packages (above)


@SIDES
def test_gossip_aggregate_then_verify_real_crypto(side):
    results = asyncio.run(side.gossip.run_gossip(
        4, threshold=3, scheme=side.bn254.BN254Scheme(), verify_incoming=False, timeout=120.0))
    assert len(results) == 4


# -- gossipsub -------------------------------------------------------------


@SIDES
def test_gossipsub_completes(side):
    finals = asyncio.run(side.gossipsub.run_gossipsub(12, threshold=7))
    assert len(finals) == 12
    assert all(ms.bitset.cardinality() >= 7 for ms in finals.values())


@SIDES
def test_gossipsub_mesh_maintenance_and_lazy_repair(side):
    """GRAFT/PRUNE keep meshes inside [D_lo, D_hi] at each heartbeat's
    maintenance pass and IHAVE/IWANT repair holes: with a tiny eager
    degree the lazy channel must still complete the aggregation."""
    nodes_seen = []
    post_prune_sizes = []

    class Spy(side.gossipsub.GossipSubAggregator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            nodes_seen.append(self)

        def _heartbeat(self):
            super()._heartbeat()
            post_prune_sizes.extend((len(m), self.D_hi) for m in self.mesh.values())

    finals = asyncio.run(side.gossip.run_gossip(
        16, threshold=12, aggregator_cls=Spy, degree=2, degree_lo=2, degree_hi=4,
        degree_lazy=3))
    assert all(ms.bitset.cardinality() >= 12 for ms in finals.values())
    assert any(n.grafts_sent > 0 for n in nodes_seen)
    assert any(n.ihave_sent > 0 for n in nodes_seen)
    assert any(n.iwant_sent > 0 for n in nodes_seen)
    assert post_prune_sizes, "no heartbeat ran during the aggregation"
    assert all(size <= d_hi for size, d_hi in post_prune_sizes)
    assert all(n.setup_complete for n in nodes_seen)


@pytest.mark.parametrize("topics", [[], [0], [1, 2, 3], list(range(0, 4000, 7))])
def test_gossipsub_frame_helpers_byte_equal(topics):
    for kind in range(6):
        for topic in (0, 5, 2**32 - 1):
            assert gossipsub._frame(kind, topic, b"xy") == jgossipsub._frame(kind, topic, b"xy")
    payload = gossipsub._topics_payload(topics)
    assert payload == jgossipsub._topics_payload(topics)
    assert gossipsub._parse_topics(payload) == jgossipsub._parse_topics(payload) == topics
    assert (gossipsub._SUB, gossipsub._PUB, gossipsub._GRAFT, gossipsub._PRUNE,
            gossipsub._IHAVE, gossipsub._IWANT, gossipsub.GOSSIPSUB_LEVEL) == \
           (jgossipsub._SUB, jgossipsub._PUB, jgossipsub._GRAFT, jgossipsub._PRUNE,
            jgossipsub._IHAVE, jgossipsub._IWANT, jgossipsub.GOSSIPSUB_LEVEL)


def fake_registry(side, n):
    return side.identity.ArrayRegistry(
        [side.identity.Identity(i, f"x-{i}", side.fake.FakePublic(True)) for i in range(n)])


def scripted_exchange(side, n=16):
    """Node 0 of an n-node gossipsub through a scripted exchange: every
    peer's SUB, the setup publish, a PUB, IHAVE and IWANT from peers, a
    GRAFT and a PRUNE, and heartbeats. Returns every frame it sent with its
    recipients, and its counters."""
    m = side.gossipsub
    reg = fake_registry(side, n)
    rec = RecordingNet()
    Packet = side.net.Packet

    async def go():
        agg = m.GossipSubAggregator(rec, reg, reg.identity(0), side.fake.FakeConstructor(),
                                    b"m", side.fake.FakeSecret(0).sign(b"m"), n - 2,
                                    degree=3, degree_lo=2, degree_hi=5, degree_lazy=2)

        def frame(origin, kind, topic, payload=b""):
            agg.new_packet(Packet(origin=origin, level=m.GOSSIPSUB_LEVEL,
                                  multisig=m._frame(kind, topic, payload)))

        for p in range(1, n):
            frame(p, m._SUB, p)
        assert len(agg.subscribed) == n
        agg.setup_complete = True
        agg._publish_to_mesh(agg.id, agg.sigs[agg.id])
        sig = side.fake.FakeSecret(5).sign(b"m").marshal()
        frame(5, m._PUB, 5, sig)
        frame(7, m._IHAVE, 0, m._topics_payload([5, 6, 9]))
        frame(8, m._IWANT, 0, m._topics_payload([0, 5, 11]))
        for p in (9, 10, 11, 12, 13, 14):
            frame(p, m._GRAFT, 0)
        frame(9, m._PRUNE, 0)
        for _ in range(4):
            agg._heartbeat()
        for t in range(1, n):
            frame(t, m._PUB, t, side.fake.FakeSecret(t).sign(b"m").marshal())
        agg._heartbeat()
        return rec.sent, agg.values(), sorted(agg.mesh[0]), agg.final.done()

    return asyncio.run(go())


def test_gossipsub_control_frames_byte_equal_to_the_references():
    ours, theirs = scripted_exchange(PORT), scripted_exchange(REF)
    assert ours == theirs
    sent, values, mesh, done = ours
    kinds = {frame[0] for _, _, _, frame in sent}
    assert {gossipsub._PUB, gossipsub._GRAFT, gossipsub._PRUNE, gossipsub._IHAVE,
            gossipsub._IWANT} <= kinds
    assert values["prunesSent"] > 0 and values["iwantSent"] > 0
    assert done


MALFORMED = {
    "short": b"\x01\x00",
    "ihave_truncated": struct.pack(">BI", 4, 0) + struct.pack(">H", 1) + b"\x00\x00\x01",
    "iwant_truncated": struct.pack(">BI", 5, 0) + struct.pack(">H", 3) + b"\x00",
    "ihave_no_count": struct.pack(">BI", 4, 0),
    "pub_truncated_sig": struct.pack(">BI", 1, 1),
    "pub_garbage_sig": struct.pack(">BI", 1, 2) + b"\xff\xfe",
    "pub_bad_topic": struct.pack(">BI", 1, 999) + b"\x01",
    "unknown_kind": struct.pack(">BI", 9, 1),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_gossipsub_malformed_frames_dropped_and_counted_alike(name):
    out = []
    for side in (PORT, REF):
        m = side.gossipsub
        reg = fake_registry(side, 4)
        rec = RecordingNet()

        async def go():
            agg = m.GossipSubAggregator(rec, reg, reg.identity(0), side.fake.FakeConstructor(),
                                        b"m", side.fake.FakeSecret(0).sign(b"m"), 3)
            agg.new_packet(side.net.Packet(origin=1, level=m.GOSSIPSUB_LEVEL,
                                           multisig=MALFORMED[name]))
            # a frame at another level is not gossipsub's: ignored
            agg.new_packet(side.net.Packet(origin=1, level=3, multisig=MALFORMED[name]))
            return agg.values(), sorted(agg.sigs), sorted(agg.subscribed), rec.sent

        out.append(asyncio.run(go()))
    assert out[0] == out[1]
    assert out[0][1] == [0]  # nothing malformed was ever delivered


# -- the sim node's baseline path ------------------------------------------


def baseline_cfg(mod, baseline, scheme="fake", nodes=8, threshold=5, processes=2):
    return mod.SimConfig(
        network="udp", scheme=scheme, baseline=baseline, max_timeout_s=120.0,
        runs=[mod.RunConfig(nodes=nodes, threshold=threshold, processes=processes,
                            handel=mod.HandelParams(period_ms=50.0))],
    )


def cli_run(pkg, cfg_text, workdir, env):
    cfg_path = workdir / "c.toml"
    workdir.mkdir(parents=True)
    cfg_path.write_text(cfg_text)
    out = subprocess.run(
        [sys.executable, "-m", f"{pkg}.sim", "--config", str(cfg_path),
         "--workdir", str(workdir / "w")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines() == [f"run 0: success -> {workdir / 'w' / 'results_0.csv'}"]
    with open(workdir / "w" / "results_0.csv") as f:
        rows = list(csv.reader(f))
    return rows[0], dict(zip(rows[0], map(float, rows[1])))


@pytest.mark.parametrize("baseline", ["nsquare", "gossipsub"])
def test_baseline_sim_run_through_each_cli_has_the_same_columns(baseline, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    text = pconfig.dump_config(baseline_cfg(pconfig, baseline))
    (tmp_path / "t.toml").write_text(text)
    assert rconfig.dump_config(rconfig.load_config(str(tmp_path / "t.toml"))) == text
    (ph, prow), (rh, rrow) = (cli_run(side.pkg, text, tmp_path / side.pkg, env)
                              for side in (PORT, REF))
    assert ph == rh
    for row in (prow, rrow):
        assert row["nodes"] == 8
        assert row["sigs_sigCheckedCt_sum"] > 0
    if baseline == "gossipsub":
        assert prow["sigs_graftsSent_sum"] > 0


def test_device_scheme_baseline_verifies_on_the_host(tmp_path, monkeypatch):
    """`bn254-cuda` with a baseline verifies as the reference's `bn254-jax`
    does: the nodes verify on arrival with the host `verify`, and the
    process builds no shared verifier. It builds the host `bn254` scheme,
    so it holds no engine and prints no kernels line."""
    from handel_tpu_torch.sim.platform import LocalhostPlatform

    monkeypatch.setenv("HANDEL_TORCH_DEVICE", "cpu")
    cfg = baseline_cfg(pconfig, "nsquare", scheme="bn254-cuda", nodes=4, threshold=3,
                       processes=1)
    cfg.shared_verifier = True
    cfg.batch_size = 4

    async def go():
        return await LocalhostPlatform(cfg, str(tmp_path)).start_run(0)

    res = asyncio.run(go())
    assert res.ok, [e.decode(errors="replace")[-2000:] for _, e in res.outputs]
    with open(res.csv_path) as f:
        rows = list(csv.reader(f))
    header, row = rows[0], dict(zip(rows[0], map(float, rows[1])))
    assert not any(h.startswith("device_verifier_") for h in header)
    assert row["sigs_sigCheckedCt_sum"] >= 4 * 2  # per-arrival host checks
    out = (tmp_path / "node_0_0.out").read_text()
    assert "node process kernels: " not in out


@pytest.mark.parametrize("name", ["bn254-cuda", "bn256-cuda", "bn254-jax", "bls12-381-cuda",
                                  "bls12-381-jax", "bn254", "bls12-381", "fake", "eddsa"])
def test_a_baseline_builds_the_host_scheme_of_its_keys(name):
    """A baseline's node builds `host_scheme_name(scheme)`: a host scheme,
    the device scheme's own base class, so it reads the keys the
    platform generated with the device scheme."""
    from handel_tpu_torch.models import registry as preg

    host = preg.host_scheme_name(name)
    assert not preg.is_device_scheme(host)
    if preg.is_device_scheme(name):
        assert host in ("bn254", "bls12-381")
        assert host[:3] == name[:3]
        host_cls = type(preg.new_scheme(host))
        from handel_tpu_torch.models.bls12_381_torch import BLS12381TorchScheme
        from handel_tpu_torch.models.bn254_torch import BN254TorchScheme

        device_cls = BLS12381TorchScheme if name.startswith("bls") else BN254TorchScheme
        assert issubclass(device_cls, host_cls)
    else:
        assert host == name
