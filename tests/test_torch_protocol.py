"""The protocol through the port's own harness (handel_tpu_torch/core/
test_harness.py): twins of tests/test_protocol.py's fast cases, a round of
nodes of both packages on one router that passes raw packet bytes between
them, the device-combine wiring, and (slow tier) an 8-node BN254 round on
the port's device engine on the CPU."""

import asyncio
import random
import struct

import pytest

from handel_tpu.core.handel import Handel as JHandel
from handel_tpu.core.identity import ArrayRegistry as JArrayRegistry
from handel_tpu.core.identity import Identity as JIdentity
from handel_tpu.core.net import Packet as JPacket
from handel_tpu.core.timeout import InfiniteTimeout as JInfiniteTimeout
from handel_tpu.core.config import Config as JConfig
from handel_tpu.core.crypto import verify_multisignature as jverify_multisignature
from handel_tpu.models import fake as jfake
from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.config import Config
from handel_tpu_torch.core.crypto import MultiSignature, verify_multisignature
from handel_tpu_torch.core.handel import Handel
from handel_tpu_torch.core.identity import ArrayRegistry, Identity
from handel_tpu_torch.core.net import Packet
from handel_tpu_torch.core.test_harness import LocalCluster, run_cluster
from handel_tpu_torch.core.timeout import InfiniteTimeout
from handel_tpu_torch.models import fake
from handel_tpu_torch.models.fake import FakeConstructor, FakeSignature


def run(coro):
    return asyncio.run(coro)


class VirtualClockLoop(asyncio.SelectorEventLoop):
    """An event loop whose clock stands still while callbacks are ready and
    jumps to the next live timer when none is. A round whose work all runs
    on the loop then sees its timers (the nodes' periodic updates) fire at
    the same points of its work however slow the host is: the wall time a
    verify or a fold takes no longer decides how many updates fall inside
    it."""

    def __init__(self):
        super().__init__()
        self._virtual_now = 0.0

    def time(self) -> float:
        return self._virtual_now

    def _run_once(self) -> None:
        if not self._ready:
            due = [h.when() for h in self._scheduled if not h.cancelled()]
            if due:
                self._virtual_now = max(self._virtual_now, min(due))
        super()._run_once()


def run_on_virtual_clock(coro):
    with asyncio.Runner(loop_factory=VirtualClockLoop) as runner:
        return runner.run(coro)


async def cluster_round(cluster: LocalCluster, timeout: float):
    cluster.start()
    try:
        return await cluster.wait_complete_success(timeout=timeout)
    finally:
        cluster.stop()


@pytest.mark.parametrize("n", [2, 4, 8, 13, 21, 32, 64])
def test_full_aggregation(n):
    results = run(run_cluster(n, timeout=30.0))
    assert len(results) == n
    for sig in results.values():
        assert sig.cardinality() >= (n * 51 + 99) // 100


@pytest.mark.parametrize(
    "n,offline,threshold",
    [
        (8, (1, 5), 6),
        (16, (0, 7, 12), 13),
        (13, (2,), 10),
    ],
)
def test_with_failures(n, offline, threshold):
    cluster = LocalCluster(n, offline=offline, threshold=threshold)
    results = run(cluster_round(cluster, 20.0))
    assert len(results) == n - len(offline)
    for sig in results.values():
        assert sig.cardinality() >= threshold
        for off in offline:  # offline nodes must not appear in the bitset
            assert not sig.bitset.get(off)


def test_final_sig_verifies_against_registry():
    cluster = LocalCluster(8)
    results = run(cluster_round(cluster, 15.0))
    for sig in results.values():
        assert verify_multisignature(b"hello world", sig, cluster.registry, FakeConstructor())


def test_malformed_individual_sig_ignored():
    """A wrong-size individual_sig is an invalid packet (warn + ignore)."""

    async def go():
        cluster = LocalCluster(8)
        cluster.start()
        h0 = cluster.handels[0]
        bs = BitSet(len(h0.levels[3].nodes))
        bs.set(0)
        good_ms = MultiSignature(bs, FakeSignature()).marshal()
        h0.new_packet(
            Packet(origin=4, level=3, multisig=good_ms, individual_sig=b"\x01\x02")
        )
        try:
            return h0, await cluster.wait_complete_success(timeout=15.0)
        finally:
            cluster.stop()

    h0, results = run(go())
    assert len(results) == 8
    assert h0.invalid_packet_ct >= 1 and h0.values()["logWarnCt"] >= 1


def test_forged_candidate_rejected_and_scored():
    """The chip check's forgery, on the fake scheme: a well-formed level-1
    packet from node 0's level-1 peer carrying an invalid one-bit
    multisignature fails verification once, is penalized below the demote
    threshold, and the round still completes."""

    async def go():
        cluster = LocalCluster(8)
        cluster.start()
        h0 = cluster.handels[0]
        (peer,) = h0.partitioner.identities_at(1)
        bs = BitSet(1)
        bs.set(0)
        h0.new_packet(Packet(origin=peer.id, level=1,
                             multisig=MultiSignature(bs, FakeSignature(False)).marshal()))
        try:
            return h0, peer, await cluster.wait_complete_success(timeout=15.0)
        finally:
            cluster.stop()

    h0, peer, results = run(go())
    assert len(results) == 8
    assert h0.values()["sigVerifyFailed"] == 1
    assert 0 < h0.scorer.score(peer.id) < h0.scorer.demote_threshold


def test_flaky_verifier_requeues():
    """A transiently failing verifier must not lose candidates: errored
    batches are requeued (with a retry cap) and aggregation completes."""
    calls = {"n": 0}
    cons = FakeConstructor()

    async def flaky(msg, pubkeys, requests):
        calls["n"] += 1
        if calls["n"] % 2 == 1:
            raise RuntimeError("transient device error")
        return cons.batch_verify(msg, pubkeys, requests)

    def cfg_factory(i):
        return Config(verifier=flaky, rand=random.Random(42 + i))

    results = run(run_cluster(8, timeout=25.0, config_factory=cfg_factory))
    assert len(results) == 8
    assert calls["n"] > 0


class MixedRouter:
    """One routing table for nodes of both packages: a packet is encoded by
    its sender's package and decoded by each receiver's own, so only raw
    bytes cross between them."""

    def __init__(self):
        self.listeners: dict[str, list] = {}
        self.crossings = 0

    def route(self, identities, packet):
        loop = asyncio.get_running_loop()
        wire = packet.encode()
        sender_is_port = isinstance(packet, Packet)
        for ident in identities:
            for listener, decode, is_port in self.listeners.get(ident.address, []):
                self.crossings += sender_is_port != is_port
                loop.call_soon(listener.new_packet, decode(wire))


class MixedNetwork:
    def __init__(self, router: MixedRouter, address: str, packet_cls):
        self.router, self.address, self.packet_cls = router, address, packet_cls

    def send(self, identities, packet):
        self.router.route(identities, packet)

    def register_listener(self, listener):
        self.router.listeners.setdefault(self.address, []).append(
            (listener, self.packet_cls.decode, self.packet_cls is Packet))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_mixed_round_reaches_threshold_on_every_node(seed):
    """8 nodes, the even ids the port's Handel and the odd ids the JAX
    package's, the fake scheme on both sides, one router: every node
    reaches the threshold, and each final signature verifies against both
    packages' registries."""
    n, msg = 8, b"mixed round"
    router = MixedRouter()
    reg = ArrayRegistry([Identity(i, f"mix-{i}", fake.FakePublic(True)) for i in range(n)])
    jreg = JArrayRegistry([JIdentity(i, f"mix-{i}", jfake.FakePublic(True)) for i in range(n)])

    async def go():
        nodes = {}
        for i in range(n):
            if i % 2 == 0:
                cfg = Config(rand=random.Random(seed + i), new_timeout=InfiniteTimeout)
                nodes[i] = Handel(MixedNetwork(router, f"mix-{i}", Packet), reg,
                                  reg.identity(i), fake.FakeConstructor(), msg,
                                  fake.FakeSecret(i).sign(msg), cfg)
            else:
                cfg = JConfig(rand=random.Random(seed + i), new_timeout=JInfiniteTimeout)
                nodes[i] = JHandel(MixedNetwork(router, f"mix-{i}", JPacket), jreg,
                                   jreg.identity(i), jfake.FakeConstructor(), msg,
                                   jfake.FakeSecret(i).sign(msg), cfg)
        for h in nodes.values():
            h.start()
        try:
            finals = await asyncio.wait_for(
                asyncio.gather(*(h.final_signatures.get() for h in nodes.values())), 15.0)
            return nodes, dict(zip(nodes, finals))
        finally:
            for h in nodes.values():
                h.stop()

    nodes, finals = run(go())
    assert router.crossings > 0
    threshold = nodes[0].threshold
    assert threshold == nodes[1].threshold == 5
    for i, sig in finals.items():
        assert sig.cardinality() >= threshold, i
        wire = sig.marshal()
        ours = MultiSignature.unmarshal(wire, fake.FakeConstructor())
        theirs = type(nodes[1].best).unmarshal(wire, jfake.FakeConstructor())
        assert verify_multisignature(msg, ours, reg, fake.FakeConstructor())
        assert jverify_multisignature(msg, theirs, jreg, jfake.FakeConstructor())


class PointSig:
    """A fake signature with a `point` (an int, combined by addition), so
    that the store's merges reach a constructor's device_combine."""

    __slots__ = ("point",)

    def __init__(self, point: int = 1):
        self.point = point

    def marshal(self) -> bytes:
        return struct.pack(">Q", self.point)

    def combine(self, other):
        return PointSig(self.point + other.point)


class PointPublic:
    def marshal(self) -> bytes:
        return bytes(8)

    def verify(self, msg, sig) -> bool:
        return True

    def combine(self, other):
        return self


class PointSecret:
    def sign(self, msg):
        return PointSig(1)


class DeviceCombineConstructor(FakeConstructor):
    """`device_combine` sums each group (or raises, as a failing kernel)."""

    def __init__(self, fail: bool = False):
        self.fail = fail
        self.groups: list[int] = []

    def unmarshal_signature(self, data):
        (v,) = struct.unpack(">Q", data[:8])
        return PointSig(v)

    def device_combine(self, groups):
        if self.fail:
            raise RuntimeError("combine kernel failed")
        self.groups += [len(g) for g in groups]
        return [sum(g) for g in groups]


class PointScheme:
    def __init__(self, fail: bool = False):
        self.constructor = DeviceCombineConstructor(fail)

    def keygen(self, i):
        return PointSecret(), PointPublic()


def test_device_combine_groups_reach_the_hook():
    """A constructor with device_combine gets a CombineShim on every node;
    at 8 nodes groups of 4 reach it, and the counts of signers in each final
    signature equal the combined point (each signer signs 1)."""
    scheme = PointScheme()
    cluster = LocalCluster(8, scheme=scheme)
    results = run(cluster_round(cluster, 15.0))
    assert all(h.combine_shim is not None for h in cluster.handels.values())
    device = sum(h.values()["combineDeviceGroups"] for h in cluster.handels.values())
    assert device >= 1 and min(scheme.constructor.groups) >= 4
    for sig in results.values():
        assert sig.signature.point == sig.cardinality()


def test_failing_device_combine_fails_the_round():
    """No host fold hides a failing combine: the error ends the node's task
    and wait_complete_success raises it, well before its timeout."""
    cluster = LocalCluster(8, scheme=PointScheme(fail=True))
    with pytest.raises(RuntimeError, match="combine kernel failed"):
        run(cluster_round(cluster, 60.0))


def test_port_scheme_wires_the_combine_shim():
    """A node built on BN254TorchScheme gets a CombineShim; its hook
    declines (None) until the device exists, so the store folds on the
    host. Nothing launches here."""
    from handel_tpu_torch.models.bn254_torch import BN254TorchScheme

    cluster = LocalCluster(4, scheme=BN254TorchScheme(batch_size=4, device="cpu"))
    h = cluster.handels[0]
    assert h.combine_shim is not None
    assert h.combine_shim.device_combine([[None, None]]) is None


@pytest.mark.parametrize("n, launches, device_groups",
                         [(4, 8, 0), (5, 9, 1), (6, 12, 4), (8, 24, 8)])
def test_per_node_round_sizes(n, launches, device_groups):
    """The per-node round's shape by committee size (chip_smoke.py phase 7
    runs ROUND_NODES of them at 128 lanes): BN254 keys and packets, a
    verifier that accepts every candidate, and a device combine folding on
    the host. Its verify launches (128-lane chunks) and the merge groups
    that reach the device combine (4 points or more) are fixed by the
    protocol: at 4 nodes no group reaches the device, so phase 7 needs 5.
    The round runs on a virtual clock: on the wall clock, a host slowed by
    other work let extra 10 ms periodic updates fall inside a verify, and
    at 5 nodes the round took 10 launches and 2 device groups."""
    from handel_tpu_torch.models.bn254 import BN254Scheme
    from handel_tpu_torch.ops import bn254_ref as bn

    scheme = BN254Scheme()
    cons = scheme.constructor
    chunks = []
    cons.batch_verify = lambda msg, pks, reqs: (chunks.append(-(-len(reqs) // 128)),
                                                [True] * len(reqs))[1]

    def fold(group):
        acc = None
        for p in group:
            acc = p if acc is None else bn.g1_add(acc, p)
        return acc

    cons.device_combine = lambda groups: [fold(g) for g in groups]

    async def go():
        cluster = LocalCluster(n, scheme=scheme)
        return cluster, await cluster_round(cluster, 120.0)

    cluster, results = run_on_virtual_clock(go())
    assert len(results) == n
    values = [h.values() for h in cluster.handels.values()]
    assert sum(chunks) == launches
    assert sum(v["combineDeviceGroups"] for v in values) == device_groups


@pytest.mark.slow
def test_bn254_round_on_the_port_engine_cpu():
    """The main path on the CPU through the port's own harness: 8 nodes on
    BN254TorchScheme(batch_size=8, device="cpu") reach the threshold, every
    final signature verifies on the host oracle, and the store's merges ran
    through the device combine (combineDeviceGroups >= 1)."""
    from handel_tpu_torch.models.bn254_torch import BN254TorchScheme

    scheme = BN254TorchScheme(batch_size=8, device="cpu")
    msg = b"hello world"

    async def go():
        cluster = LocalCluster(8, scheme=scheme, msg=msg)
        scheme.constructor.prepare(cluster.registry.public_keys())
        return cluster, await cluster_round(cluster, 1800.0)

    cluster, results = run(go())
    assert len(results) == 8
    for sig in results.values():
        assert sig.cardinality() >= cluster.threshold
        assert verify_multisignature(msg, sig, cluster.registry, scheme.constructor)
    values = [h.values() for h in cluster.handels.values()]
    assert sum(v["combineDeviceGroups"] for v in values) >= 1
