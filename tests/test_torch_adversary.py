"""The port's byzantine roles (handel_tpu_torch/sim/adversary.py) against the
JAX package's, and adversarial rounds through the port's harness.

Tolerance: identical — role mappings, error outcomes, forged-signature
bytes and flood packets are compared exactly; rounds by their outcome
(every honest node at the threshold, no adversary in a final signature,
forgeries rejected and attributed).
"""

import asyncio
import random

import pytest

from handel_tpu.core.test_harness import LocalCluster as JLocalCluster
from handel_tpu.models.bn254 import BN254Scheme as JBN254Scheme
from handel_tpu.models.fake import FakeSecret as JFakeSecret
from handel_tpu.sim import adversary as jadv
from handel_tpu_torch.core.test_harness import LocalCluster
from handel_tpu_torch.models.bn254 import BN254Scheme
from handel_tpu_torch.models.fake import FakeSecret
from handel_tpu_torch.sim import adversary as padv


def outcome(fn, *args, **kwargs):
    """(result, None) or (None, exception type and text)."""
    try:
        return fn(*args, **kwargs), None
    except ValueError as e:
        return None, (type(e).__name__, str(e))


ROLE_CASES = [
    ({"invalid_signer": 4, "stale_replayer": 2, "flooder": 1}, 64, frozenset()),
    ({"invalid_signer": 2, "flooder": 1}, 16, frozenset({15, 13})),
    ({"invalid_signer": 1, "stale_replayer": 1, "flooder": 1, "churner": 2}, 10,
     frozenset({0, 9})),
    ({"invalid_signer": 4}, 4, frozenset({0, 3})),  # cannot seat them
    ({}, 8, frozenset()),
]


@pytest.mark.parametrize("counts, total, offline", ROLE_CASES)
def test_adversary_roles_match(counts, total, offline):
    assert outcome(padv.adversary_roles, counts, total, offline) == \
        outcome(jadv.adversary_roles, counts, total, offline)
    assert padv.ROLES == jadv.ROLES


@pytest.mark.parametrize("seed", range(6))
def test_threshold_reachability_matches(seed):
    rng = random.Random(seed)
    total = rng.randrange(8, 40)
    counts = {r: rng.randrange(0, 3) for r in jadv.ROLES}
    roles = jadv.adversary_roles(counts, total)
    failing = rng.randrange(0, 4)
    weights = [rng.uniform(0.5, 2.0) for _ in range(total)] if seed % 2 else None
    for threshold in (total // 2, total - failing - 2, total):
        ours = outcome(padv.check_threshold_reachable, threshold, total, failing, roles,
                       weights=weights)
        assert ours == outcome(jadv.check_threshold_reachable, threshold, total, failing,
                               roles, weights=weights)


@pytest.mark.parametrize("i", [0, 3, 17])
def test_forged_signature_bytes_match_on_bn254(i):
    """The same key forges the same wrong-message signature bytes, and it
    fails verification in both packages."""
    msg = b"handel-tpu simulation message"
    (sk, pk), (jsk, jpk) = BN254Scheme().keygen(i), JBN254Scheme().keygen(i)
    forged, jforged = padv.forged_signature(sk, msg), jadv.forged_signature(jsk, msg)
    assert forged.marshal() == jforged.marshal()
    assert not pk.verify(msg, forged) and not jpk.verify(msg, jforged)
    assert pk.verify(msg, sk.sign(msg))


def test_forged_signature_on_the_fake_scheme():
    f, jf = padv.forged_signature(FakeSecret(3), b"m"), jadv.forged_signature(JFakeSecret(3), b"m")
    assert f.marshal() == jf.marshal()


def cluster_pair(roles: dict, n: int = 16, threshold: int = 9):
    return (LocalCluster(n, threshold=threshold, adversaries=roles),
            JLocalCluster(n, threshold=threshold, adversaries=roles))


def test_adversaries_are_the_references_classes():
    roles = {15: "invalid_signer", 14: "stale_replayer", 13: "flooder"}
    ours, theirs = cluster_pair(roles)
    for i, role in roles.items():
        assert ours.adversaries[i].role == theirs.adversaries[i].role == role
        assert ours.adversaries[i].sig.marshal() == theirs.adversaries[i].sig.marshal()
    assert sorted(ours.handels) == sorted(theirs.handels) == list(range(13))


@pytest.mark.parametrize("level", [1, 3, 4])
def test_flood_packets_match(level):
    """The flooder's seeded storm: the same packet bytes, packet after
    packet."""
    ours, theirs = cluster_pair({13: "flooder"})
    a, b = ours.adversaries[13], theirs.adversaries[13]
    for _ in range(20):
        assert a._flood_packet(level).encode() == b._flood_packet(level).encode()


def churner_departure(cls):
    """An 8-node round whose node 7 is a churner leaving at once (its timer
    fires on the loop's first pass, before any packet lands): what the
    churner and the survivors record of the departure."""

    async def go():
        cl = cls(8, adversaries={7: "churner"}, churn_after_s=0.0)
        ch = cl.adversaries[7]
        assert (ch.role, ch.left, ch.leave_after_s, ch.on_depart is not None) == \
            ("churner", False, 0.0, True)
        cl.start()
        try:
            finals = await cl.wait_complete_success(timeout=30)
        finally:
            cl.stop()
        return (
            ch.left, ch.values()["advLeftCt"], ch.done,
            sorted({frozenset(h.departed) for h in cl.handels.values()}, key=sorted),
            {h.values()["departedCt"] for h in cl.handels.values()},
            {h.values()["thresholdUnreachableCt"] for h in cl.handels.values()},
            sorted(finals), cl.threshold,
            all(f.cardinality() >= cl.threshold for f in finals.values()),
        )

    return asyncio.run(go())


def test_churner_and_unknown_roles_raise():
    """The churner role is ported: its departure is the reference's (it
    leaves, stops, and every survivor marks it, the threshold still
    reachable); an unknown role and a malformed planet still raise."""
    ours = churner_departure(LocalCluster)
    assert ours == churner_departure(JLocalCluster)
    assert ours[:6] == (True, 1.0, True, [frozenset({7})], {1.0}, {0.0})
    assert ours[6] == list(range(7)) and ours[8]
    with pytest.raises(ValueError, match="unknown adversary role"):
        LocalCluster(8, adversaries={7: "bogus"})
    # a malformed planet is refused before any node is built, as in the
    # reference (the geo model itself is held in tests/test_torch_geo.py)
    from handel_tpu_torch.network.geo import GeoConfig

    with pytest.raises(ValueError, match="matrix"):
        LocalCluster(8, geo=GeoConfig(regions=("a", "b"), rtt_ms=((0.0, 1.0),)))


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_adversarial_round_reaches_threshold(pkg):
    """16 nodes, two invalid signers, a stale replayer and a flooder under
    10% loss: every honest node reaches the threshold without an adversary
    in its final, and the forgeries failed verification and were
    attributed."""
    roles = {15: "invalid_signer", 14: "invalid_signer", 13: "stale_replayer",
             12: "flooder"}
    Cluster = LocalCluster if pkg == "port" else JLocalCluster

    async def go():
        cluster = Cluster(16, threshold=9, adversaries=roles, loss_rate=0.1)
        cluster.start()
        try:
            return cluster, await cluster.wait_complete_success(30.0)
        finally:
            cluster.stop()

    cluster, res = asyncio.run(go())
    assert len(res) == 12
    for sig in res.values():
        assert sig.cardinality() >= 9
        assert not sig.bitset.get(15) and not sig.bitset.get(14)
    handels = list(cluster.handels.values())
    assert sum(h.proc.sig_verify_failed for h in handels) > 0
    assert sum(h.scorer.reports for h in handels) > 0
    vals = {r: cluster.adversaries[i].values() for i, r in roles.items()}
    assert vals["flooder"]["advFloodedCt"] > 0


def test_invalid_signers_aggregates_fail_on_bn254():
    """Over real BN254 host crypto, an 8-node round with two invalid signers
    completes and their forged signatures fail real pairing checks."""
    async def go():
        cluster = LocalCluster(8, scheme=BN254Scheme(), threshold=5,
                               adversaries={7: "invalid_signer", 6: "invalid_signer"})
        cluster.start()
        try:
            return cluster, await cluster.wait_complete_success(60.0)
        finally:
            cluster.stop()

    cluster, res = asyncio.run(go())
    assert len(res) == 6
    for sig in res.values():
        assert not sig.bitset.get(7) and not sig.bitset.get(6)
    assert sum(h.proc.sig_verify_failed for h in cluster.handels.values()) > 0


def forged_aggregates(scheme, msg: bytes, signer: int, others):
    """The aggregates an invalid signer forwards: its forged signature
    alone, then beside each honest signer of `others` in turn."""
    forged = (padv if isinstance(scheme, BN254Scheme) else jadv).forged_signature(
        scheme.keygen(signer)[0], msg)
    out = [({signer}, forged)]
    for j in others:
        out.append(({signer, j}, forged.combine(scheme.keygen(j)[0].sign(msg))))
    return out


@pytest.mark.parametrize("path", ["node", "service"])
@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_forged_aggregates_in_one_batch_ban_their_signer(pkg, path):
    """32 nodes on BN254 host crypto: node 0 receives 12 content-distinct
    aggregates from the invalid signer 31, the top of its level 5, each over
    the signer's forged signature alone or beside one honest signature. They
    verify in one batch (through the node's own verifier, or through one
    BatchVerifierService without a fallback over a host device), all 12
    fail, and the scorer bans the signer (12 reports over the ban score of
    8); its next packet dies at validation. Same counts in both packages."""
    if pkg == "port":
        from handel_tpu_torch.core.bitset import BitSet
        from handel_tpu_torch.core.config import Config
        from handel_tpu_torch.core.crypto import MultiSignature
        from handel_tpu_torch.core.net import Packet
        from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
        from handel_tpu_torch.service.driver import HostDevice
        Cluster, scheme = LocalCluster, BN254Scheme()
    else:
        from handel_tpu.core.bitset import BitSet
        from handel_tpu.core.config import Config
        from handel_tpu.core.crypto import MultiSignature
        from handel_tpu.core.net import Packet
        from handel_tpu.parallel.batch_verifier import BatchVerifierService
        from handel_tpu.service.driver import HostDevice
        Cluster, scheme = JLocalCluster, JBN254Scheme()
    msg, signer, level = b"hello world", 31, 5
    aggregates = forged_aggregates(scheme, msg, signer, range(16, 27))

    async def go():
        holder = {}

        def factory(i):
            c = Config()
            c.batch_size = 128
            if path == "service":
                async def verify(m, pks, reqs):
                    return await holder["svc"].verify(m, pks, reqs)
                c.verifier = verify
            return c

        cluster = Cluster(32, scheme=scheme, msg=msg, config_factory=factory,
                          adversaries={signer: "invalid_signer"})
        if path == "service":
            holder["svc"] = BatchVerifierService(
                HostDevice(scheme.constructor, batch_size=128), fallback=None)
        h = cluster.handels[0]
        lvl = h.levels[level]
        net = cluster.adversaries[signer].net
        h.proc.start()
        try:
            for members, sig in aggregates:
                bs = BitSet(len(lvl.nodes))
                for i in members:
                    bs.set(h.partitioner.index_at_level(i, level), True)
                net.send([cluster.registry.identity(0)],
                         Packet(origin=signer, level=level,
                                multisig=MultiSignature(bs, sig).marshal()))
            for _ in range(600):
                if h.proc.sig_verify_failed >= len(aggregates):
                    break
                await asyncio.sleep(0.05)
            banned = [i for i in range(32) if h.scorer.banned(i)]
            before = h.banned_packet_ct
            net.send([cluster.registry.identity(0)],
                     Packet(origin=signer, level=level,
                            multisig=MultiSignature(bs, aggregates[0][1]).marshal()))
            await asyncio.sleep(0.05)
            launches = holder["svc"].values()["verifierLaunches"] if holder else None
            return (h.proc.sig_verify_failed, h.proc.sig_checked_ct, banned,
                    h.banned_packet_ct - before, h.scorer.reports, launches)
        finally:
            h.proc.stop()
            if holder:
                holder["svc"].stop()

    failed, checked, banned, dropped, reports, launches = asyncio.run(go())
    assert (failed, checked, banned, dropped, reports) == (12, 12, [signer], 1, 12)
    assert launches == (1.0 if path == "service" else None)
