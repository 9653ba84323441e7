"""The port's fault-injecting transport (handel_tpu_torch/network/chaos.py
`ChaosNetwork`) against the JAX package's, and chaos rounds through the
port's harness and sim.

Each case runs the same seeded sends through both packages' ChaosNetwork
over a recording inner transport. Tolerance: identical — the same drop,
corrupt, duplicate, reorder and delay decisions, in the same order, with
the same corrupted bytes, per link, and the same counters.
"""

import asyncio
import csv
import random

import pytest

from handel_tpu.core.identity import Identity as JIdentity
from handel_tpu.core.net import Packet as JPacket
from handel_tpu.core.test_harness import LocalCluster as JLocalCluster
from handel_tpu.network.chaos import ChaosConfig as JChaosConfig
from handel_tpu.network.chaos import ChaosNetwork as JChaosNetwork
from handel_tpu_torch.core.identity import Identity
from handel_tpu_torch.core.net import Packet
from handel_tpu_torch.core.test_harness import LocalCluster
from handel_tpu_torch.network.chaos import ChaosConfig, ChaosNetwork

PORT = (Identity, Packet, ChaosConfig, ChaosNetwork)
REF = (JIdentity, JPacket, JChaosConfig, JChaosNetwork)

RATES = [
    dict(drop_rate=0.3),
    dict(corrupt_rate=0.5),
    dict(duplicate_rate=0.4, reorder_rate=0.3),
    dict(delay_rate=0.5, delay_ms=5.0, delay_jitter_ms=3.0),
    dict(drop_rate=0.10, corrupt_rate=0.05, duplicate_rate=0.05, reorder_rate=0.1,
         delay_rate=0.1, delay_ms=2.0, delay_jitter_ms=1.0),
]


class RecordingNet:
    """Inner transport: remembers every (address, packet) delivery."""

    def __init__(self):
        self.delivered = []

    def send(self, identities, packet):
        for ident in identities:
            self.delivered.append((ident.address, packet.encode()))

    def register_listener(self, listener):
        pass

    def values(self):
        return {"innerSent": float(len(self.delivered))}


def script(seed: int):
    """Seeded sends: (destination ids, packet fields)."""
    rng = random.Random(seed)
    out = []
    for _ in range(96):
        dests = rng.sample(range(6), rng.randrange(1, 4))
        ind = rng.randbytes(32) if rng.random() < 0.5 else None
        out.append((dests, dict(origin=rng.randrange(64), level=rng.randrange(1, 7),
                                multisig=rng.randbytes(rng.randrange(0, 96)),
                                individual_sig=ind, sent_ts=1.7e9 + rng.random())))
    return out


def run_chaos(pkg, rates: dict, seed: int, node: int, in_loop: bool):
    """The deliveries and counters of one node's ChaosNetwork over the
    script: with a running loop (delays and held packets wait on timers),
    or without one (they deliver at once, as the reference does)."""
    Ident, Pkt, Cfg, Net = pkg
    inner = RecordingNet()
    net = Net(inner, Cfg(seed=seed, **rates).for_node(node))
    idents = [Ident(i, f"127.0.0.1:{9000 + i}", None) for i in range(6)]

    def send_all():
        for dests, fields in script(seed):
            net.send([idents[d] for d in dests], Pkt(**fields))

    if in_loop:
        async def go():
            send_all()
            await asyncio.sleep(0.1)  # past every delay and reorder flush
            net.stop()

        asyncio.run(go())
    else:
        send_all()
        net.stop()
    hist = net.histograms()["delayMs"]
    return inner.delivered, net.values(), (hist.count, hist.sum, hist.counts)


@pytest.mark.parametrize("rates", RATES, ids=lambda r: "+".join(sorted(r)))
@pytest.mark.parametrize("seed, node", [(99, 0), (99, 17), (7, 3)])
def test_same_seed_same_faults_without_a_loop(rates, seed, node):
    ours = run_chaos(PORT, rates, seed, node, in_loop=False)
    assert ours == run_chaos(REF, rates, seed, node, in_loop=False)


@pytest.mark.parametrize("rates", [RATES[0], RATES[1], RATES[2]],
                         ids=lambda r: "+".join(sorted(r)))
def test_same_seed_same_faults_in_a_loop(rates):
    """Drops, corruptions, duplicates and reorders in a running loop: the
    same deliveries in the same order (no delays here, whose timers would
    interleave by wall time)."""
    ours = run_chaos(PORT, rates, 5, 2, in_loop=True)
    assert ours == run_chaos(REF, rates, 5, 2, in_loop=True)


def test_corrupted_bytes_are_the_references_per_link():
    delivered, vals, _ = run_chaos(PORT, dict(corrupt_rate=1.0), 11, 4, in_loop=False)
    ref_delivered, ref_vals, _ = run_chaos(REF, dict(corrupt_rate=1.0), 11, 4, in_loop=False)
    assert delivered == ref_delivered and vals == ref_vals
    sent = [Packet(**f).encode() for dests, f in script(11) for _ in dests]
    # every delivery with a payload was corrupted
    assert sum(1 for (_, wire), s in zip(delivered, sent) if wire != s) == vals["chaosCorrupted"]


def test_config_validation_and_node_seeds():
    for bad in (dict(drop_rate=1.5), dict(corrupt_rate=-0.1)):
        with pytest.raises(ValueError):
            ChaosConfig(**bad).validate()
        with pytest.raises(ValueError):
            JChaosConfig(**bad).validate()
    assert ChaosConfig(seed=99).for_node(5).seed == JChaosConfig(seed=99).for_node(5).seed
    assert not ChaosConfig().any() and ChaosConfig(delay_rate=0.1).any()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_chaos_cluster_reaches_threshold(pkg):
    """A 16-node in-process round under seeded loss, corruption and
    duplication reaches the threshold in both packages, with the chaos
    counters moving."""
    Cluster, Cfg = (LocalCluster, ChaosConfig) if pkg == "port" else (JLocalCluster, JChaosConfig)
    chaos = Cfg(drop_rate=0.10, corrupt_rate=0.05, duplicate_rate=0.05, seed=99)

    async def go():
        cluster = Cluster(16, chaos=chaos, threshold=9)
        cluster.start()
        try:
            return cluster, await cluster.wait_complete_success(30.0)
        finally:
            cluster.stop()

    cluster, res = asyncio.run(go())
    assert len(res) == 16 and all(s.cardinality() >= 9 for s in res.values())
    dropped = sum(h.net.values()["chaosDropped"] for h in cluster.handels.values())
    assert dropped > 0


def test_loss_rate_drops_routed_packets():
    async def go():
        cluster = LocalCluster(8, loss_rate=0.2, threshold=5)
        cluster.start()
        try:
            return cluster, await cluster.wait_complete_success(30.0)
        finally:
            cluster.stop()

    cluster, res = asyncio.run(go())
    assert len(res) == 8
    assert cluster.router.values()["sentPackets"] > 0


@pytest.mark.slow
def test_adversarial_sweep_64_nodes_on_bn254(tmp_path):
    """The reference's 64-node adversarial sweep on the port's sim with real
    BN254 host crypto: mixed roles, loss, corruption and duplication, every
    honest node at the threshold, the forgeries rejected."""
    from handel_tpu_torch.sim.config import (
        AdversaryParams,
        HandelParams,
        RunConfig,
        SimConfig,
    )
    from handel_tpu_torch.sim.platform import run_simulation

    cfg = SimConfig(
        network="udp", scheme="bn254", max_timeout_s=300.0,
        chaos=ChaosConfig(drop_rate=0.10, corrupt_rate=0.05, duplicate_rate=0.05, seed=1234),
        runs=[RunConfig(nodes=64, threshold=33, processes=4,
                        adversaries=AdversaryParams(invalid_signer=4, stale_replayer=2,
                                                    flooder=1, flood_pps=100.0),
                        handel=HandelParams(period_ms=50.0, timeout_ms=100.0))],
    )
    (res,) = asyncio.run(run_simulation(cfg, str(tmp_path)))
    assert res.ok, [e.decode(errors="replace")[-2000:] for _, e in res.outputs]
    row = next(csv.DictReader(open(res.csv_path)))
    assert float(row["adversaries"]) == 7.0
    assert float(row["net_chaosCorrupted_sum"]) > 0
    assert float(row["sigs_sigVerifyFailed_sum"]) > 0
