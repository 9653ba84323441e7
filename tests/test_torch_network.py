"""The port's transports (handel_tpu_torch/network/) against the JAX
package's (handel_tpu/network/): the same packets give the same wire bytes
through both codecs and byte counters, and a port transport and a reference
transport exchange packets both ways over real localhost sockets, UDP and
TCP, with the same counters on each side.
"""

import asyncio

import numpy as np
import pytest

from handel_tpu.core.identity import Identity as RIdentity
from handel_tpu.core.net import Packet as RPacket
from handel_tpu.network import encoding as renc
from handel_tpu.network.tcp import TCPNetwork as RTCP
from handel_tpu.network.udp import UDPNetwork as RUDP
from handel_tpu_torch.core.identity import Identity as PIdentity
from handel_tpu_torch.core.net import Packet as PPacket
from handel_tpu_torch.network import encoding as penc
from handel_tpu_torch.network.tcp import TCPNetwork as PTCP
from handel_tpu_torch.network.udp import UDPNetwork as PUDP
from handel_tpu_torch.sim.platform import free_ports


def packet_fields(seed: int) -> list[dict]:
    """Seeded packets: random ids, levels and payloads, with and without an
    individual signature, a send stamp and a trace trailer."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(6):
        out.append(dict(
            origin=int(rng.integers(0, 1 << 20)),
            level=int(rng.integers(0, 32)),
            multisig=rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes(),
            individual_sig=(
                rng.integers(0, 256, 64, dtype=np.uint8).tobytes() if k % 2 else None
            ),
            sent_ts=float(rng.uniform(0, 2e9)) if k % 3 else 0.0,
            span_id=int(rng.integers(1, 1 << 62)) if k == 5 else 0,
            hop=1 if k == 5 else 0,
        ))
    return out


def fields_of(p) -> tuple:
    return (p.origin, p.level, p.multisig, p.individual_sig, p.sent_ts, p.span_id, p.hop)


@pytest.mark.parametrize("seed", range(4))
def test_encodings_give_the_same_bytes_and_counts(seed):
    rc, pc = renc.CounterEncoding(), penc.CounterEncoding()
    rb, pb = renc.BinaryEncoding(), penc.BinaryEncoding()
    for f in packet_fields(seed):
        rp, pp = RPacket(**f), PPacket(**f)
        wire = rb.encode(rp)
        assert pb.encode(pp) == wire
        assert rc.encode(rp) == pc.encode(pp) == wire
        # each side decodes the other's bytes to the same packet
        assert fields_of(pc.decode(wire)) == fields_of(rc.decode(wire)) == fields_of(pp)
    assert pc.values() == rc.values()
    assert pc.values()["sentBytes"] > 0


def test_counter_encoding_wraps_any_codec_and_counts_failed_decodes_as_not_received():
    for mod in (renc, penc):
        c = mod.CounterEncoding()
        with pytest.raises(ValueError):
            c.decode(b"\x00\x01")
        assert c.values() == {"sentBytes": 0.0, "rcvdBytes": 0.0}


class Collect:
    def __init__(self):
        self.got = []

    def new_packet(self, packet):
        self.got.append(packet)


async def exchange(port_cls, ref_cls, seed: int):
    """A port transport and a reference transport send each other the same
    packets; returns what each received and both counter maps."""
    pa, ra = (f"127.0.0.1:{p}" for p in free_ports(2))
    pnet = port_cls(pa, encoding=penc.CounterEncoding())
    rnet = ref_cls(ra, encoding=renc.CounterEncoding())
    pl, rl = Collect(), Collect()
    pnet.register_listener(pl)
    rnet.register_listener(rl)
    await pnet.start()
    await rnet.start()
    try:
        fields = packet_fields(seed)
        for f in fields:
            pnet.send([PIdentity(1, ra, None)], PPacket(**f))
            rnet.send([RIdentity(0, pa, None)], RPacket(**f))
        for _ in range(200):
            if len(pl.got) == len(rl.got) == len(fields):
                break
            await asyncio.sleep(0.01)
        return fields, pl.got, rl.got, pnet.values(), rnet.values()
    finally:
        pnet.stop()
        rnet.stop()


@pytest.mark.parametrize(
    "port_cls, ref_cls", [(PUDP, RUDP), (PTCP, RTCP)], ids=["udp", "tcp"]
)
def test_port_and_reference_transports_exchange_both_ways(port_cls, ref_cls):
    fields, port_got, ref_got, pvals, rvals = asyncio.run(exchange(port_cls, ref_cls, 7))
    key = lambda p: (p.origin, p.level, p.multisig)  # noqa: E731
    want = sorted(fields_of(PPacket(**f)) for f in fields)
    # loopback delivers every packet; UDP may reorder, so compare as sets
    assert sorted(map(fields_of, port_got)) == want
    assert sorted(map(fields_of, ref_got)) == want
    assert sorted(map(key, port_got)) == sorted(map(key, ref_got))
    assert set(pvals) == set(rvals)
    for k in ("sentPackets", "rcvdPackets", "sentBytes", "rcvdBytes"):
        assert pvals[k] == rvals[k], k
    assert pvals["sentPackets"] == len(fields)


def test_udp_counts_malformed_datagrams_as_the_reference_does():
    async def go(cls):
        (a,) = free_ports(1)
        net = cls(f"127.0.0.1:{a}")
        lst = Collect()
        net.register_listener(lst)
        await net.start()
        try:
            net._transport.sendto(b"\x01\x02\x03", ("127.0.0.1", a))
            net._transport.sendto(PPacket(3, 1, b"ms").encode(), ("127.0.0.1", a))
            for _ in range(200):
                if net.values()["rcvdPackets"] + net.values()["decodeErrors"] >= 2:
                    break
                await asyncio.sleep(0.01)
            return net.values(), [fields_of(p) for p in lst.got]
        finally:
            net.stop()

    pv, pgot = asyncio.run(go(PUDP))
    rv, rgot = asyncio.run(go(RUDP))
    assert pv == rv
    assert pv["decodeErrors"] == 1 and pv["rcvdPackets"] == 1
    assert pgot == rgot


def test_udp_send_before_start_raises_in_both():
    for cls, ident in ((PUDP, PIdentity), (RUDP, RIdentity)):
        net = cls("127.0.0.1:1")
        with pytest.raises(RuntimeError, match="not started"):
            net.send([ident(0, "127.0.0.1:2", None)], PPacket(0, 0, b""))
