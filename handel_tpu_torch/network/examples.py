"""Minimal multi-peer transport demo — a copy of
handel_tpu/network/examples.py.

Reference: network/examples/start.go:35-85 + its README — three peers load a
CSV registry, bind their transport, and exchange a hello packet with every
other peer. Here each peer is an asyncio task in one process binding a real
socket, so the demo doubles as a live check of the transport stack:

    python -m handel_tpu_torch.network.examples [n_peers] [udp|tcp]
"""

from __future__ import annotations

import asyncio
import os
import sys
import tempfile

from handel_tpu_torch.core.net import Packet
from handel_tpu_torch.sim.keys import (
    generate_nodes,
    read_registry_csv,
    registry_from_records,
    write_registry_csv,
)
from handel_tpu_torch.sim.platform import free_ports


def _make_network(kind: str, addr: str):
    if kind == "udp":
        from handel_tpu_torch.network.udp import UDPNetwork

        return UDPNetwork(addr)
    if kind == "tcp":
        from handel_tpu_torch.network.tcp import TCPNetwork

        return TCPNetwork(addr)
    raise ValueError(f"unknown transport {kind!r}")


class _Collector:
    """Listener counting hello packets from distinct origins."""

    def __init__(self, expect: int):
        self.origins: set[int] = set()
        self.done = asyncio.Event()
        self.expect = expect

    def new_packet(self, packet: Packet) -> None:
        self.origins.add(packet.origin)
        if len(self.origins) >= self.expect:
            self.done.set()


async def run_demo(n_peers: int = 3, kind: str = "udp", timeout: float = 10.0):
    """Returns {peer_id: set of origins heard from}. Raises on timeout."""
    from handel_tpu_torch.models.registry import new_scheme

    ports = free_ports(n_peers)
    addresses = [f"127.0.0.1:{p}" for p in ports]
    # round-trip the registry through CSV like the reference demo does
    scheme = new_scheme("fake")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "registry.csv")
        write_registry_csv(path, generate_nodes(scheme, addresses))
        registry = registry_from_records(read_registry_csv(path), scheme)

    nets, collectors = [], []
    peers = [registry.identity(i) for i in range(n_peers)]
    try:
        for i in range(n_peers):
            net = _make_network(kind, addresses[i])
            col = _Collector(expect=n_peers - 1)
            net.register_listener(col)
            await net.start()
            nets.append(net)
            collectors.append(col)
        # datagrams can race the receiving endpoints; resend until heard
        # (wait_for, not asyncio.timeout: the latter is 3.11-only and this
        # module is the last thing keeping the package off 3.10)
        async def resend_until_heard():
            while not all(c.done.is_set() for c in collectors):
                for i, (net, col) in enumerate(zip(nets, collectors)):
                    if not col.done.is_set():
                        others = [p for j, p in enumerate(peers) if j != i]
                        net.send(others, Packet(origin=i, level=1, multisig=b"hello"))
                await asyncio.sleep(0.05)

        await asyncio.wait_for(resend_until_heard(), timeout)
    finally:
        for net in nets:
            net.stop()
        await asyncio.sleep(0)
    return {i: col.origins for i, col in enumerate(collectors)}


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    kind = sys.argv[2] if len(sys.argv) > 2 else "udp"
    heard = asyncio.run(run_demo(n, kind))
    for i, origins in heard.items():
        print(f"peer {i}: heard from {sorted(origins)}")


if __name__ == "__main__":
    main()
