"""In-memory packet router for co-resident virtual nodes, UDP across hosts —
a copy of handel_tpu/swarm/router.py.

At swarm scale most traffic is *local* — contiguous ID
blocks live in one process, and Handel's low levels (the bulk of packet
volume: level L has 2^(L-1) candidates, so half of all candidate slots sit
in the two lowest levels) stay entirely inside the block. The router
short-circuits those deliveries: one immutable `Packet` object is handed to
every co-resident recipient via `loop.call_soon` — no encode, no decode, no
socket. Only packets whose recipient lives in another process take the wire,
as one datagram per recipient prefixed with a 4-byte recipient id (every
process's vnodes share ONE socket, so the prefix is the demux key the
per-node UDP transport got from its port).

`Packet` instances are safe to share: `Handel.new_packet` only reads the
fields and unmarshals fresh objects from the payload bytes (core/net.py,
core/handel.py) — nothing mutates a delivered packet.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Sequence

from handel_tpu_torch.core.identity import Identity
from handel_tpu_torch.core.net import Listener, Packet

# cross-process frame: recipient vnode id, then the normal Packet encoding
_FRAME = struct.Struct(">I")


class _SwarmProto(asyncio.DatagramProtocol):
    def __init__(self, router: "SwarmRouter"):
        self.router = router

    def connection_made(self, transport):
        self.router._transport = transport

    def datagram_received(self, data: bytes, addr) -> None:
        self.router._on_datagram(data)


class SwarmRouter:
    """One per process: local short-circuit + shared-socket UDP fallback.

    `owner_of(node_id)` maps a global id to the process that hosts it —
    contiguous blocks of `block` ids per process index, the same split the
    driver uses to build vnodes — and `ports[pindex]` is that process's
    shared UDP port on localhost (multi-host runs would carry (host, port)
    pairs; the frame format doesn't change).
    """

    def __init__(
        self,
        block: int,
        ports: Sequence[int] | None = None,
        host: str = "127.0.0.1",
    ):
        self.block = max(1, block)
        self.ports = list(ports or [])
        self.host = host
        self.local: dict[int, Listener] = {}
        self._transport = None
        # telemetry plane
        self.local_delivered = 0
        self.udp_sent = 0
        self.udp_rcvd = 0
        self.udp_bytes_sent = 0
        self.udp_rcvd_bad = 0  # truncated/undecodable frames (dropped)
        self.unknown_recipient = 0

    # -- lifecycle ---------------------------------------------------------

    async def open(self, port: int) -> None:
        """Bind the process's shared socket. Single-process swarms (every
        recipient local) can skip this entirely."""
        loop = asyncio.get_running_loop()
        await loop.create_datagram_endpoint(
            lambda: _SwarmProto(self), local_addr=("0.0.0.0", port)
        )

    def close(self) -> None:
        if self._transport is not None:
            self._transport.close()
            self._transport = None

    # -- registration ------------------------------------------------------

    def register(self, node_id: int, listener: Listener) -> None:
        self.local[int(node_id)] = listener

    def owner_of(self, node_id: int) -> int:
        return node_id // self.block

    # -- delivery ----------------------------------------------------------

    def route(self, identities: Sequence[Identity], packet: Packet) -> None:
        loop = asyncio.get_running_loop()
        wire = None
        for ident in identities:
            nid = ident.id
            lst = self.local.get(nid)
            if lst is not None:
                # shared-object fast path: same Packet for every local
                # recipient, delivered on the next loop turn like a datagram
                self.local_delivered += 1
                loop.call_soon(lst.new_packet, packet)
                continue
            pindex = self.owner_of(nid)
            if pindex >= len(self.ports) or self._transport is None:
                # a recipient nobody hosts (mid-teardown, bad registry) is
                # dropped and counted, never an exception on the send path
                self.unknown_recipient += 1
                continue
            if wire is None:
                wire = packet.encode()  # encode once per route() call
            self.udp_sent += 1
            self.udp_bytes_sent += _FRAME.size + len(wire)
            self._transport.sendto(
                _FRAME.pack(nid) + wire, (self.host, self.ports[pindex])
            )

    def _on_datagram(self, data: bytes) -> None:
        if len(data) <= _FRAME.size:
            self.udp_rcvd_bad += 1
            return
        (nid,) = _FRAME.unpack_from(data)
        lst = self.local.get(nid)
        if lst is None:
            self.unknown_recipient += 1
            return
        try:
            pkt = Packet.decode(data[_FRAME.size:])
        except ValueError:
            self.udp_rcvd_bad += 1
            return
        self.udp_rcvd += 1
        lst.new_packet(pkt)

    # -- reporting ---------------------------------------------------------

    def values(self) -> dict[str, float]:
        return {
            "swarmLocalDelivered": float(self.local_delivered),
            "swarmUdpSent": float(self.udp_sent),
            "swarmUdpRcvd": float(self.udp_rcvd),
            "swarmUdpBytesSent": float(self.udp_bytes_sent),
            "swarmUdpRcvdBad": float(self.udp_rcvd_bad),
            "swarmUnknownRecipient": float(self.unknown_recipient),
        }


class SwarmNetwork:
    """Per-vnode `Network` facade over the shared router (core/net.py
    contract: Handel calls `register_listener(self)` with no id, so the
    facade carries it)."""

    __slots__ = ("router", "node_id")

    def __init__(self, router: SwarmRouter, node_id: int):
        self.router = router
        self.node_id = node_id

    def send(self, identities: Sequence[Identity], packet: Packet) -> None:
        self.router.route(identities, packet)

    def register_listener(self, listener: Listener) -> None:
        self.router.register(self.node_id, listener)
