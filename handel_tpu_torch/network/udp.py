"""UDP transport, the default protocol-plane network — a copy of
handel_tpu/network/udp.py.

Reference: network/udp/net.go:19-226 — bind on 0.0.0.0:port, fire-and-forget
send to each peer, an inbound pipeline that decouples the socket from packet
handling (20000-slot queue + pending list + dispatch loop, :148-209), and
sent/rcvd packet counters for the monitor (:212-226).

asyncio redesign: one DatagramProtocol endpoint per node; the kernel socket
feeds a bounded asyncio.Queue (drop-on-overflow, like the reference's select
with a full newPacket channel) drained by a dispatch task that decodes and
fans out to listeners. Everything runs on the node's event loop — no locks.

Identity addresses are "host:port" strings (simul/lib CSV registry format).
"""

from __future__ import annotations

import asyncio
from typing import Sequence

from handel_tpu_torch.core.logging import DEFAULT_LOGGER, Logger
from handel_tpu_torch.core.net import Listener, Packet
from handel_tpu_torch.core.report import WarnOnce
from handel_tpu_torch.network.encoding import Encoding, BinaryEncoding

QUEUE_SIZE = 20_000  # inbound buffer slots (udp/net.go:33)


def split_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


class _Proto(asyncio.DatagramProtocol):
    def __init__(self, net: "UDPNetwork"):
        self.net = net

    def datagram_received(self, data: bytes, addr) -> None:
        self.net._enqueue(data)

    def error_received(self, exc) -> None:
        # ICMP errors (port unreachable etc.) stay fire-and-forget for the
        # protocol, but silently discarding them hid dead peers from every
        # stall diagnosis — count them on the monitor plane and warn once
        self.net._icmp_error(exc)


class UDPNetwork:
    """Datagram Network bound to a local port (udp/net.go:19-226)."""

    def __init__(
        self,
        listen_addr: str,
        encoding: Encoding | None = None,
        logger: Logger = DEFAULT_LOGGER,
    ):
        self.listen_addr = listen_addr
        self.enc = encoding or BinaryEncoding()
        self.log = logger
        self.listeners: list[Listener] = []
        self._queue: asyncio.Queue[bytes] = asyncio.Queue(QUEUE_SIZE)
        self._transport: asyncio.DatagramTransport | None = None
        self._dispatch_task: asyncio.Task | None = None
        self.sent = 0  # packets out (udp/net.go:212-226)
        self.rcvd = 0  # packets dispatched to listeners
        self.dropped = 0  # queue-full drops
        self.icmp_errors = 0  # error_received callbacks (ICMP unreachable)
        self.decode_errors = 0  # malformed datagrams rejected by the codec
        # warn-once per reason + the logWarnCt counter (core/report.py): a
        # dead peer or flooder fires thousands of identical warnings
        self._warn = WarnOnce(self.log)

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        host, port = split_addr(self.listen_addr)
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _Proto(self), local_addr=("0.0.0.0", port)
        )
        self._dispatch_task = loop.create_task(self._dispatch_loop())

    def stop(self) -> None:
        if self._dispatch_task:
            self._dispatch_task.cancel()
        if self._transport:
            self._transport.close()

    # -- outbound -----------------------------------------------------------

    def send(self, identities: Sequence["Identity"], packet: Packet) -> None:  # noqa: F821
        if self._transport is None:
            raise RuntimeError("UDPNetwork not started")
        wire = self.enc.encode(packet)
        for ident in identities:
            try:
                self._transport.sendto(wire, split_addr(ident.address))
                self.sent += 1
            except OSError as e:  # unreachable peer: datagrams just vanish
                self._warn.warn("udp_send", f"{ident.address}: {e}")

    # -- inbound pipeline ---------------------------------------------------

    def _icmp_error(self, exc) -> None:
        self.icmp_errors += 1
        self._warn.warn("udp_icmp", f"{self.listen_addr}: {exc}")

    def _enqueue(self, data: bytes) -> None:
        try:
            self._queue.put_nowait(data)
        except asyncio.QueueFull:  # drop, like the reference's full channel
            self.dropped += 1
            self._warn.warn(
                "udp_queue_full",
                f"{self.listen_addr}: dropping inbound datagrams",
            )

    async def _dispatch_loop(self) -> None:
        while True:
            data = await self._queue.get()
            try:
                packet = self.enc.decode(data)
            except Exception as e:  # malformed datagram: count and move on
                self.decode_errors += 1
                self._warn.warn("udp_decode", e)
                continue
            self.rcvd += 1
            for lst in self.listeners:
                lst.new_packet(packet)

    def register_listener(self, listener: Listener) -> None:
        self.listeners.append(listener)

    # -- reporter (udp/net.go:212-226) --------------------------------------

    def values(self) -> dict[str, float]:
        out = {
            "sentPackets": float(self.sent),
            "rcvdPackets": float(self.rcvd),
            "droppedPackets": float(self.dropped),
            "icmpErrors": float(self.icmp_errors),
            "decodeErrors": float(self.decode_errors),
            **self._warn.values(),
        }
        if hasattr(self.enc, "values"):
            out.update(self.enc.values())
        return out
