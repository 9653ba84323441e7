"""TCP transport with connection caching — a copy of
handel_tpu/network/tcp.py.

Reference: network/tcp/net.go:16-127 — a listener accepting length-delimited
packet streams, lazy dial-on-send with a per-peer connection cache, and a
1-minute idle deadline.

asyncio redesign: an asyncio.Server per node; outbound connections are cached
per peer as Sessions behind the shared SessionManager (network/stream.py),
which also dedups concurrent dials to a not-yet-connected peer — the same
machinery the TLS transport uses, with a plain-TCP dialer plugged into the
dialer seam. Framing/read-loop/task bookkeeping also live in stream.py.
"""

from __future__ import annotations

import asyncio
from typing import Sequence

from handel_tpu_torch.core.logging import DEFAULT_LOGGER, Logger
from handel_tpu_torch.core.net import Listener, Packet
from handel_tpu_torch.network.encoding import Encoding, BinaryEncoding
from handel_tpu_torch.network.stream import (
    Session,
    SessionManager,
    TaskSet,
    frame,
    read_frames,
)
from handel_tpu_torch.network.udp import split_addr


class TCPNetwork:
    """Stream-based Network with cached outbound connections."""

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
        self._server: asyncio.Server | None = None
        self.sessions = SessionManager(self._dial)
        self._tasks = TaskSet()
        self.sent = 0
        self.rcvd = 0

    async def start(self) -> None:
        host, port = split_addr(self.listen_addr)
        self._server = await asyncio.start_server(
            self._handle_conn, "0.0.0.0", port
        )

    def stop(self) -> None:
        if self._server:
            self._server.close()
        self._tasks.cancel_all()
        self.sessions.close_all()

    async def _dial(self, addr: str) -> Session:
        host, port = split_addr(addr)
        _, writer = await asyncio.open_connection(host, port)
        return Session(writer)

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        def count():
            self.rcvd += 1

        try:
            await read_frames(
                reader, self.enc, self.listeners, self.log, "tcp", count
            )
        finally:
            writer.close()

    def send(self, identities: Sequence["Identity"], packet: Packet) -> None:  # noqa: F821
        framed = frame(self.enc.encode(packet))
        for ident in identities:
            self._tasks.spawn(self._send_to(ident.address, framed))

    async def _send_to(self, addr: str, framed: bytes) -> None:
        try:
            ses = await self.sessions.session(addr)
            ses.writer.write(framed)
            await ses.writer.drain()
            self.sent += 1
        except OSError as e:
            self.log.warn("tcp_send", f"{addr}: {e}")
            self.sessions.drop(addr)

    def register_listener(self, listener: Listener) -> None:
        self.listeners.append(listener)

    def values(self) -> dict[str, float]:
        out = {"sentPackets": float(self.sent), "rcvdPackets": float(self.rcvd)}
        if hasattr(self.enc, "values"):
            out.update(self.enc.values())
        return out
