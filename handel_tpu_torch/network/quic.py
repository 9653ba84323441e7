"""Secure session transport — the QUIC slot of the transport matrix; a copy
of handel_tpu/network/quic.py.

Reference: network/quic/net.go:22-139 (session-per-peer transport with a TLS
config), sessionmanager.go:11-93 (session cache + dedup of concurrent dials
to the same peer via an isWaiting set), dialer.go (pluggable dialer), and
config.go:14-71 (`NewInsecureTestConfig` — self-signed cert, verification
skipped).

No QUIC stack is available in this environment, so the same component is
built on TLS-over-TCP: what the reference gets from QUIC (an authenticated,
encrypted, session-oriented channel with cheap per-peer session reuse) maps
to cached TLS streams; the session manager, dialer seam, and insecure test
config are ported semantically. Packets are length-prefixed on the stream
like network/tcp.py.

The insecure test config needs the `cryptography` package, imported only
when a `QUICNetwork` is built without contexts of its own: where it is
missing, that raises an ImportError naming it.
"""

from __future__ import annotations

import asyncio
import os
import ssl
import tempfile
from typing import Callable, Sequence

from handel_tpu_torch.core.logging import DEFAULT_LOGGER, Logger
from handel_tpu_torch.core.net import Listener, Packet
from handel_tpu_torch.network.encoding import BinaryEncoding, Encoding
from handel_tpu_torch.network.stream import (
    Session,
    SessionManager,
    TaskSet,
    frame,
    read_frames,
)
from handel_tpu_torch.network.udp import split_addr

# back-compat aliases: the session machinery moved to network/stream.py so
# the TCP transport can share it
_Session = Session


def new_insecure_test_config() -> tuple[ssl.SSLContext, ssl.SSLContext]:
    """(server_ctx, client_ctx) with a fresh self-signed certificate and
    client verification disabled (quic/config.go:14-71
    `NewInsecureTestConfig`). Test/simulation use only."""
    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID
    except ImportError as e:
        raise ImportError(
            'network = "quic" needs the `cryptography` package for its '
            "self-signed test certificate (or pass server_ctx/client_ctx)"
        ) from e
    import datetime

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "handel-tpu")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=1))
        .sign(key, hashes.SHA256())
    )
    with tempfile.NamedTemporaryFile(suffix=".pem", delete=False) as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
        f.write(
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption(),
            )
        )
        path = f.name
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    try:
        server_ctx.load_cert_chain(path)
    finally:
        os.unlink(path)  # key material must not linger on disk
    client_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    client_ctx.check_hostname = False
    client_ctx.verify_mode = ssl.CERT_NONE
    return server_ctx, client_ctx


class QUICNetwork:
    """Session-oriented secure Network (network/quic/net.go:22-139).

    `server_ctx`/`client_ctx` default to the insecure test config; pass real
    SSL contexts for deployment."""

    def __init__(
        self,
        listen_addr: str,
        encoding: Encoding | None = None,
        logger: Logger = DEFAULT_LOGGER,
        server_ctx: ssl.SSLContext | None = None,
        client_ctx: ssl.SSLContext | None = None,
    ):
        self.listen_addr = listen_addr
        self.enc = encoding or BinaryEncoding()
        self.log = logger
        self.listeners: list[Listener] = []
        if server_ctx is None or client_ctx is None:
            server_ctx, client_ctx = new_insecure_test_config()
        self._server_ctx = server_ctx
        self._client_ctx = client_ctx
        self._server: asyncio.Server | None = None
        self.sessions = SessionManager(self._dial)
        self._tasks = TaskSet()
        self.sent = 0
        self.rcvd = 0

    async def start(self) -> None:
        host, port = split_addr(self.listen_addr)
        self._server = await asyncio.start_server(
            self._handle_conn, "0.0.0.0", port, ssl=self._server_ctx
        )

    def stop(self) -> None:
        if self._server:
            self._server.close()
        self._tasks.cancel_all()
        self.sessions.close_all()

    # -- dialer seam (quic/dialer.go) ---------------------------------------

    async def _dial(self, addr: str) -> _Session:
        host, port = split_addr(addr)
        _, writer = await asyncio.open_connection(
            host, port, ssl=self._client_ctx
        )
        return Session(writer)

    # -- inbound ------------------------------------------------------------

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        def count():
            self.rcvd += 1

        try:
            await read_frames(
                reader, self.enc, self.listeners, self.log, "quic", count
            )
        finally:
            writer.close()

    # -- outbound -----------------------------------------------------------

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
        except (OSError, ssl.SSLError) as e:
            self.log.warn("quic_send", f"{addr}: {e}")
            self.sessions.drop(addr)

    def register_listener(self, listener: Listener) -> None:
        self.listeners.append(listener)

    def values(self) -> dict[str, float]:
        out = {"sentPackets": float(self.sent), "rcvdPackets": float(self.rcvd)}
        if hasattr(self.enc, "values"):
            out.update(self.enc.values())
        return out
