"""Pluggable wire codecs + the byte-counting decorator — a copy of
handel_tpu/network/encoding.py.

Reference: network/wireencoding.go:10-13 (`Encoding` interface), the gob codec
(network/gobEncoding.go:10-32) — replaced by the fixed binary layout from
core/net.py (language-neutral, constant-time parse) — and the monitor-facing
byte counter (network/counter_encoding.go:13-63).
"""

from __future__ import annotations

from typing import Protocol

from handel_tpu_torch.core.net import Packet


class Encoding(Protocol):
    """Packet <-> bytes codec (wireencoding.go:10-13)."""

    def encode(self, packet: Packet) -> bytes: ...

    def decode(self, data: bytes) -> Packet: ...


class BinaryEncoding:
    """The default fixed-layout codec (core/net.py Packet.encode/decode)."""

    def encode(self, packet: Packet) -> bytes:
        return packet.encode()

    def decode(self, data: bytes) -> Packet:
        return Packet.decode(data)


class CounterEncoding:
    """Decorator counting encoded/decoded bytes for the monitor plane
    (counter_encoding.go:13-63). Exposes `values()` in the Reporter shape."""

    def __init__(self, inner: Encoding | None = None):
        self.inner = inner or BinaryEncoding()
        self.sent_bytes = 0
        self.rcvd_bytes = 0

    def encode(self, packet: Packet) -> bytes:
        data = self.inner.encode(packet)
        self.sent_bytes += len(data)
        return data

    def decode(self, data: bytes) -> Packet:
        packet = self.inner.decode(data)
        self.rcvd_bytes += len(data)
        return packet

    def values(self) -> dict[str, float]:
        return {
            "sentBytes": float(self.sent_bytes),
            "rcvdBytes": float(self.rcvd_bytes),
        }
