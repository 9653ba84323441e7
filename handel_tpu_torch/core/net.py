"""Network abstraction: packets, transports, listeners — a copy of
handel_tpu/core/net.py, with the same bytes on the wire.

Reference: net.go:6-44 — `Network` (Send/RegisterListener), `Listener`
(NewPacket), and `Packet{Origin int32, Level byte, MultiSig, IndividualSig}`.

The wire codec is a fixed binary layout (length-prefixed fields) rather
than the reference's gob encoding (network/gobEncoding.go:10-32). The port's
only transport so far is the in-process router (core/test_harness.py).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import Protocol, Sequence, runtime_checkable

from handel_tpu_torch.core.identity import Identity


@dataclass
class Packet:
    """One protocol datagram (net.go:24-44).

    `sent_ts` is the sender's epoch-seconds send timestamp (core/trace.py
    trace clock); 0.0 means "not stamped".

    `span_id`/`hop` are the trace context of a sender that traces its
    packets (the JAX package's flight recorder): a flow-event id and a flag
    marking the multisig as an aggregate that rode earlier hops. They
    travel as an OPTIONAL 9-byte trailer after the payloads, which the port
    decodes and re-encodes byte for byte but never sets itself. A packet
    without one (or with a truncated one) decodes as "unlinked"
    (`span_id=0, hop=0`), never as an error.
    """

    origin: int  # global id of the sender
    level: int  # level this packet's multisig belongs to
    multisig: bytes  # marshaled MultiSignature
    individual_sig: bytes | None = None  # optional marshaled individual sig
    sent_ts: float = 0.0  # sender trace-clock timestamp (0 = unstamped)
    span_id: int = 0  # sender flow-link id (0 = unlinked)
    hop: int = 0  # 1 = aggregate carries earlier hops' contributions

    # origin, level, len(multisig), len(indiv), sent_ts
    _HDR = struct.Struct(">iBHHd")
    # optional trace-context trailer: span id, hop flag
    _TRAILER = struct.Struct(">QB")

    def encode(self) -> bytes:
        ind = self.individual_sig or b""
        wire = (
            self._HDR.pack(
                self.origin, self.level, len(self.multisig), len(ind), self.sent_ts
            )
            + self.multisig
            + ind
        )
        if self.span_id or self.hop:
            wire += self._TRAILER.pack(
                self.span_id & 0xFFFFFFFFFFFFFFFF, 1 if self.hop else 0
            )
        return wire

    @classmethod
    def decode(cls, data: bytes) -> "Packet":
        if len(data) < cls._HDR.size:
            raise ValueError("packet too short")
        origin, level, ms_len, ind_len, sent_ts = cls._HDR.unpack_from(data)
        off = cls._HDR.size
        if len(data) < off + ms_len + ind_len:
            raise ValueError("packet truncated")
        ms = data[off : off + ms_len]
        ind = data[off + ms_len : off + ms_len + ind_len] if ind_len else None
        if not math.isfinite(sent_ts) or sent_ts < 0.0:
            sent_ts = 0.0  # corrupt stamps degrade to "unstamped", never NaN
        # optional trace-context trailer: anything shorter than the full 9
        # bytes (stripped, truncated mid-flight, pre-trailer sender) is
        # simply an unlinked packet — degrade, never raise
        span_id = hop = 0
        rest = len(data) - off - ms_len - ind_len
        if rest >= cls._TRAILER.size:
            span_id, hop_byte = cls._TRAILER.unpack_from(
                data, off + ms_len + ind_len
            )
            hop = 1 if hop_byte else 0
        return cls(
            origin=origin,
            level=level,
            multisig=ms,
            individual_sig=ind,
            sent_ts=sent_ts,
            span_id=span_id,
            hop=hop,
        )


@runtime_checkable
class Listener(Protocol):
    """Consumer of inbound packets (net.go:16-19)."""

    def new_packet(self, packet: Packet) -> None: ...


class Network(Protocol):
    """Point-to-point datagram plane (net.go:6-13)."""

    def send(self, identities: Sequence[Identity], packet: Packet) -> None: ...

    def register_listener(self, listener: Listener) -> None: ...
