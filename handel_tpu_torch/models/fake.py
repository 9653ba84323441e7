"""Fake signature scheme for protocol tests — a copy of
handel_tpu/models/fake.py, with the same bytes on the wire.

Reference: util_test.go:15-99 — `fakePublic/fakeSig/fakeSecret/fakeCons`, where
"verification" is a boolean AND. Makes protocol tests fast and deterministic;
the scheme carries just enough state to catch wiring bugs (an invalid sig
stays invalid through any combine).
"""

from __future__ import annotations

import struct

from handel_tpu_torch.core.crypto import Constructor
from handel_tpu_torch.core.identity import ArrayRegistry, Identity

_SIG_SIZE = 8


class FakeSignature:
    __slots__ = ("valid",)

    def __init__(self, valid: bool = True):
        self.valid = valid

    def marshal(self) -> bytes:
        return struct.pack(">Q", 1 if self.valid else 0)

    def combine(self, other: "FakeSignature") -> "FakeSignature":
        return FakeSignature(self.valid and other.valid)


class FakePublic:
    __slots__ = ("valid",)

    def __init__(self, valid: bool = True):
        self.valid = valid

    def marshal(self) -> bytes:
        return struct.pack(">Q", 1 if self.valid else 0)

    def verify(self, msg: bytes, sig: FakeSignature) -> bool:
        return self.valid and sig.valid

    def combine(self, other: "FakePublic") -> "FakePublic":
        return FakePublic(self.valid and other.valid)


class FakeSecret:
    __slots__ = ("id",)

    def __init__(self, id: int = 0):
        self.id = id

    def sign(self, msg: bytes) -> FakeSignature:
        return FakeSignature(True)

    def marshal(self) -> bytes:
        return struct.pack(">Q", self.id)


class FakeConstructor(Constructor):
    def unmarshal_signature(self, data: bytes) -> FakeSignature:
        (v,) = struct.unpack(">Q", data[:_SIG_SIZE])
        return FakeSignature(v == 1)

    def signature_size(self) -> int:
        return _SIG_SIZE


def fake_registry(n: int) -> ArrayRegistry:
    """n identities with fake keys, addresses 'fake-<i>' (util_test.go FakeRegistry)."""
    return ArrayRegistry(
        [Identity(i, f"fake-{i}", FakePublic(True)) for i in range(n)]
    )


class FakeScheme:
    """Keygen facade over the fake scheme (simul/lib/crypto.go's fake
    constructors for network-only tests)."""

    def __init__(self):
        self.constructor = FakeConstructor()

    def keygen(self, i: int):
        return FakeSecret(i), FakePublic(True)

    def unmarshal_public(self, data: bytes) -> FakePublic:
        (v,) = struct.unpack(">Q", data[:8])
        return FakePublic(v == 1)

    def unmarshal_secret(self, data: bytes) -> FakeSecret:
        (i,) = struct.unpack(">Q", data[:8])
        return FakeSecret(i)
