"""BLS signatures over BLS12-381 on the host — counterpart of
handel_tpu/models/bls12_381.py.

The second curve behind the Constructor interface. Same key orientation as
models/bn254.py: keys in G2, signatures in G1, verify e(H(m), X) == e(S, B2)
as one product check, hash-to-G1 by the known-scalar construction.

Wire formats, byte for byte the JAX package's: uncompressed big-endian
coordinates — G1 = 96 bytes (x||y), G2 = 192 bytes (x1||x0||y1||y0,
imaginary-first like the bn254 scheme), zero bytes = point at infinity.

Every point operation runs on the port's scalar oracle
(ops/bls12_381_ref.py); only batch verification moves to the card
(models/bls12_381_torch.py).
"""

from __future__ import annotations

import hashlib
import secrets
import time

from handel_tpu_torch.core import report
from handel_tpu_torch.core.crypto import Constructor
from handel_tpu_torch.ops import bls12_381_ref as bls

_COORD = 48
_G1_SIZE = 2 * _COORD
_G2_SIZE = 4 * _COORD


def _itob(x: int) -> bytes:
    return int(x).to_bytes(_COORD, "big")


def _btoi(b: bytes) -> int:
    x = int.from_bytes(b, "big")
    if x >= bls.P:
        raise ValueError("coordinate >= field modulus")
    return x


def marshal_g1(pt) -> bytes:
    if pt is None:
        return b"\x00" * _G1_SIZE
    return _itob(pt[0]) + _itob(pt[1])


def unmarshal_g1(data: bytes):
    if len(data) != _G1_SIZE:
        raise ValueError(f"G1 point must be {_G1_SIZE} bytes")
    if data == b"\x00" * _G1_SIZE:
        return None
    pt = (_btoi(data[:_COORD]), _btoi(data[_COORD:]))
    if not bls.g1_is_valid(pt):
        raise ValueError("G1 point not on curve / wrong subgroup")
    return pt


def marshal_g2(pt) -> bytes:
    if pt is None:
        return b"\x00" * _G2_SIZE
    (x0, x1), (y0, y1) = pt
    return _itob(x1) + _itob(x0) + _itob(y1) + _itob(y0)


def unmarshal_g2(data: bytes):
    if len(data) != _G2_SIZE:
        raise ValueError(f"G2 point must be {_G2_SIZE} bytes")
    if data == b"\x00" * _G2_SIZE:
        return None
    x1, x0, y1, y0 = (_btoi(data[i : i + _COORD]) for i in range(0, _G2_SIZE, _COORD))
    pt = ((x0, x1), (y0, y1))
    t0 = time.perf_counter()
    ok = bls.g2_is_valid(pt)
    report.SUBGROUP_CHECKS.add_g2((time.perf_counter() - t0) * 1000.0)
    if not ok:
        raise ValueError("G2 point not on curve / wrong subgroup")
    return pt


def hash_to_g1(msg: bytes):
    k = int.from_bytes(hashlib.sha256(b"bls12-381:" + msg).digest(), "big") % bls.R
    return bls.g1_mul(bls.G1_GEN, k or 1)


class BLS12381Signature:
    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point

    def marshal(self) -> bytes:
        return marshal_g1(self.point)

    def combine(self, other: "BLS12381Signature") -> "BLS12381Signature":
        return BLS12381Signature(bls.g1_add(self.point, other.point))

    def __eq__(self, other):
        return isinstance(other, BLS12381Signature) and self.point == other.point


class BLS12381PublicKey:
    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point

    def marshal(self) -> bytes:
        return marshal_g2(self.point)

    def verify(self, msg: bytes, sig: BLS12381Signature) -> bool:
        if sig.point is None or self.point is None:
            return False
        hm = hash_to_g1(msg)
        return bls.pairing_check(
            [(hm, self.point), (bls.g1_neg(sig.point), bls.G2_GEN)]
        )

    def combine(self, other: "BLS12381PublicKey") -> "BLS12381PublicKey":
        return BLS12381PublicKey(bls.g2_add(self.point, other.point))

    def __eq__(self, other):
        return isinstance(other, BLS12381PublicKey) and self.point == other.point


class BLS12381SecretKey:
    __slots__ = ("scalar",)

    def __init__(self, scalar: int):
        self.scalar = scalar % bls.R

    def public_key(self) -> BLS12381PublicKey:
        return BLS12381PublicKey(bls.g2_mul(bls.G2_GEN, self.scalar))

    def sign(self, msg: bytes) -> BLS12381Signature:
        return BLS12381Signature(bls.g1_mul(hash_to_g1(msg), self.scalar))

    def marshal(self) -> bytes:
        return int(self.scalar).to_bytes(32, "big")

    @classmethod
    def unmarshal(cls, data: bytes) -> "BLS12381SecretKey":
        return cls(int.from_bytes(data, "big"))


def new_keypair(seed: int | None = None):
    if seed is not None:
        scalar = (
            int.from_bytes(
                hashlib.sha256(b"handel-tpu-bls-key:" + str(seed).encode()).digest(),
                "big",
            )
            % bls.R
        )
    else:
        scalar = secrets.randbelow(bls.R - 1) + 1
    sk = BLS12381SecretKey(scalar or 1)
    return sk, sk.public_key()


class BLS12381Constructor(Constructor):
    def unmarshal_signature(self, data: bytes) -> BLS12381Signature:
        return BLS12381Signature(unmarshal_g1(data[:_G1_SIZE]))

    def signature_size(self) -> int:
        return _G1_SIZE


class BLS12381Scheme:
    """Keygen facade with simulation marshal support."""

    def __init__(self):
        self.constructor = BLS12381Constructor()

    def keygen(self, i: int):
        return new_keypair(seed=i)

    def unmarshal_public(self, data: bytes) -> BLS12381PublicKey:
        return BLS12381PublicKey(unmarshal_g2(data))

    def unmarshal_secret(self, data: bytes) -> BLS12381SecretKey:
        return BLS12381SecretKey.unmarshal(data)
