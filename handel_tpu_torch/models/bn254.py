"""BLS signatures over BN254 on the host — counterpart of handel_tpu/models/bn254.py.

Keys are G2 points (X = x*B2), signatures G1 points (S = x*H(m));
verification checks e(H(m), X) == e(S, B2), aggregation is point addition,
and hash-to-G1 derives a scalar from SHA256(msg) by the reference's
algorithm (bn256/go/bn256.go:206-218). Wire formats (64-byte G1 = x||y
big-endian, 128-byte G2 with the imaginary coefficient first, zero bytes =
infinity) follow cloudflare/bn256's Marshal layout, byte for byte the JAX
package's.

Every point operation runs on the port's scalar oracle (ops/bn254_ref.py)
where the reference calls its C++ host library; the results are the same
points. Only verification moves to the card (models/bn254_torch.py).
"""

from __future__ import annotations

import hashlib
import secrets
import time

from handel_tpu_torch.core import report
from handel_tpu_torch.core.crypto import Constructor
from handel_tpu_torch.ops import bn254_ref as bn

_G1_SIZE = 64
_G2_SIZE = 128


def _int_to_bytes(x: int) -> bytes:
    return int(x).to_bytes(32, "big")


def _bytes_to_int(b: bytes) -> int:
    x = int.from_bytes(b, "big")
    if x >= bn.P:
        raise ValueError("coordinate >= field modulus")
    return x


def marshal_g1(pt) -> bytes:
    if pt is None:
        return b"\x00" * _G1_SIZE
    return _int_to_bytes(pt[0]) + _int_to_bytes(pt[1])


def unmarshal_g1(data: bytes):
    if len(data) != _G1_SIZE:
        raise ValueError(f"G1 point must be {_G1_SIZE} bytes")
    if data == b"\x00" * _G1_SIZE:
        return None
    pt = (_bytes_to_int(data[:32]), _bytes_to_int(data[32:]))
    if not bn.g1_is_valid(pt):
        raise ValueError("G1 point not on curve")
    return pt


def marshal_g2(pt) -> bytes:
    if pt is None:
        return b"\x00" * _G2_SIZE
    (x0, x1), (y0, y1) = pt
    # imaginary-first coefficient order, as cloudflare/bn256 gfP2 marshals
    return (
        _int_to_bytes(x1) + _int_to_bytes(x0) + _int_to_bytes(y1) + _int_to_bytes(y0)
    )


def unmarshal_g2(data: bytes, check_subgroup: bool = True):
    if len(data) != _G2_SIZE:
        raise ValueError(f"G2 point must be {_G2_SIZE} bytes")
    if data == b"\x00" * _G2_SIZE:
        return None
    x1, x0, y1, y0 = (_bytes_to_int(data[i : i + 32]) for i in range(0, 128, 32))
    pt = ((x0, x1), (y0, y1))
    if not bn.pt_is_on_curve(bn.F2_OPS, pt, bn.TWIST_B):
        raise ValueError("G2 point not on curve")
    if check_subgroup:  # [r]P == O, counted on the shared plane
        t0 = time.perf_counter()
        bad = bn.g2_mul(pt, bn.R) is not None
        report.SUBGROUP_CHECKS.add_g2((time.perf_counter() - t0) * 1000.0)
        if bad:
            raise ValueError("G2 point not on curve / wrong subgroup")
    return pt


def hash_to_g1(msg: bytes):
    """H(m) = k*G1, with k derived by the reference's algorithm: SHA256(msg)
    read as Go's crypto/rand.Int over the group order (top byte masked to
    BitLen(r) % 8 bits, big-endian); where the reference errors on a draw
    >= r, the digest is re-hashed instead (handel_tpu/models/bn254.py has
    the full derivation)."""
    keep = bn.R.bit_length() % 8
    mask = (1 << keep) - 1 if keep else 0xFF
    digest = hashlib.sha256(msg).digest()
    while True:
        k = int.from_bytes(bytes([digest[0] & mask]) + digest[1:], "big")
        if 0 < k < bn.R:
            return bn.g1_mul(bn.G1_GEN, k)
        digest = hashlib.sha256(digest).digest()


class BN254Signature:
    """A (possibly aggregate) signature: a G1 point."""

    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point

    def marshal(self) -> bytes:
        return marshal_g1(self.point)

    def combine(self, other: "BN254Signature") -> "BN254Signature":
        return BN254Signature(bn.g1_add(self.point, other.point))

    def __eq__(self, other):
        return isinstance(other, BN254Signature) and self.point == other.point


class BN254PublicKey:
    """A (possibly aggregate) public key: a G2 point."""

    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point

    def marshal(self) -> bytes:
        return marshal_g2(self.point)

    def verify(self, msg: bytes, sig: BN254Signature) -> bool:
        """e(H(m), X) * e(-S, B2) == 1, one product check on the oracle."""
        if sig.point is None or self.point is None:
            return False
        return bn.pairing_check(
            [(hash_to_g1(msg), self.point), (bn.g1_neg(sig.point), bn.G2_GEN)]
        )

    def combine(self, other: "BN254PublicKey") -> "BN254PublicKey":
        return BN254PublicKey(bn.g2_add(self.point, other.point))

    def __eq__(self, other):
        return isinstance(other, BN254PublicKey) and self.point == other.point


class BN254SecretKey:
    """The secret scalar x; public key X = x*B2, signature S = x*H(m)."""

    __slots__ = ("scalar",)

    def __init__(self, scalar: int):
        self.scalar = scalar % bn.R

    def public_key(self) -> BN254PublicKey:
        return BN254PublicKey(bn.g2_mul(bn.G2_GEN, self.scalar))

    def sign(self, msg: bytes) -> BN254Signature:
        return BN254Signature(bn.g1_mul(hash_to_g1(msg), self.scalar))

    def marshal(self) -> bytes:
        return int(self.scalar).to_bytes(32, "big")

    @classmethod
    def unmarshal(cls, data: bytes) -> "BN254SecretKey":
        return cls(int.from_bytes(data, "big"))


def new_keypair(seed: int | None = None) -> tuple[BN254SecretKey, BN254PublicKey]:
    """A keypair; deterministic when `seed` is given (the same scalar the
    JAX package derives from the same seed)."""
    if seed is not None:
        scalar = (
            int.from_bytes(
                hashlib.sha256(b"handel-tpu-key:" + str(seed).encode()).digest(),
                "big",
            )
            % bn.R
        )
    else:
        scalar = secrets.randbelow(bn.R - 1) + 1
    sk = BN254SecretKey(scalar or 1)
    return sk, sk.public_key()


class BN254Constructor(Constructor):
    """Scheme factory with the inherited serial host `batch_verify`."""

    def unmarshal_signature(self, data: bytes) -> BN254Signature:
        return BN254Signature(unmarshal_g1(data[:_G1_SIZE]))

    def signature_size(self) -> int:
        return _G1_SIZE


class BN254Scheme:
    """Keygen facade for harnesses: keygen, secret and public unmarshal."""

    def __init__(self):
        self.constructor = BN254Constructor()

    def keygen(self, i: int):
        return new_keypair(seed=i)

    def unmarshal_public(self, data: bytes) -> BN254PublicKey:
        return BN254PublicKey(unmarshal_g2(data))

    def unmarshal_secret(self, data: bytes) -> BN254SecretKey:
        return BN254SecretKey.unmarshal(data)
