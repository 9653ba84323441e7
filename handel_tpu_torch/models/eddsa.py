"""Ed25519 (RFC 8032) scheme — the non-aggregating baseline; a copy of
handel_tpu/models/eddsa.py.

BLS's one-pairing-per-verify cost is what the whole device plane exists
to amortize; this scheme is the control group. Ed25519 cannot aggregate:
a "multisignature" here is the literal SET of individual signatures,
each tagged with a key id (kid = first 8 bytes of the signer's encoded
public key), and `combine` is set union. Wire cost therefore grows
linearly with cardinality where BLS stays one G1 point — exactly the
trade the results/README.md comparison row (scripts/eddsa_compare.py)
quantifies. Verification is k independent scalar-mult checks instead of
one pairing product, so it wins at small committees and loses the wire.

Pure-Python big-int field math over 2^255-19, extended homogeneous
coordinates, cofactorless verification (S*B == R + k*A). Deterministic
keygen from a seeded SHA-256, like the other schemes' simulation keygen.

The aggregate wire envelope is fixed-size (Constructor.signature_size
contract: MultiSignature slices a fixed suffix): a uint16 count followed
by MAX_SIGNERS slots of (kid[8] || R[32] || S[32]), zero-padded. Use it
for committees up to MAX_SIGNERS; the registry aliases are "eddsa" and
"ed25519".
"""

from __future__ import annotations

import hashlib
import struct

from handel_tpu_torch.core.crypto import Constructor

# -- curve parameters (RFC 8032 §5.1) ---------------------------------------

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P

_ENTRY = 8 + 64  # kid || R || S
MAX_SIGNERS = 64
_SIG_SIZE = 2 + MAX_SIGNERS * _ENTRY


def _sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


# -- point arithmetic, extended homogeneous (x, y, z, t), t = xy/z ----------


def _pt_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _pt_mul(s: int, p):
    q = (0, 1, 1, 0)  # identity
    while s > 0:
        if s & 1:
            q = _pt_add(q, p)
        p = _pt_add(p, p)
        s >>= 1
    return q


def _pt_equal(p, q) -> bool:
    # cross-multiply out the projective z
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


_BY = 4 * pow(5, P - 2, P) % P
_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
B = (_BX, _BY, 1, _BX * _BY % P)

_SQRT_M1 = pow(2, (P - 1) // 4, P)


def _recover_x(y: int, sign: int) -> int | None:
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * _SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if x & 1 != sign:
        x = P - x
    return x


def point_compress(p) -> bytes:
    x, y, z, _ = p
    zinv = pow(z, P - 2, P)
    x, y = x * zinv % P, y * zinv % P
    return int(y | ((x & 1) << 255)).to_bytes(32, "little")


def point_decompress(data: bytes):
    if len(data) != 32:
        raise ValueError("Ed25519 point must be 32 bytes")
    y = int.from_bytes(data, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        raise ValueError("invalid Ed25519 point")
    return (x, y, 1, x * y % P)


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def _kid(enc_pub: bytes) -> bytes:
    return enc_pub[:8]


# -- scheme objects ----------------------------------------------------------


class EdDSASignature:
    """kid -> (R || S) signature set; combine is union (NO aggregation)."""

    __slots__ = ("sigs",)

    def __init__(self, sigs: dict[bytes, bytes]):
        self.sigs = sigs

    def marshal(self) -> bytes:
        if len(self.sigs) > MAX_SIGNERS:
            raise ValueError(
                f"eddsa aggregate holds {len(self.sigs)} > {MAX_SIGNERS} sigs"
            )
        out = [struct.pack(">H", len(self.sigs))]
        for kid in sorted(self.sigs):
            out.append(kid + self.sigs[kid])
        out.append(b"\x00" * ((MAX_SIGNERS - len(self.sigs)) * _ENTRY))
        return b"".join(out)

    def combine(self, other: "EdDSASignature") -> "EdDSASignature":
        merged = dict(self.sigs)
        merged.update(other.sigs)
        return EdDSASignature(merged)

    def wire_cardinality(self) -> int:
        return len(self.sigs)


class EdDSAPublicKey:
    """kid -> curve point set; combine is union, mirroring the signature."""

    __slots__ = ("keys",)

    def __init__(self, keys: dict[bytes, tuple]):
        self.keys = keys

    def marshal(self) -> bytes:
        # single keys round-trip through unmarshal_public; multi-key sets
        # only exist in memory during verification
        return b"".join(point_compress(self.keys[k]) for k in sorted(self.keys))

    def verify(self, msg: bytes, sig: EdDSASignature) -> bool:
        """Every key in this set must have a valid entry in `sig`."""
        if not isinstance(sig, EdDSASignature) or not self.keys:
            return False
        for kid, point in self.keys.items():
            rs = sig.sigs.get(kid)
            if rs is None or not _verify_one(msg, point, rs):
                return False
        return True

    def combine(self, other: "EdDSAPublicKey") -> "EdDSAPublicKey":
        merged = dict(self.keys)
        merged.update(other.keys)
        return EdDSAPublicKey(merged)


def _verify_one(msg: bytes, pub_point, rs: bytes) -> bool:
    try:
        r_pt = point_decompress(rs[:32])
    except ValueError:
        return False
    s = int.from_bytes(rs[32:64], "little")
    if s >= L:
        return False
    enc_a = point_compress(pub_point)
    k = int.from_bytes(_sha512(rs[:32] + enc_a + msg), "little") % L
    return _pt_equal(_pt_mul(s, B), _pt_add(r_pt, _pt_mul(k, pub_point)))


class EdDSASecretKey:
    __slots__ = ("seed", "scalar", "prefix", "enc_pub", "pub_point")

    def __init__(self, seed: bytes):
        self.seed = seed
        h = _sha512(seed)
        self.scalar = _clamp(h[:32])
        self.prefix = h[32:]
        self.pub_point = _pt_mul(self.scalar, B)
        self.enc_pub = point_compress(self.pub_point)

    def public_key(self) -> EdDSAPublicKey:
        return EdDSAPublicKey({_kid(self.enc_pub): self.pub_point})

    def sign(self, msg: bytes) -> EdDSASignature:
        r = int.from_bytes(_sha512(self.prefix + msg), "little") % L
        enc_r = point_compress(_pt_mul(r, B))
        k = int.from_bytes(_sha512(enc_r + self.enc_pub + msg), "little") % L
        s = (r + k * self.scalar) % L
        return EdDSASignature(
            {_kid(self.enc_pub): enc_r + int(s).to_bytes(32, "little")}
        )

    def marshal(self) -> bytes:
        return self.seed


class EdDSAConstructor(Constructor):
    def unmarshal_signature(self, data: bytes) -> EdDSASignature:
        if len(data) < _SIG_SIZE:
            raise ValueError("eddsa signature wire data truncated")
        (count,) = struct.unpack(">H", data[:2])
        if count > MAX_SIGNERS:
            raise ValueError(f"eddsa signature count {count} > {MAX_SIGNERS}")
        sigs: dict[bytes, bytes] = {}
        for i in range(count):
            off = 2 + i * _ENTRY
            entry = data[off : off + _ENTRY]
            sigs[entry[:8]] = entry[8:]
        return EdDSASignature(sigs)

    def signature_size(self) -> int:
        return _SIG_SIZE


def new_keypair(seed: int | None = None) -> tuple[EdDSASecretKey, EdDSAPublicKey]:
    if seed is not None:
        raw = hashlib.sha256(b"handel-tpu-eddsa-key:" + str(seed).encode()).digest()
    else:
        import secrets

        raw = secrets.token_bytes(32)
    sk = EdDSASecretKey(raw)
    return sk, sk.public_key()


class EdDSAScheme:
    """Scheme facade matching fake/bn254/bls12_381 (registry: "eddsa")."""

    def __init__(self):
        self.constructor = EdDSAConstructor()

    def keygen(self, i: int):
        return new_keypair(seed=i)

    def unmarshal_public(self, data: bytes) -> EdDSAPublicKey:
        point = point_decompress(data[:32])
        return EdDSAPublicKey({_kid(data[:32]): point})

    def unmarshal_secret(self, data: bytes) -> EdDSASecretKey:
        return EdDSASecretKey(data[:32])
