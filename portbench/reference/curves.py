"""Plain-Python point arithmetic for the benchmark's inputs and its
reference verdicts: G1 over Fp and G2 over Fp2 of the curves y^2 = x^3 + b
(a = 0), in Jacobian coordinates, with fixed-base window tables.

It imports nothing of the program under test. Each curve is one `Curve`
record: its field modulus, group order, generators, curve coefficients and
hash to G1 (`hash_to_g1`), the same construction as the deployed scheme:

  * BN254: H(m) = k * G1 with k from SHA-256(m) read as Go's
    crypto/rand.Int over the group order (top byte masked to
    BitLen(r) % 8 bits; a draw outside [1, r) re-hashes the digest);
  * BLS12-381: k = SHA-256(b"bls12-381:" || m) mod r, or 1 for 0.

Points: affine (x, y) tuples with x, y ints (G1) or (c0, c1) int pairs
(G2, c0 + c1 * i with i^2 = -1 on both curves); None is infinity.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable


class Fp:
    """Arithmetic mod p on ints."""

    def __init__(self, p: int):
        self.p = p
        self.zero, self.one = 0, 1

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return a * b % self.p

    def sqr(self, a):
        return a * a % self.p

    def inv(self, a):
        return pow(a, -1, self.p)


class Fp2:
    """Arithmetic on (c0, c1) = c0 + c1 * i, i^2 = -1."""

    def __init__(self, p: int):
        self.p = p
        self.zero, self.one = (0, 0), (1, 0)

    def add(self, a, b):
        p = self.p
        return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)

    def sub(self, a, b):
        p = self.p
        return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)

    def mul(self, a, b):
        p = self.p
        a0, a1 = a
        b0, b1 = b
        return ((a0 * b0 - a1 * b1) % p, (a0 * b1 + a1 * b0) % p)

    def sqr(self, a):
        p = self.p
        a0, a1 = a
        return ((a0 + a1) * (a0 - a1) % p, 2 * a0 * a1 % p)

    def inv(self, a):
        p = self.p
        a0, a1 = a
        t = pow(a0 * a0 + a1 * a1, -1, p)
        return (a0 * t % p, -a1 * t % p)


class Group:
    """The points of y^2 = x^3 + b over field `F`, a = 0.

    Jacobian (X, Y, Z) stands for (X / Z^2, Y / Z^3); infinity is None in
    both forms."""

    def __init__(self, F, b, gen):
        self.F, self.b, self.gen = F, b, gen

    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        F = self.F
        x, y = pt
        return F.sqr(y) == F.add(F.mul(F.sqr(x), x), self.b)

    def jac(self, pt):
        return None if pt is None else (pt[0], pt[1], self.F.one)

    def dbl(self, P):
        if P is None:
            return None
        F = self.F
        X, Y, Z = P
        if Y == F.zero:
            return None
        A = F.sqr(X)
        B = F.sqr(Y)
        C = F.sqr(B)
        D = F.sub(F.sqr(F.add(X, B)), F.add(A, C))
        D = F.add(D, D)
        E = F.add(F.add(A, A), A)
        X3 = F.sub(F.sqr(E), F.add(D, D))
        C8 = F.add(C, C)
        C8 = F.add(C8, C8)
        C8 = F.add(C8, C8)
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
        Z3 = F.mul(F.add(Y, Y), Z)
        return (X3, Y3, Z3)

    def add(self, P, Q):
        """P + Q, both Jacobian."""
        if P is None:
            return Q
        if Q is None:
            return P
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        Z1s, Z2s = F.sqr(Z1), F.sqr(Z2)
        U1, U2 = F.mul(X1, Z2s), F.mul(X2, Z1s)
        S1 = F.mul(Y1, F.mul(Z2, Z2s))
        S2 = F.mul(Y2, F.mul(Z1, Z1s))
        if U1 == U2:
            return self.dbl(P) if S1 == S2 else None
        H = F.sub(U2, U1)
        R = F.sub(S2, S1)
        H2 = F.sqr(H)
        H3 = F.mul(H, H2)
        V = F.mul(U1, H2)
        X3 = F.sub(F.sub(F.sqr(R), H3), F.add(V, V))
        Y3 = F.sub(F.mul(R, F.sub(V, X3)), F.mul(S1, H3))
        Z3 = F.mul(H, F.mul(Z1, Z2))
        return (X3, Y3, Z3)

    def add_affine(self, P, q):
        """P (Jacobian) + q (affine): the mixed addition."""
        if q is None:
            return P
        if P is None:
            return self.jac(q)
        F = self.F
        X1, Y1, Z1 = P
        x2, y2 = q
        Z1s = F.sqr(Z1)
        U2 = F.mul(x2, Z1s)
        S2 = F.mul(y2, F.mul(Z1, Z1s))
        if X1 == U2:
            return self.dbl(P) if Y1 == S2 else None
        H = F.sub(U2, X1)
        R = F.sub(S2, Y1)
        H2 = F.sqr(H)
        H3 = F.mul(H, H2)
        V = F.mul(X1, H2)
        X3 = F.sub(F.sub(F.sqr(R), H3), F.add(V, V))
        Y3 = F.sub(F.mul(R, F.sub(V, X3)), F.mul(Y1, H3))
        Z3 = F.mul(H, Z1)
        return (X3, Y3, Z3)

    def mul(self, pt, k: int):
        """k * pt (affine in, Jacobian out), double-and-add."""
        acc = None
        for bit in bin(k)[2:] if k > 0 else "":
            acc = self.dbl(acc)
            if bit == "1":
                acc = self.add_affine(acc, pt)
        return acc

    def to_affine(self, pts):
        """Jacobian points to affine, one field inversion for all."""
        F = self.F
        zs = [P[2] for P in pts if P is not None]
        # Montgomery's batch inversion
        pre, acc = [], F.one
        for z in zs:
            pre.append(acc)
            acc = F.mul(acc, z)
        inv = F.inv(acc) if zs else F.one
        invs = [None] * len(zs)
        for i in range(len(zs) - 1, -1, -1):
            invs[i] = F.mul(inv, pre[i])
            inv = F.mul(inv, zs[i])
        out, i = [], 0
        for P in pts:
            if P is None:
                out.append(None)
                continue
            zi = invs[i]
            i += 1
            zi2 = F.sqr(zi)
            out.append((F.mul(P[0], zi2), F.mul(P[1], F.mul(zi, zi2))))
        return out

    def equals_affine(self, P, q) -> bool:
        """Jacobian P == affine q, without an inversion."""
        if P is None or q is None:
            return P is None and q is None
        F = self.F
        Zs = F.sqr(P[2])
        return P[0] == F.mul(q[0], Zs) and P[1] == F.mul(q[1], F.mul(P[2], Zs))


class FixedBase:
    """k * base for scalars below 2^bits: a table of d * 2^(8 i) * base
    (d < 256), so one product is one mixed addition a byte of k."""

    WINDOW = 8

    def __init__(self, group: Group, base, bits: int):
        self.group = group
        self.windows = max(1, -(-bits // self.WINDOW))
        self.limit = 1 << (self.windows * self.WINDOW)
        rows, step = [], group.jac(base)
        for _ in range(self.windows):
            row, acc = [], None
            for _d in range(1, 1 << self.WINDOW):
                acc = group.add(acc, step)
                row.append(acc)
            rows.append(row)
            step = group.add(acc, step)  # 256 * the row's base
        flat = group.to_affine([P for row in rows for P in row])
        n = (1 << self.WINDOW) - 1
        self.table = [flat[i * n : (i + 1) * n] for i in range(self.windows)]

    def mul(self, k: int):
        """k * base in Jacobian form, 0 <= k < 2^(8 * windows)."""
        if not 0 <= k < self.limit:
            raise ValueError(f"scalar {k} outside this table's {self.windows} bytes")
        g = self.group
        if isinstance(g.F, Fp):
            return self._mul_fp(k)
        acc, i = None, 0
        while k:
            d = k & 0xFF
            if d:
                acc = g.add_affine(acc, self.table[i][d - 1])
            k >>= self.WINDOW
            i += 1
        return acc

    def _mul_fp(self, k: int):
        """`mul` over Fp with the mixed addition written out on ints: the
        same formulas as Group.add_affine, which takes the cases where they
        meet a doubling or infinity."""
        p, g = self.group.F.p, self.group
        acc, i = None, 0
        while k:
            d = k & 0xFF
            if d:
                x2, y2 = self.table[i][d - 1]
                if acc is None:
                    acc = (x2, y2, 1)
                else:
                    X1, Y1, Z1 = acc
                    Z1s = Z1 * Z1 % p
                    U2 = x2 * Z1s % p
                    S2 = y2 * Z1 % p * Z1s % p
                    if U2 == X1:
                        acc = g.add_affine(acc, (x2, y2))
                    else:
                        H = (U2 - X1) % p
                        R = (S2 - Y1) % p
                        H2 = H * H % p
                        H3 = H * H2 % p
                        V = X1 * H2 % p
                        X3 = (R * R - H3 - 2 * V) % p
                        acc = (X3, (R * (V - X3) - Y1 * H3) % p, H * Z1 % p)
            k >>= self.WINDOW
            i += 1
        return acc


@dataclass(frozen=True)
class Curve:
    name: str
    p: int
    r: int
    g1: Group
    g2: Group
    hash_to_g1: Callable[[bytes], tuple]


def _bn254() -> Curve:
    p = 21888242871839275222246405745257275088696311157297823662689037894645226208583
    r = 21888242871839275222246405745257275088548364400416034343698204186575808495617
    F, F2 = Fp(p), Fp2(p)
    xi = (9, 1)
    twist_b = F2.mul((3, 0), F2.inv(xi))  # 3 / xi
    g1 = Group(F, 3, (1, 2))
    g2 = Group(F2, twist_b, (
        (10857046999023057135944570762232829481370756359578518086990519993285655852781,
         11559732032986387107991004021392285783925812861821192530917403151452391805634),
        (8495653923123431417604973247489272438418190587263600148770280649306958101930,
         4082367875863433681332203403145435568316851327593401208105741076214120093531),
    ))

    def hash_to_g1(msg: bytes):
        keep = r.bit_length() % 8
        mask = (1 << keep) - 1 if keep else 0xFF
        digest = hashlib.sha256(msg).digest()
        while True:
            k = int.from_bytes(bytes([digest[0] & mask]) + digest[1:], "big")
            if 0 < k < r:
                return g1.to_affine([g1.mul(g1.gen, k)])[0]
            digest = hashlib.sha256(digest).digest()

    return Curve("bn254", p, r, g1, g2, hash_to_g1)


def _bls12_381() -> Curve:
    p = int(
        "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfff"
        "eb153ffffb9feffffffffaaab", 16,
    )
    r = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
    F, F2 = Fp(p), Fp2(p)
    g1 = Group(F, 4, (
        0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
        0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    ))
    g2 = Group(F2, (4, 4), (  # 4 (1 + i): the M-type twist
        (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
         0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
        (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
         0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
    ))

    def hash_to_g1(msg: bytes):
        k = int.from_bytes(hashlib.sha256(b"bls12-381:" + msg).digest(), "big") % r
        return g1.to_affine([g1.mul(g1.gen, k or 1)])[0]

    return Curve("bls12-381", p, r, g1, g2, hash_to_g1)


_MAKERS = {"bn254": _bn254, "bls12-381": _bls12_381}
_CACHE: dict[str, Curve] = {}


def curve(name: str) -> Curve:
    """The named curve ("bn254" or "bls12-381")."""
    if name not in _MAKERS:
        raise KeyError(f"no reference curve {name!r}; have {sorted(_MAKERS)}")
    if name not in _CACHE:
        _CACHE[name] = _MAKERS[name]()
    return _CACHE[name]
