"""Batched elliptic-curve group ops for G1 (Fp) and G2 (Fp2) of BN254 and
BLS12-381 — counterpart of handel_tpu/ops/curve.py.

* Complete projective formulas (Renes–Costello–Batina 2015, Alg. 7, a = 0):
  one branch-free formula covers generic add, doubling, the identity and
  inverse points. Points are (X, Y, Z) tuples; infinity is (0, 1, 0).
* The 14 field multiplications of an add are stacked into 3 wide
  `Field.mul` calls (plus the b3 multiply), so the kernel sees wide launches.
* `sum_points` folds n point blocks in ceil(log2 n) stacked add stages;
  `prefix_scan` is a Hillis–Steele scan over the same add.

Correctness oracles: ops/bn254_ref.py and ops/bls12_381_ref.py; parity with
the JAX package in tests/test_torch_tower_curve.py and
tests/test_torch_bls12_381.py.
"""

from __future__ import annotations

import numpy as np
import torch

from handel_tpu_torch.ops import bls12_381_ref as _bls
from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops.fp import Field
from handel_tpu_torch.ops.tower import Tower, _split


class _FpAdapter:
    """Base-field element algebra for G1: elements are (nlimbs, B) tensors.
    b3 = 3b of y^2 = x^3 + b (9 for BN254), realized as an add chain."""

    def __init__(self, F: Field, b3: int = 9):
        if b3 not in (9, 12):
            raise ValueError(f"unsupported curve constant b3={b3}")
        self.F = F
        self.b3 = b3
        self.device = F.device

    def add(self, a, b):
        return self.F.add(a, b)

    def sub(self, a, b):
        return self.F.sub(a, b)

    def neg(self, a):
        return self.F.neg(a)

    def select(self, mask, a, b):
        return self.F.select(mask, a, b)

    def zero(self, batch):
        return torch.zeros((self.F.nlimbs, batch), dtype=torch.int32, device=self.F.device)

    def one(self, batch):
        return self.F.constant(1, batch)

    def eq(self, a, b):
        return self.F.eq(a, b)

    def is_zero(self, a):
        return self.F.is_zero(a)

    def batch(self, a):
        return a.shape[1]

    def mul_many(self, lhs, rhs):
        """Stacked multiplication: one Field.mul for k independent muls."""
        return _split(self.F.mul(torch.cat(lhs, 1), torch.cat(rhs, 1)), len(lhs))

    def mul_b3(self, a):
        """x * b3 by add chain, no mul (x9 for BN254, x12 for BLS12-381)."""
        a2 = self.F.add(a, a)
        a4 = self.F.add(a2, a2)
        a8 = self.F.add(a4, a4)
        return self.F.add(a8, a if self.b3 == 9 else a4)

    def inv(self, a):
        return self.F.inv(a)

    def concat(self, elems):
        return torch.cat(elems, 1)

    def split(self, e, k):
        return _split(e, k)


class _Fp2Adapter:
    """Quadratic-extension algebra for G2': elements are Fp2 pairs."""

    def __init__(self, T: Tower, params=bn):
        self.T = T
        self.device = T.F.device
        # E' twist coefficient b' (3/xi for BN254's D-twist); b3 = 3 b'
        self._b3 = params.f2_scalar(params.TWIST_B, 3)

    def add(self, a, b):
        return self.T.f2_add(a, b)

    def sub(self, a, b):
        return self.T.f2_sub(a, b)

    def neg(self, a):
        return self.T.f2_neg(a)

    def select(self, mask, a, b):
        return self.T.f2_select(mask, a, b)

    def zero(self, batch):
        return self.T.f2_zero(batch)

    def one(self, batch):
        return self.T.f2_one(batch)

    def eq(self, a, b):
        return self.T.f2_eq(a, b)

    def is_zero(self, a):
        return self.T.f2_is_zero(a)

    def batch(self, a):
        return a[0].shape[1]

    def mul_many(self, lhs, rhs):
        out = self.T.f2_mul(self.T._f2_stack(lhs), self.T._f2_stack(rhs))
        return self.T._f2_unstack(out, len(lhs))

    def mul_b3(self, a):
        return self.T.f2_mul(a, self.T.f2_constant(self._b3, a[0].shape[1]))

    def inv(self, a):
        return self.T.f2_inv(a)

    def concat(self, elems):
        return self.T._f2_stack(elems)

    def split(self, e, k):
        return self.T._f2_unstack(e, k)


def _tree_map(fn, tree):
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, t) for t in tree)
    return fn(tree)


class Curve:
    """Batched short-Weierstrass group (y^2 = x^3 + b, a = 0) over an element
    algebra. Points are (X, Y, Z) tuples; the identity is (0, 1, 0)."""

    def __init__(self, ops):
        self.ops = ops

    def infinity(self, batch: int):
        o = self.ops
        return (o.zero(batch), o.one(batch), o.zero(batch))

    def from_affine(self, x, y):
        o = self.ops
        return (x, y, o.one(o.batch(x)))

    def is_infinity(self, P):
        return self.ops.is_zero(P[2])

    def eq(self, P, Q):
        """Projective equality (both-infinite counts as equal)."""
        o = self.ops
        a, b, c, d = o.mul_many([P[0], Q[0], P[1], Q[1]], [Q[2], P[2], Q[2], P[2]])
        both_inf = self.is_infinity(P) & self.is_infinity(Q)
        one_inf = self.is_infinity(P) ^ self.is_infinity(Q)
        return (o.eq(a, b) & o.eq(c, d) & ~one_inf) | both_inf

    def add(self, P, Q):
        """Complete projective addition (RCB15 Alg. 7, a = 0): 12 muls +
        2 b3-muls, stacked into 3 wide Field.mul calls."""
        o = self.ops
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        a, b, c = o.mul_many([X1, Y1, Z1], [X2, Y2, Z2])
        d, e, f = o.mul_many(
            [o.add(X1, Y1), o.add(Y1, Z1), o.add(X1, Z1)],
            [o.add(X2, Y2), o.add(Y2, Z2), o.add(X2, Z2)],
        )
        d = o.sub(d, o.add(a, b))  # X1Y2 + X2Y1
        e = o.sub(e, o.add(b, c))  # Y1Z2 + Y2Z1
        f = o.sub(f, o.add(a, c))  # X1Z2 + X2Z1
        g = o.add(o.add(a, a), a)  # 3 X1X2
        h = o.mul_b3(c)
        i = o.add(b, h)
        j = o.sub(b, h)
        k = o.mul_b3(f)
        m0, m1, m2, m3, m4, m5 = o.mul_many([d, e, j, k, g, i], [j, k, i, g, d, e])
        return (o.sub(m0, m1), o.add(m2, m3), o.add(m5, m4))

    def double(self, P):
        return self.add(P, P)

    def neg(self, P):
        return (P[0], self.ops.neg(P[1]), P[2])

    def select(self, mask, P, Q):
        o = self.ops
        return tuple(o.select(mask, p, q) for p, q in zip(P, Q))

    def scalar_mul(self, P, bits):
        """[k]P with per-lane scalars; bits: (nbits, B) tensor, MSB first.
        Double-and-add with a per-lane select."""
        acc = self.infinity(self.ops.batch(P[0]))
        for bit in bits:
            acc = self.double(acc)
            acc = self.select(bit == 1, self.add(acc, P), acc)
        return acc

    def sum_points(self, P, n: int):
        """Tree-sum n point blocks laid out block-major along the batch axis
        (each coordinate (..., n*b)); returns points of batch b."""
        o = self.ops
        b = o.batch(P[0]) // n
        while n > 1:
            if n % 2:  # pad with one infinity block
                inf = self.infinity(b)
                P = tuple(o.concat([c, ic]) for c, ic in zip(P, inf))
                n += 1
            lo = tuple(o.split(c, 2)[0] for c in P)
            hi = tuple(o.split(c, 2)[1] for c in P)
            P = self.add(lo, hi)
            n //= 2
        return P

    def masked_sum(self, P, mask, n: int):
        """Sum of the blocks whose mask bit is set; mask: (n*b,) bool."""
        P = self.select(mask, P, self.infinity(self.ops.batch(P[0])))
        return self.sum_points(P, n)

    def msm(self, P, bits, n: int, window: int = 4):
        """Batched multi-scalar multiplication: out lane j = sum_i k[i,j]·P[i,j]
        over n point blocks laid out block-major along the batch axis (block i
        lane j = batch index i*b + j, as in `sum_points`). bits: (nbits, n*b)
        int32 MSB-first per-lane scalar bits (`BN254Curves.scalar_bits64`).
        Lanes whose scalar is 0 contribute the identity, so masking to the
        launch hull is zeroing those columns before the call.

        Windowed bucket accumulation over the existing reductions: the
        scalars are cut into w-bit digits; each window step sorts the blocks
        into the V = 2^w - 1 nonzero buckets with ONE `masked_sum` over an
        (n, V, b) tiling (the bucket histogram is a select mask, not a
        gather), turns the bucket sums into Σ v·B_v with a Hillis–Steele
        *suffix* scan over the bucket axis (Σ_v v·B_v = Σ_v Σ_{u≥v} B_u:
        log2 V adds, no scalar multiply), and Horner-folds the windows (w
        doublings and one add a step; the reference's `lax.scan` is a Python
        loop here). window=1 is a shared double-and-add over `masked_sum`.

        Cost per window step: w doubles + [log2 n + 2·log2 V + 1] complete
        adds, all stacked full-width; 64-bit scalars at w=4 are 16 steps."""
        o = self.ops
        dev = bits.device
        nb = o.batch(P[0])
        b = nb // n
        V = (1 << window) - 1
        nbits = bits.shape[0]
        pad = (-nbits) % window
        if pad:
            bits = torch.cat([bits.new_zeros((pad, nb)), bits])
        nwin = (nbits + pad) // window
        weights = 1 << torch.arange(window - 1, -1, -1, dtype=torch.int32, device=dev)
        digits = (bits.reshape(nwin, window, nb) * weights[None, :, None]).sum(
            1, dtype=torch.int32
        )  # (nwin, n*b), each in [0, 2^w)

        # each block tiled across the V buckets: (..., n*b) -> (..., n*V*b),
        # tiled index i*V*b + v*b + j <- block i lane j; loop-invariant
        def tile(a):
            lead = tuple(a.shape[:-1])
            return a.reshape(lead + (n, 1, b)).expand(lead + (n, V, b)).reshape(lead + (n * V * b,))

        tiled = _tree_map(tile, P)
        bucket_of = torch.arange(V * b, device=dev) // b  # suffix-scan block ids
        values = torch.arange(1, V + 1, dtype=torch.int32, device=dev)[:, None]
        acc = self.infinity(b)
        for d in digits:
            for _ in range(window):
                acc = self.double(acc)
            # bucket membership: tiled lane (i, v, j) set iff digit == v + 1
            hit = d[None, :] == values
            mask = hit.reshape(V, n, b).transpose(0, 1).reshape(n * V * b)
            buckets = self.masked_sum(tiled, mask, n)  # (V*b,) bucket-major
            d2 = 1
            while d2 < V:  # suffix sums R_v = sum_{u >= v} B_u
                shifted = self.select(
                    bucket_of + d2 < V,
                    _tree_map(lambda a: torch.roll(a, -d2 * b, dims=-1), buckets),
                    self.infinity(V * b),
                )
                buckets = self.add(buckets, shifted)
                d2 *= 2
            acc = self.add(acc, self.sum_points(buckets, V))
        return acc

    def prefix_scan(self, P):
        """Inclusive prefix sums along the batch axis (Hillis–Steele doubling
        scan over the complete add): out lane i = sum of lanes 0..i."""
        o = self.ops
        n = o.batch(P[0])
        inf = self.infinity(n)
        lane = torch.arange(n, device=o.device)
        d = 1
        while d < n:
            shifted = _tree_map(lambda a: torch.roll(a, d, dims=-1), P)
            shifted = self.select(lane >= d, shifted, inf)
            P = self.add(P, shifted)
            d *= 2
        return P

    def to_affine(self, P):
        """(x, y, inf_mask): one field inversion per lane. Infinity lanes
        return (0, 0) with the mask set."""
        o = self.ops
        inf = self.is_infinity(P)
        z = o.select(inf, o.one(o.batch(P[2])), P[2])
        zinv = o.inv(z)
        x, y = o.mul_many([P[0], P[1]], [zinv, zinv])
        zero = o.zero(o.batch(x))
        return (o.select(inf, zero, x), o.select(inf, zero, y), inf)

    def on_curve(self, P):
        """Projective membership 3 Y^2 Z == 3 X^3 + b3 Z^3; infinity passes."""
        o = self.ops
        yy, xx, zz = o.mul_many([P[1], P[0], P[2]], [P[1], P[0], P[2]])
        lhs, x3, z3 = o.mul_many([yy, xx, zz], [P[2], P[0], P[2]])
        three = lambda t: o.add(o.add(t, t), t)
        return o.eq(three(lhs), o.add(three(x3), o.mul_b3(z3)))


class BN254Curves:
    """The two pairing groups sharing one Field/Tower, plus host conversions."""

    params = bn
    g1_b3 = 9  # 3*b for E: y^2 = x^3 + 3

    def __init__(self, field: Field | None = None, tower: Tower | None = None,
                 device=None, backend: str | None = None):
        # `backend` picks the Field's multiply ("cios"/"rns"); a field or tower wins
        self.F = field or (
            tower.F if tower is not None
            else Field(self.params.P, backend=backend, device=device)
        )
        self.T = tower or Tower(self.F, params=self.params)
        self.device = self.F.device
        self.g1 = Curve(_FpAdapter(self.F, b3=self.g1_b3))
        self.g2 = Curve(_Fp2Adapter(self.T, params=self.params))

    def pack_g1(self, pts):
        """Scalar-oracle affine G1 points (None = infinity) -> projective batch."""
        xs = [0 if p is None else p[0] for p in pts]
        ys = [1 if p is None else p[1] for p in pts]
        zs = [0 if p is None else 1 for p in pts]
        return (self.F.pack(xs), self.F.pack(ys), self.F.pack(zs))

    def unpack_g1(self, P):
        x, y, inf = self.g1.to_affine(P)
        xs, ys = self.F.unpack(x), self.F.unpack(y)
        infs = inf.cpu().numpy()
        return [None if infs[i] else (xs[i], ys[i]) for i in range(len(xs))]

    def pack_g2(self, pts):
        f20, f21 = (0, 0), (1, 0)
        xs = [f20 if p is None else p[0] for p in pts]
        ys = [f21 if p is None else p[1] for p in pts]
        zs = [f20 if p is None else f21 for p in pts]
        return (self.T.f2_pack(xs), self.T.f2_pack(ys), self.T.f2_pack(zs))

    def unpack_g2(self, P):
        x, y, inf = self.g2.to_affine(P)
        xs, ys = self.T.f2_unpack(x), self.T.f2_unpack(y)
        infs = inf.cpu().numpy()
        return [None if infs[i] else (xs[i], ys[i]) for i in range(len(xs))]

    def scalar_bits(self, ks, nbits: int = 256) -> torch.Tensor:
        """Host: ints -> (nbits, len(ks)) int32 MSB-first bit tensor."""
        nwords = (nbits + 31) // 32
        words = np.empty((nwords, len(ks)), np.uint32)
        for w in range(nwords):
            words[w] = [(k >> (32 * w)) & 0xFFFFFFFF for k in ks]
        shifts = np.arange(31, -1, -1, dtype=np.uint32)
        bits = (words[:, None, :] >> shifts[None, :, None]) & np.uint32(1)
        bits = bits[::-1].reshape(nwords * 32, len(ks))[nwords * 32 - nbits :]
        return torch.from_numpy(bits.astype(np.int32)).to(self.device)

    @staticmethod
    def scalar_bits64_np(ks) -> np.ndarray:
        """Host: scalars below 2^64 -> (64, len(ks)) int32 MSB-first bit
        columns, through numpy uint64 (torch has no unsigned 64-bit shift)."""
        a = np.asarray(ks, dtype=np.uint64)
        shifts = np.arange(63, -1, -1, dtype=np.uint64)
        return ((a[None, :] >> shifts[:, None]) & np.uint64(1)).astype(np.int32)

    def scalar_bits64(self, ks) -> torch.Tensor:
        """`scalar_bits64_np` on this field's device: the RLC launch's
        per-candidate random-coefficient operand."""
        return torch.from_numpy(self.scalar_bits64_np(ks)).to(self.device)


class BLS12Curves(BN254Curves):
    """BLS12-381 binding: E: y^2 = x^3 + 4 (b3 = 12) over the 381-bit field
    (24 limbs), E'(Fp2) with the M-type twist coefficient 4(1+i)
    (ops/bls12_381_ref.py TWIST_B)."""

    params = _bls
    g1_b3 = 12
