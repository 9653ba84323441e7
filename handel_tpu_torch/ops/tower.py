"""Extension-field tower Fp2 -> Fp6 -> Fp12 on limb tensors — counterpart of
handel_tpu/ops/tower.py.

Every tower multiplication flattens its independent base-field
multiplications into the batch dimension and issues one `Field.mul`:

    Fp12 mul = 3 Fp6 muls = 18 Fp2 muls = 54 Fp muls -> ONE Field.mul at 54xB

and the independent adds/subs of a formula go through one wide Field call
each, the reference's batch stacking, kept so the kernel sees wide launches
and the launch count stays low. Elements are tuples of (nlimbs, B) int32
tensors: Fp2 = (c0, c1), Fp6 = (Fp2, Fp2, Fp2), Fp12 = (Fp6, Fp6), all
Montgomery form and canonical, except under the resident adapter
(`Tower.as_resident()`, ops/rns.py `ResidentRns`), where each coordinate is
a (k_all, B) int32 residue plane bounded by 2^lb p for a statically tracked
lb. The `blog` argument of each subtraction site is that site's subtrahend
bound; the positional fields ignore it.
"""

from __future__ import annotations

import torch

from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops.fp import DEFAULT_POW_WINDOW, Field, windowed_pow


def _cat(xs):
    return torch.cat(xs, dim=1)


def _split(x, k):
    b = x.shape[1] // k
    return [x[:, i * b : (i + 1) * b] for i in range(k)]


class Tower:
    """Fp2/Fp6/Fp12 arithmetic over a base Field (i^2 = -1, v^3 = xi,
    w^2 = v). `params` is the scalar-oracle module of the curve family
    (P, XI, _GAMMA, U); BN254 by default."""

    def __init__(self, field: Field | None = None, params=bn, device=None):
        self.params = params
        self.F = field or Field(params.P, device=device)
        self.xi = tuple(params.XI)
        if self.xi not in ((9, 1), (1, 1)):
            raise ValueError(f"unsupported Fp6 non-residue xi={self.xi}")
        # Frobenius constants gamma_j = xi^(j(p-1)/6) as Montgomery limb
        # pairs, one pack each (one counted conversion on the resident form)
        self._gamma = [None] + [
            tuple(self.F.pack([g[0], g[1]])[:, i : i + 1] for i in range(2))
            for g in params._GAMMA[1:]
        ]

    _cat = staticmethod(_cat)
    _split = staticmethod(_split)

    def _add_n(self, lhs, rhs):
        """[(a_i + b_i)] for equal-width limb arrays — one Field.add."""
        if len(lhs) == 1:
            return [self.F.add(lhs[0], rhs[0])]
        return _split(self.F.add(_cat(lhs), _cat(rhs)), len(lhs))

    def _sub_n(self, lhs, rhs, blog=None):
        if len(lhs) == 1:
            return [self.F.sub(lhs[0], rhs[0], blog)]
        return _split(self.F.sub(_cat(lhs), _cat(rhs), blog), len(lhs))

    # -- Fp2 -----------------------------------------------------------------

    def f2_add(self, a, b):
        c0, c1 = _split(self.F.add(_cat([a[0], a[1]]), _cat([b[0], b[1]])), 2)
        return (c0, c1)

    def f2_sub(self, a, b, blog=None):
        c = self.F.sub(_cat([a[0], a[1]]), _cat([b[0], b[1]]), blog)
        c0, c1 = _split(c, 2)
        return (c0, c1)

    def f2_neg(self, a, blog=None):
        z = _cat([a[0], a[1]])
        c0, c1 = _split(self.F.sub(torch.zeros_like(z), z, blog), 2)
        return (c0, c1)

    def f2_conj(self, a, blog=None):
        return (a[0], self.F.neg(a[1], blog))

    def f2_add_many(self, pairs):
        """[(a+b)] for a list of Fp2 pairs — one Field.add total."""
        out = self._add_n(
            [p[0][0] for p in pairs] + [p[0][1] for p in pairs],
            [p[1][0] for p in pairs] + [p[1][1] for p in pairs],
        )
        k = len(pairs)
        return [(out[i], out[k + i]) for i in range(k)]

    def f2_sub_many(self, pairs, blog=None):
        out = self._sub_n(
            [p[0][0] for p in pairs] + [p[0][1] for p in pairs],
            [p[1][0] for p in pairs] + [p[1][1] for p in pairs],
            blog,
        )
        k = len(pairs)
        return [(out[i], out[k + i]) for i in range(k)]

    def f2_mul(self, a, b):
        """Karatsuba: 3 base muls in one stacked call.
        (a0+a1 i)(b0+b1 i) = (a0b0 - a1b1) + ((a0+a1)(b0+b1) - a0b0 - a1b1) i"""
        F = self.F
        sa, sb = _split(F.add(_cat([a[0], b[0]]), _cat([a[1], b[1]])), 2)
        v0, v1, v2 = _split(
            F.mul(_cat([a[0], a[1], sa]), _cat([b[0], b[1], sb])), 3
        )
        c0, t = _split(F.sub(_cat([v0, v2]), _cat([v1, v0]), 6), 2)
        return (c0, F.sub(t, v1, 6))

    def f2_sqr(self, a):
        """(a0+a1 i)^2 = (a0+a1)(a0-a1) + 2 a0 a1 i — 2 base muls."""
        F = self.F
        m = F.add(a[0], a[1])
        s = F.sub(a[0], a[1], 24)
        c0, t = _split(F.mul(_cat([m, a[0]]), _cat([s, a[1]])), 2)
        return (c0, F.add(t, t))

    def f2_sqr_many(self, elems):
        """Square a list of Fp2 elements in ONE stacked f2_sqr call."""
        k = len(elems)
        s = self.f2_sqr((_cat([x[0] for x in elems]), _cat([x[1] for x in elems])))
        return list(zip(_split(s[0], k), _split(s[1], k)))

    def f2_mul_fp(self, a, s):
        """Fp2 element times a base-field element (2 base muls, stacked)."""
        c0, c1 = _split(self.F.mul(_cat([a[0], a[1]]), _cat([s, s])), 2)
        return (c0, c1)

    def _x9(self, z):
        """9*z by add chain (4 adds)."""
        F = self.F
        z2 = F.add(z, z)
        z4 = F.add(z2, z2)
        z8 = F.add(z4, z4)
        return F.add(z8, z)

    def f2_mul_xi(self, a, blog=None):
        """Multiply by the Fp6 non-residue via add chains (no base mul):
        xi = 9+i: (9a0 - a1, 9a1 + a0); xi = 1+i: (a0 - a1, a0 + a1)."""
        F = self.F
        if self.xi == (1, 1):
            return (F.sub(a[0], a[1], blog), F.add(a[0], a[1]))
        n90, n91 = _split(self._x9(_cat([a[0], a[1]])), 2)
        return (F.sub(n90, a[1], blog), F.add(n91, a[0]))

    def f2_mul_xi_many(self, elems, blog=None):
        """xi * e for a list of Fp2 elements — one stacked chain."""
        k = len(elems)
        c0s = _cat([e[0] for e in elems])
        c1s = _cat([e[1] for e in elems])
        if self.xi == (1, 1):
            d = self.F.sub(c0s, c1s, blog)
            s = self.F.add(c0s, c1s)
            return list(zip(_split(d, k), _split(s, k)))
        parts = _split(self._x9(_cat([c0s, c1s])), 2 * k)
        d = self.F.sub(_cat(parts[:k]), c1s, blog)
        s = self.F.add(_cat(parts[k:]), c0s)
        return list(zip(_split(d, k), _split(s, k)))

    def f2_inv(self, a):
        """1/(a0+a1 i) = (a0 - a1 i)/(a0^2+a1^2)."""
        F = self.F
        den = F.add(F.mul(a[0], a[0]), F.mul(a[1], a[1]))
        inv = F.inv(den)
        return (F.mul(a[0], inv), F.neg(F.mul(a[1], inv), 6))

    def f2_select(self, mask, a, b):
        return (self.F.select(mask, a[0], b[0]), self.F.select(mask, a[1], b[1]))

    def f2_eq(self, a, b):
        return self.F.eq(a[0], b[0]) & self.F.eq(a[1], b[1])

    def f2_is_zero(self, a):
        return self.F.is_zero(a[0]) & self.F.is_zero(a[1])

    def f2_zero(self, batch: int):
        z = torch.zeros(
            (self.F.nlimbs, batch), dtype=self.F.limb_dtype, device=self.F.device
        )
        return (z, z)

    def f2_one(self, batch: int):
        return (self.F.constant(1, batch), self.f2_zero(batch)[1])

    def f2_constant(self, c, batch: int):
        """Embed a scalar-oracle Fp2 value (int pair) as broadcast limbs. On
        the resident form each coordinate crosses through `to_resident`, as
        in the reference (one counted conversion each), from the cached
        positional limbs."""
        F = self.F
        if getattr(F, "is_resident", False):
            return tuple(
                F.base.to_resident(F.base.constant(x, 1)).expand(F.nlimbs, batch)
                for x in c
            )
        return (F.constant(c[0], batch), F.constant(c[1], batch))

    # -- Fp2 stacking helpers --------------------------------------------------

    def _f2_stack(self, elems):
        """Concatenate Fp2 elements along the batch axis."""
        return (_cat([e[0] for e in elems]), _cat([e[1] for e in elems]))

    def _f2_unstack(self, e, k):
        return list(zip(_split(e[0], k), _split(e[1], k)))

    # -- Fp6 -------------------------------------------------------------------

    def f6_add(self, a, b):
        return tuple(self.f2_add_many(list(zip(a, b))))

    def f6_sub(self, a, b, blog=None):
        return tuple(self.f2_sub_many(list(zip(a, b)), blog))

    def f6_neg(self, a, blog=None):
        z = _cat([a[i][j] for i in range(3) for j in range(2)])
        parts = _split(self.F.sub(torch.zeros_like(z), z, blog), 6)
        return ((parts[0], parts[1]), (parts[2], parts[3]), (parts[4], parts[5]))

    def f6_mul(self, a, b):
        """Toom/Karatsuba: 6 Fp2 muls in ONE stacked f2_mul call; all
        interpolation adds/subs stacked."""
        a0, a1, a2 = a
        b0, b1, b2 = b
        s = self.f2_add_many(
            [(a1, a2), (a0, a1), (a0, a2), (b1, b2), (b0, b1), (b0, b2)]
        )
        lhs = self._f2_stack([a0, a1, a2, s[0], s[1], s[2]])
        rhs = self._f2_stack([b0, b1, b2, s[3], s[4], s[5]])
        t0, t1, t2, u0, u1, u2 = self._f2_unstack(self.f2_mul(lhs, rhs), 6)
        w = self.f2_add_many([(t1, t2), (t0, t1), (t0, t2)])
        d0, d1, d2 = self.f2_sub_many([(u0, w[0]), (u1, w[1]), (u2, w[2])], 9)
        x0, x2 = self.f2_mul_xi_many([d0, t2], 10)  # xi*(u0-t1-t2), xi*t2
        c0, c1, c2 = self.f2_add_many([(t0, x0), (d1, x2), (d2, t1)])
        return (c0, c1, c2)

    def f6_mul_v(self, a, blog=None):
        """(c0,c1,c2) * v = (xi*c2, c0, c1)."""
        return (self.f2_mul_xi(a[2], blog), a[0], a[1])

    def f6_inv(self, a):
        a0, a1, a2 = a
        t0 = self.f2_sub(self.f2_sqr(a0), self.f2_mul_xi(self.f2_mul(a1, a2), 8), 13)
        t1 = self.f2_sub(self.f2_mul_xi(self.f2_sqr(a2), 7), self.f2_mul(a0, a1), 8)
        t2 = self.f2_sub(self.f2_sqr(a1), self.f2_mul(a0, a2), 8)
        den = self.f2_add(
            self.f2_mul(a0, t0),
            self.f2_mul_xi(self.f2_add(self.f2_mul(a2, t1), self.f2_mul(a1, t2)), 9),
        )
        inv = self.f2_inv(den)
        return (self.f2_mul(t0, inv), self.f2_mul(t1, inv), self.f2_mul(t2, inv))

    def f6_zero(self, batch):
        return (self.f2_zero(batch),) * 3

    def f6_one(self, batch):
        return (self.f2_one(batch), self.f2_zero(batch), self.f2_zero(batch))

    def f6_select(self, mask, a, b):
        return tuple(self.f2_select(mask, x, y) for x, y in zip(a, b))

    # -- Fp12 ------------------------------------------------------------------

    def f12_mul(self, a, b):
        """Karatsuba over Fp6: 3 Fp6 muls -> one stacked f6_mul (54x batch);
        the six Karatsuba input sums in one add call."""
        a0, a1 = a
        b0, b1 = b
        s = self.f2_add_many(
            [(a0[i], a1[i]) for i in range(3)] + [(b0[i], b1[i]) for i in range(3)]
        )
        lhs = tuple(self._f2_stack([a0[i], a1[i], s[i]]) for i in range(3))
        rhs = tuple(self._f2_stack([b0[i], b1[i], s[3 + i]]) for i in range(3))
        prod = self.f6_mul(lhs, rhs)
        v0, v1, v2 = (tuple(v) for v in zip(*(self._f2_unstack(c, 3) for c in prod)))
        c0 = self.f6_add(v0, self.f6_mul_v(v1, 16))
        # c1 = v2 - v0 - v1: six components, two stacked sub calls
        d = self.f2_sub_many(list(zip(v2, v0)), 16)
        c1 = tuple(self.f2_sub_many(list(zip(d, v1)), 16))
        return (c0, c1)

    def f12_sqr(self, a):
        return self.f12_mul(a, a)

    def f12_cyclo_sqr(self, a):
        """Granger–Scott squaring, valid only in the cyclotomic subgroup
        (after the easy part of the final exponentiation): 9 Fp2 squarings
        fused into ONE width-9B f2_sqr call. On the resident form the input
        is refreshed first (one stacked multiply by the Montgomery one): the
        formula subtracts input coordinates from derived terms, so it needs a
        small input bound; the output is <= 2^18 p."""
        if getattr(self.F, "is_resident", False):
            a = self._f12_refresh(a)
        x0, x1, x2 = a[0]
        x3, x4, x5 = a[1]
        s40, s23, s51 = self.f2_add_many([(x4, x0), (x2, x3), (x5, x1)])
        q4, q0, q40, q2, q3, q23, q5, q1, q51 = self.f2_sqr_many(
            [x4, x0, s40, x2, x3, s23, x5, x1, s51]
        )
        d = self.f2_sub_many([(q40, q4), (q23, q2), (q51, q5)], 7)
        t6, t7, t8 = self.f2_sub_many([(d[0], q0), (d[1], q3), (d[2], q1)], 7)
        xt8, xt4, xt2, xt5 = self.f2_mul_xi_many([t8, q4, q2, q5], 9)
        u0, u1, u2 = self.f2_add_many([(xt4, q0), (xt2, q3), (xt5, q1)])
        w = self.f2_sub_many([(u0, x0), (u1, x1), (u2, x2)], 6)
        w += self.f2_add_many([(xt8, x3), (t6, x4), (t7, x5)])
        w2 = self.f2_add_many([(t, t) for t in w])
        z = self.f2_add_many(list(zip(w2, (u0, u1, u2, xt8, t6, t7))))
        return ((z[0], z[1], z[2]), (z[3], z[4], z[5]))

    def f12_add(self, a, b):
        return (self.f6_add(a[0], b[0]), self.f6_add(a[1], b[1]))

    def f12_conj(self, a, blog=None):
        return (a[0], self.f6_neg(a[1], blog))

    def f12_inv(self, a):
        den = self.f6_inv(
            self.f6_sub(
                self.f6_mul(a[0], a[0]),
                self.f6_mul_v(self.f6_mul(a[1], a[1]), 16),
                21,
            )
        )
        return (self.f6_mul(a[0], den), self.f6_neg(self.f6_mul(a[1], den), 16))

    def f12_zero(self, batch):
        return (self.f6_zero(batch), self.f6_zero(batch))

    def f12_one(self, batch):
        return (self.f6_one(batch), self.f6_zero(batch))

    def f12_select(self, mask, a, b):
        return (self.f6_select(mask, a[0], b[0]), self.f6_select(mask, a[1], b[1]))

    def f12_eq(self, a, b):
        out = None
        for x, y in zip(self._flatten12(a), self._flatten12(b)):
            e = self.F.eq(x, y)
            out = e if out is None else (out & e)
        return out

    def _flatten12(self, a):
        return [a[i][j][k] for i in range(2) for j in range(3) for k in range(2)]

    def _f12_refresh(self, a):
        """Resident only: reset all 12 coordinate bounds to <= 2^6 p in one
        stacked refresh (12x the batch wide)."""
        parts = _split(self.F.refresh(_cat(self._flatten12(a))), 12)
        return (
            ((parts[0], parts[1]), (parts[2], parts[3]), (parts[4], parts[5])),
            ((parts[6], parts[7]), (parts[8], parts[9]), (parts[10], parts[11])),
        )

    def as_resident(self) -> "Tower":
        """A Tower over the resident form of this tower's RNS field: the same
        formulas on residue planes (cached)."""
        if not hasattr(self.F, "resident"):
            raise TypeError(
                f"as_resident() needs the 'rns' field backend; this tower's "
                f"field is {self.F.backend!r}"
            )
        cached = getattr(self, "_resident_tower", None)
        if cached is None:
            cached = self._resident_tower = Tower(self.F.resident(), params=self.params)
        return cached

    def f12_frobenius(self, a):
        """x -> x^p: conjugate each Fp2 coordinate (one stacked neg), multiply
        the w-degree-j slots by gamma_j (one f2_mul, 5 wide). On the resident
        form the w^0 slot is multiplied by one as well (6 wide, the same one
        call), so every output slot is a product with its bound reset to
        <= 2^8 p and chained Frobenius maps cannot pile bounds up."""
        (c00, c01, c02), (c10, c11, c12) = a
        batch = c00[0].shape[1]
        coords = [c00, c01, c02, c10, c11, c12]
        z = _cat([c[1] for c in coords])
        negs = _split(self.F.sub(torch.zeros_like(z), z, 22), 6)
        conj = [(coords[i][0], negs[i]) for i in range(6)]
        n = self.F.nlimbs

        def g(j):
            g0, g1 = self._gamma[j]
            return (g0.expand(n, batch), g1.expand(n, batch))

        if getattr(self.F, "is_resident", False):
            lhs = self._f2_stack(conj)
            rhs = self._f2_stack([self.f2_one(batch), g(2), g(4), g(1), g(3), g(5)])
            m = self._f2_unstack(self.f2_mul(lhs, rhs), 6)
            return ((m[0], m[1], m[2]), (m[3], m[4], m[5]))
        lhs = self._f2_stack(conj[1:])
        rhs = self._f2_stack([g(2), g(4), g(1), g(3), g(5)])
        m01, m02, m10, m11, m12 = self._f2_unstack(self.f2_mul(lhs, rhs), 5)
        return ((conj[0], m01, m02), (m10, m11, m12))

    def f12_frobenius2(self, a):
        return self.f12_frobenius(self.f12_frobenius(a))

    def f12_pow_const(self, a, e: int, cyclo: bool = False,
                      window: int = DEFAULT_POW_WINDOW):
        """a^e for a fixed public exponent; cyclo=True uses the cyclotomic
        squaring (only valid in the cyclotomic subgroup)."""
        sqr = self.f12_cyclo_sqr if cyclo else self.f12_sqr
        return windowed_pow(a, e, window, mul=self.f12_mul, sqr=sqr)

    def f12_pow_u(self, a, cyclo: bool = False):
        """a^U for the BN parameter U (BN towers only)."""
        U = getattr(self.params, "U", None)
        if U is None:
            raise TypeError(
                f"f12_pow_u needs a BN parameter set with U; "
                f"{getattr(self.params, '__name__', self.params)} has none"
            )
        return self.f12_pow_const(a, U, cyclo=cyclo)

    # -- host conversions --------------------------------------------------------

    def f2_pack(self, vals):
        """List of scalar-oracle Fp2 values -> batched limb Fp2."""
        return (self.F.pack([v[0] for v in vals]), self.F.pack([v[1] for v in vals]))

    def f2_unpack(self, a):
        return list(zip(self.F.unpack(a[0]), self.F.unpack(a[1])))

    def f12_pack(self, vals):
        """List of scalar-oracle Fp12 values -> batched limb Fp12."""
        return tuple(
            tuple(self.f2_pack([v[i][j] for v in vals]) for j in range(3))
            for i in range(2)
        )

    def f12_unpack(self, a):
        flat = [self.f2_unpack(a[i][j]) for i in range(2) for j in range(3)]
        return [
            ((flat[0][k], flat[1][k], flat[2][k]), (flat[3][k], flat[4][k], flat[5][k]))
            for k in range(len(flat[0]))
        ]
