"""Batched optimal-ate pairing for BN254 and BLS12-381 — counterpart of
handel_tpu/ops/pairing.py.

* Inversion-free Miller loop: the accumulator T runs in homogeneous
  projective coordinates on the twist E'(Fp2); each step emits a sparse line
  with Fp2 coefficients in the (1, w, w^3) slots, scaled by Fp2 factors that
  the final exponentiation kills.
* The loop runs over the static bits of 6u+2 (MSB first, the top bit taken
  by the initialization). The reference computes the doubling and the
  addition at every step and selects, because its `lax.scan` body is traced
  once; here the bit is a public Python constant, so only the taken branch
  runs. The result is bit-identical and the card sees fewer launches.
* Every step is a handful of stacked `Field.mul` calls (ops/tower.py), so
  the Montgomery kernel sees wide launches even at small batches.
* A (B,) validity mask selects f = 1 for masked lanes (infinity, padding).
* `pairing_check` multiplies each candidate's Miller values and runs one
  shared final exponentiation on the product.
* Resident mode (the rns field backend, on by default there): the Miller
  loop and the final exponentiation run on residue planes through
  `Tower.as_resident()`; positional limbs appear only at the boundaries
  (points in, GT element or verdict out), each one stacked conversion.
* `BLS12Pairing` rebinds the family: the same step formulas over the
  381-bit field, the M-type twist's line slots, a conjugation for z < 0 in
  place of the ate corrections, and the BLS12 hard part, which computes
  the cubed pairing (ops/bls12_381_ref.py `final_exponentiation`).
"""

from __future__ import annotations

import torch

from handel_tpu_torch.ops import bls12_381_ref as bls
from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops.curve import BLS12Curves, BN254Curves, _tree_map

# MSB-first bits of the ate loop count 6u+2, top bit dropped (consumed by the
# Miller-loop initialization T = Q, f = 1)
_ATE_BITS = [int(c) for c in bin(bn.ATE_LOOP_COUNT)[3:]]


class BN254Pairing:
    """Batched optimal-ate pairing over the shared Field/Tower/Curves stack."""

    def __init__(self, curves: BN254Curves | None = None, device=None,
                 resident: bool | None = None):
        self.curves = curves or self._default_curves(device)
        self.F = self.curves.F
        self.T = self.curves.T
        # residue-resident mode: None = on exactly for the 'rns' backend
        if resident is None:
            resident = self.F.backend == "rns"
        elif resident and self.F.backend != "rns":
            raise ValueError(
                f"resident pairing needs the 'rns' field backend (got "
                f"{self.F.backend!r}): construct the curves with "
                f"backend='rns', or pass resident=False"
            )
        self.resident = resident
        # every internal tower call goes through _Tw; the entry points
        # convert at the boundaries when it is the resident tower
        self._Tw = self.T.as_resident() if resident else self.T
        # psi-Frobenius constants of the ate correction points
        # (bn254_ref.miller_loop_projective: gamma_2 for x, gamma_3 for y)
        self._g2c = self.curves.params._GAMMA[2]
        self._g3c = self.curves.params._GAMMA[3]

    @classmethod
    def _default_curves(cls, device):
        return BN254Curves(device=device)

    # -- small helpers -------------------------------------------------------

    def _mm(self, pairs):
        """Stack independent Fp2 multiplications into one f2_mul call."""
        T = self._Tw
        lhs = T._f2_stack([p[0] for p in pairs])
        rhs = T._f2_stack([p[1] for p in pairs])
        return T._f2_unstack(T.f2_mul(lhs, rhs), len(pairs))

    def _points_in(self, p, q):
        """Boundary in: the six point-coordinate tensors convert to residues
        in one stacked to_resident (no-op when positional)."""
        if not self.resident:
            return p, q
        (xp, yp), (xq, yq) = p, q
        b = xp.shape[1]
        r = self.F.to_resident(torch.cat([xp, yp, xq[0], xq[1], yq[0], yq[1]], dim=1))
        parts = [r[:, i * b : (i + 1) * b] for i in range(6)]
        return (parts[0], parts[1]), ((parts[2], parts[3]), (parts[4], parts[5]))

    def _f12_out(self, f):
        """Boundary out: a resident Fp12 element back to canonical limbs in
        one stacked from_resident, 12 coordinates wide (passthrough when
        positional)."""
        if not self.resident:
            return f
        flat = self._Tw._flatten12(f)
        b = flat[0].shape[1]
        v = self.F.from_resident(torch.cat(flat, dim=1))
        p = [v[:, i * b : (i + 1) * b] for i in range(12)]
        return (
            ((p[0], p[1]), (p[2], p[3]), (p[4], p[5])),
            ((p[6], p[7]), (p[8], p[9]), (p[10], p[11])),
        )

    @staticmethod
    def _dbl_n(T, a, k: int):
        """a * 2^k by repeated addition."""
        for _ in range(k):
            a = T.f2_add(a, a)
        return a

    def _line_f12(self, line, batch):
        """Sparse line (yp-term, xp-term, constant) -> full Fp12 element at
        w-degree slots 0, 1, 3 (D-twist untwist)."""
        c_yp, c_xp, c_const = line
        z = self._Tw.f2_zero(batch)
        return ((c_yp, z, z), (c_xp, c_const, z))

    # -- Miller-loop steps (bn254_ref.miller_loop_projective dbl/add) --------

    def _dbl_step(self, Tpt, xp, yp):
        """Doubling step: new T and the tangent line at T evaluated at
        P = (xp, yp), scaled by 2YZ^3."""
        Tw = self._Tw
        X, Y, Z = Tpt
        XX, YY, YZ = self._mm([(X, X), (Y, Y), (Y, Z)])
        n = Tw.f2_add(Tw.f2_add(XX, XX), XX)  # 3X^2
        d = Tw.f2_add(YZ, YZ)  # 2YZ
        nn, dd, YYZ, YZZ, nZ, nX = self._mm(
            [(n, n), (d, d), (YY, Z), (YZ, Z), (n, Z), (n, X)]
        )
        XYYZ, ddd = self._mm([(X, YYZ), (dd, d)])
        e = Tw.f2_sub(nn, self._dbl_n(Tw, XYYZ, 3), 11)  # n^2 - 8XY^2Z
        XYYZ12 = Tw.f2_add(self._dbl_n(Tw, XYYZ, 3), self._dbl_n(Tw, XYYZ, 2))
        zero = Tw.f2_zero(xp.shape[1])[0]
        X3, t, YYZ2, c0, cw = self._mm(
            [
                (e, d),
                (n, Tw.f2_sub(XYYZ12, nn, 8)),  # n*(12XY^2Z - n^2)
                (YYZ, YYZ),  # Y^4 Z^2
                (YZZ, (yp, zero)),
                (nZ, (xp, zero)),
            ]
        )
        Y3 = Tw.f2_sub(t, self._dbl_n(Tw, YYZ2, 3), 11)
        line = (
            Tw.f2_add(c0, c0),  # 2YZ^2 * yp
            Tw.f2_neg(cw, 8),  # -3X^2 Z * xp
            Tw.f2_sub(nX, Tw.f2_add(YYZ, YYZ), 9),  # 3X^3 - 2Y^2 Z
        )
        return (X3, Y3, ddd), line

    def _add_step(self, Tpt, Q, xp, yp):
        """Mixed-addition step T + Q (Q affine) and the line through them
        evaluated at P, scaled by d = x2 Z - X."""
        Tw = self._Tw
        X, Y, Z = Tpt
        x2, y2 = Q
        y2Z, x2Z = self._mm([(y2, Z), (x2, Z)])
        n = Tw.f2_sub(y2Z, Y, 12)
        d = Tw.f2_sub(x2Z, X, 8)
        zero = Tw.f2_zero(xp.shape[1])[0]
        dd, nn, nx2, dy2, c0, cw = self._mm(
            [(d, d), (n, n), (n, x2), (d, y2), (d, (yp, zero)), (n, (xp, zero))]
        )
        nnZ, Xdd, ddd, x2Zdd = self._mm(
            [(nn, Z), (Tw.f2_add(X, x2Z), dd), (dd, d), (x2Z, dd)]
        )
        e = Tw.f2_sub(nnZ, Xdd, 8)
        X3, t, y2Zddd, Z3 = self._mm(
            [(e, d), (n, Tw.f2_sub(x2Zdd, e, 9)), (y2Z, ddd), (Z, ddd)]
        )
        Y3 = Tw.f2_sub(t, y2Zddd, 8)
        line = (c0, Tw.f2_neg(cw, 8), Tw.f2_sub(nx2, dy2, 8))
        return (X3, Y3, Z3), line

    # -- Miller loop ---------------------------------------------------------

    # the loop bits (overridden per curve family)
    _LOOP_BITS = _ATE_BITS

    def miller_loop(self, p, q, mask=None):
        """Batched Miller loop. p: (xp, yp) base-field limb tensors (G1
        affine); q: (x, y) Fp2 pairs (G2' affine); mask: optional (B,) bool,
        lanes with False return f = 1. Returns an Fp12 batch of canonical
        limbs in either mode."""
        return self._f12_out(self._miller_loop_res(p, q, mask))

    def _miller_loop_res(self, p, q, mask=None):
        """`miller_loop` in the working representation (residue planes when
        resident), the form `pairing` and `pairing_check` chain on."""
        Tw = self._Tw
        p, q = self._points_in(p, q)
        xp, yp = p
        xq, yq = q
        batch = xp.shape[1]
        Tpt = (xq, yq, Tw.f2_one(batch))
        f = Tw.f12_one(batch)
        for bit in self._LOOP_BITS:
            f = Tw.f12_sqr(f)
            Tpt, line = self._dbl_step(Tpt, xp, yp)
            f = Tw.f12_mul(f, self._line_f12(line, batch))
            if bit:
                Tpt, line = self._add_step(Tpt, (xq, yq), xp, yp)
                f = Tw.f12_mul(f, self._line_f12(line, batch))
        f = self._miller_tail(Tpt, f, (xq, yq), xp, yp, batch)
        if mask is not None:
            f = Tw.f12_select(mask, f, Tw.f12_one(batch))
        return f

    def _miller_tail(self, Tpt, f, q, xp, yp, batch):
        """BN ate corrections: add psi(Q) and -psi^2(Q) on the twist."""
        Tw = self._Tw
        xq, yq = q
        g2 = Tw.f2_constant(self._g2c, batch)
        g3 = Tw.f2_constant(self._g3c, batch)
        q1x, q1y = self._mm([(Tw.f2_conj(xq, 0), g2), (Tw.f2_conj(yq, 0), g3)])
        q2x, q2y = self._mm([(Tw.f2_conj(q1x, 8), g2), (Tw.f2_conj(q1y, 8), g3)])
        q2y = Tw.f2_neg(q2y, 8)  # q2 = -psi^2(Q)
        Tpt, line = self._add_step(Tpt, (q1x, q1y), xp, yp)
        f = Tw.f12_mul(f, self._line_f12(line, batch))
        _, line = self._add_step(Tpt, (q2x, q2y), xp, yp)
        return Tw.f12_mul(f, self._line_f12(line, batch))

    # -- final exponentiation ------------------------------------------------

    def final_exp(self, f):
        """f^((p^12-1)/r): easy part by conjugation/Frobenius and one Fp12
        inversion, hard part by the BN addition chain with cyclotomic
        squarings (bn254_ref.final_exponentiation)."""
        Tw = self._Tw
        f = Tw.f12_mul(Tw.f12_conj(f, 22), Tw.f12_inv(f))  # f^(p^6-1)
        f = Tw.f12_mul(Tw.f12_frobenius2(f), f)  # ^(p^2+1)
        fu = Tw.f12_pow_u(f, cyclo=True)
        fu2 = Tw.f12_pow_u(fu, cyclo=True)
        fu3 = Tw.f12_pow_u(fu2, cyclo=True)
        fp = Tw.f12_frobenius(f)
        fp2 = Tw.f12_frobenius(fp)
        fp3 = Tw.f12_frobenius(fp2)
        y0 = Tw.f12_mul(Tw.f12_mul(fp, fp2), fp3)
        y1 = Tw.f12_conj(f, 22)
        y2 = Tw.f12_frobenius2(fu2)
        y3 = Tw.f12_conj(Tw.f12_frobenius(fu), 22)
        y4 = Tw.f12_conj(Tw.f12_mul(fu, Tw.f12_frobenius(fu2)), 22)
        y5 = Tw.f12_conj(fu2, 22)
        y6 = Tw.f12_conj(Tw.f12_mul(fu3, Tw.f12_frobenius(fu3)), 22)
        t0 = Tw.f12_mul(Tw.f12_mul(Tw.f12_cyclo_sqr(y6), y4), y5)
        t1 = Tw.f12_mul(Tw.f12_mul(y3, y5), t0)
        t0 = Tw.f12_mul(t0, y2)
        t1 = Tw.f12_mul(Tw.f12_cyclo_sqr(t1), t0)
        t1 = Tw.f12_cyclo_sqr(t1)
        t0 = Tw.f12_mul(t1, y1)
        t1 = Tw.f12_mul(t1, y0)
        t0 = Tw.f12_cyclo_sqr(t0)
        return Tw.f12_mul(t0, t1)

    # -- entry points ----------------------------------------------------------

    def pairing(self, p, q, mask=None):
        """Batched e(P, Q) in GT; masked lanes give 1. A resident run stays
        in residues from the points in to the GT element out."""
        return self._f12_out(self.final_exp(self._miller_loop_res(p, q, mask)))

    def gt_is_one(self, f):
        """(B,) bool: lane-wise comparison with the GT identity. Comparison
        is a positional boundary: a resident element (k_all rows) converts
        first."""
        if self.resident and f[0][0][0].shape[0] == self.F.k_all:
            f = self._f12_out(f)
        batch = f[0][0][0].shape[1]
        return self.T.f12_eq(f, self.T.f12_one(batch))

    def pairing_check(self, p, q, mask, groups: int):
        """Product-of-pairings verdicts for `groups` candidates.

        Pair-chunk-major layout: lane i*groups + j holds pair i of candidate
        j. Computes prod_i e(P_ij, Q_ij) per candidate with one shared final
        exponentiation; returns (groups,) bools. Masked lanes contribute 1.
        A resident run keeps residues through the per-candidate product and
        the final exponentiation; the verdict is its one conversion out."""
        return self.check_product(self._miller_loop_res(p, q, mask), groups)

    def check_product(self, f, groups: int):
        """`pairing_check` after its Miller loop: `f` in the working
        representation (as `_miller_loop_res` returns it), each candidate's
        pair lanes multiplied, one shared final exponentiation, the
        comparison with 1. Returns (groups,) bools."""
        per = f[0][0][0].shape[1] // groups

        def chunk(i):
            return _tree_map(lambda a: a[:, i * groups : (i + 1) * groups], f)

        acc = chunk(0)
        for i in range(1, per):
            acc = self._Tw.f12_mul(acc, chunk(i))
        return self.gt_is_one(self.final_exp(acc))


class BLS12Pairing(BN254Pairing):
    """Batched optimal-ate pairing for BLS12-381 (ops/bls12_381_ref.py).

    The projective dbl/add step formulas and their (yp-term, xp-term,
    constant) lines are the BN254 engine's; what changes is:

      * loop bits: |z| (z = -0xd201..., 63 bits after the top one, 5 of
        them set), then one conjugation because z < 0, no ate corrections;
      * line slots: the M-type twist's untwist puts the coefficients at
        w-degrees (0, 2, 3) = Fp12 slots a0[0], a0[1], a1[1], with the
        constant at w^0 (the D-twist puts the yp-term there);
      * final exponentiation: the BLS12 hard part
        (z-1)^2 (z+p) (z^2+p^2-1) + 3, which computes the cubed pairing, a
        bilinear substitute since gcd(3, r) = 1.
    """

    _LOOP_BITS = [int(c) for c in bin(-bls.Z)[3:]]

    @classmethod
    def _default_curves(cls, device):
        return BLS12Curves(device=device)

    def _line_f12(self, line, batch):
        c_yp, c_xp, c_const = line
        z = self._Tw.f2_zero(batch)
        return ((c_const, c_xp, z), (z, c_yp, z))

    def _miller_tail(self, Tpt, f, q, xp, yp, batch):
        # z < 0: f_z = 1/f_{|z|} up to the final exponentiation, so
        # conjugate (resident: the accumulator sits at <= 2^22 p)
        return self._Tw.f12_conj(f, 22)

    def _pow_z(self, x):
        """x^z in the cyclotomic subgroup (z < 0: x^|z|, then conjugate)."""
        return self._Tw.f12_conj(self._Tw.f12_pow_const(x, -bls.Z, cyclo=True), 22)

    def final_exp(self, f):
        """Easy part, then the BLS12 hard part through
        3(p^4-p^2+1)/r = (z-1)^2 (z+p) (z^2+p^2-1) + 3
        (bls12_381_ref.final_exponentiation) with cyclotomic squarings.
        Resident conjugation bounds: the Miller tail's conjugation leaves f
        <= 2^23 p, hence 23 in the easy part; after it every value is back
        at the <= 2^22 p multiply fixed point."""
        Tw = self._Tw
        f = Tw.f12_mul(Tw.f12_conj(f, 23), Tw.f12_inv(f))  # f^(p^6-1)
        f = Tw.f12_mul(Tw.f12_frobenius2(f), f)  # ^(p^2+1)
        t0 = Tw.f12_mul(self._pow_z(f), Tw.f12_conj(f, 22))  # f^(z-1)
        t1 = Tw.f12_mul(self._pow_z(t0), Tw.f12_conj(t0, 22))  # f^((z-1)^2)
        g = Tw.f12_mul(self._pow_z(t1), Tw.f12_frobenius(t1))  # ^(z+p)
        gz2 = self._pow_z(self._pow_z(g))
        h = Tw.f12_mul(Tw.f12_mul(gz2, Tw.f12_frobenius2(g)), Tw.f12_conj(g, 22))
        return Tw.f12_mul(h, Tw.f12_mul(Tw.f12_cyclo_sqr(f), f))  # * f^3
