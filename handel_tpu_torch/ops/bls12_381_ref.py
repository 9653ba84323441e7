"""Pure-Python BLS12-381: fields, curves, optimal ate pairing (scalar oracle)
— counterpart of handel_tpu/ops/bls12_381_ref.py.

The second pairing curve behind the Constructor interface. Same shape as
ops/bn254_ref.py: plain ints, clarity over speed, the ground truth for the
device tower, curves and pairing at 381 bits and the host scheme's math
(models/bls12_381.py).

Curve family differences from BN254 that this module encodes:
  * p, r from the BLS12 parameterization z = -0xd201000000010000:
      p = (z-1)^2 (z^4 - z^2 + 1)/3 + z,  r = z^4 - z^2 + 1
  * Fp2 = Fp[i]/(i^2+1); Fp6 = Fp2[v]/(v^3 - xi), xi = 1 + i;
    Fp12 = Fp6[w]/(w^2 - v)
  * E:  y^2 = x^3 + 4;   E'(Fp2): y^2 = x^3 + 4(1+i)  (M-type twist)
  * ate loop count = |z| (no correction lines: a plain Miller loop over the
    bits of |z|), with a final conjugation because z < 0.

Keys in G2, signatures in G1 — the same minimal-signature orientation as the
BN254 scheme. The generic affine group ops come from the port's own
ops/bn254_ref.py.
"""

from __future__ import annotations

# -- parameters -------------------------------------------------------------

Z = -0xD201000000010000  # BLS parameter (negative)
P = (
    0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
)
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

assert P == (Z - 1) ** 2 * (Z**4 - Z**2 + 1) // 3 + Z
assert R == Z**4 - Z**2 + 1
assert P % 4 == 3

B = 4  # E: y^2 = x^3 + 4

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)


# -- Fp2 = Fp[i]/(i^2+1) ----------------------------------------------------

F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (1, 1)  # Fp6 non-residue


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def f2_sqr(a):
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def f2_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)


def f2_conj(a):
    return (a[0], (-a[1]) % P)


def f2_inv(a):
    a0, a1 = a
    den = pow(a0 * a0 + a1 * a1, -1, P)
    return (a0 * den % P, (-a1) * den % P)


def f2_mul_xi(a):
    """(1+i)(a0 + a1 i) = (a0 - a1) + (a0 + a1) i."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


# -- Fp6 / Fp12 (same tower construction as bn254_ref, xi differs) ----------


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(
        t0,
        f2_mul_xi(
            f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))
        ),
    )
    c1 = f2_add(
        f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)),
        f2_mul_xi(t2),
    )
    c2 = f2_add(
        f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1
    )
    return (c0, c1, c2)


def f6_sqr(a):
    return f6_mul(a, a)


def f6_mul_v(a):
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    t0 = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)))
    t1 = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    t2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    den = f2_add(
        f2_mul(a0, t0), f2_mul_xi(f2_add(f2_mul(a2, t1), f2_mul(a1, t2)))
    )
    inv = f2_inv(den)
    return (f2_mul(t0, inv), f2_mul(t1, inv), f2_mul(t2, inv))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_v(t1))
    c1 = f6_sub(f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), t0), t1)
    return (c0, c1)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    a0, a1 = a
    den = f6_inv(f6_sub(f6_sqr(a0), f6_mul_v(f6_sqr(a1))))
    return (f6_mul(a0, den), f6_neg(f6_mul(a1, den)))


def f12_pow(a, e):
    result = F12_ONE
    base = a
    while e:
        if e & 1:
            result = f12_mul(result, base)
        base = f12_sqr(base)
        e >>= 1
    return result


F12_ZERO = (F6_ZERO, F6_ZERO)
F12_ONE = (F6_ONE, F6_ZERO)


def _f2_pow(a, e):
    result = F2_ONE
    base = a
    while e:
        if e & 1:
            result = f2_mul(result, base)
        base = f2_sqr(base)
        e >>= 1
    return result


_GAMMA = [None] + [_f2_pow(XI, j * (P - 1) // 6) for j in range(1, 6)]


def f12_frobenius(a):
    (c00, c01, c02), (c10, c11, c12) = a
    return (
        (
            f2_conj(c00),
            f2_mul(f2_conj(c01), _GAMMA[2]),
            f2_mul(f2_conj(c02), _GAMMA[4]),
        ),
        (
            f2_mul(f2_conj(c10), _GAMMA[1]),
            f2_mul(f2_conj(c11), _GAMMA[3]),
            f2_mul(f2_conj(c12), _GAMMA[5]),
        ),
    )


def f12_frobenius2(a):
    return f12_frobenius(f12_frobenius(a))


# -- curves (generic affine ops shared with bn254_ref) ----------------------

from handel_tpu_torch.ops.bn254_ref import (  # noqa: E402
    _FieldOps,
    pt_add,
    pt_is_on_curve,
    pt_mul,
    pt_neg,
)

FP_OPS = _FieldOps(
    lambda a, b: (a + b) % P,
    lambda a, b: (a - b) % P,
    lambda a, b: a * b % P,
    lambda a: a * a % P,
    lambda a: pow(a, -1, P),
    lambda a: (-a) % P,
    lambda a, k: a * k % P,
    0,
    1,
)
F2_OPS = _FieldOps(
    f2_add, f2_sub, f2_mul, f2_sqr, f2_inv, f2_neg, f2_scalar, F2_ZERO, F2_ONE
)

TWIST_B = f2_scalar(XI, B)  # E' coefficient: 4(1+i), M-type twist


def g1_add(p1, p2):
    return pt_add(FP_OPS, p1, p2)


def g1_mul(pt, k):
    return pt_mul(FP_OPS, pt, k)


def g1_neg(pt):
    return pt_neg(FP_OPS, pt)


def g1_is_valid(pt):
    """On curve and in the order-r subgroup (G1 cofactor is ~2^125)."""
    return pt_is_on_curve(FP_OPS, pt, B) and (
        pt is None or pt_mul(FP_OPS, pt, R) is None
    )


def g2_add(p1, p2):
    return pt_add(F2_OPS, p1, p2)


def g2_mul(pt, k):
    return pt_mul(F2_OPS, pt, k)


def g2_neg(pt):
    return pt_neg(F2_OPS, pt)


def g2_is_valid(pt):
    return pt_is_on_curve(F2_OPS, pt, TWIST_B) and (
        pt is None or g2_mul(pt, R) is None
    )


# -- pairing ----------------------------------------------------------------
#
# M-type twist: the untwist is psi(x', y') = (x' w^-2, y' w^-3). Scaling each
# line by d'·w^3·Z^3 (the w^3 dies in the final exponentiation because
# (w^3)^((p^6-1)(p^2+1)) = (-1)^(p^2+1) = 1; the Fp2 factors die because
# Frobenius^2 fixes Fp2) puts the line coefficients at w-degrees (0, 2, 3):
#
#   doubling at T=(X,Y,Z):   (3X^3 - 2Y^2 Z)  -  3X^2 Z·xp w^2  +  2YZ^2·yp w^3
#   mixed add  T + (x2,y2):  (n x2 - d y2)    -  n·xp w^2       +  d·yp w^3
#
# with n, d the scaled slope numerator/denominator. The point update formulas
# are the generic b-independent projective ones (same as bn254_ref's).


def miller_loop(q, p):
    """f_{|z|,Q}(P) with projective doubling/addition; conjugated at the end
    because z < 0. q on E'(Fp2) affine, p on E(Fp) affine."""
    if q is None or p is None:
        return F12_ONE
    xp, yp = p

    def sparse_line(c0, cw2, cw3):
        # w-degree slots 0 (=1), 2 (=v), 3 (=v*w)
        return ((c0, cw2, F2_ZERO), (F2_ZERO, cw3, F2_ZERO))

    def dbl(T):
        X, Y, Zc = T
        XX = f2_sqr(X)
        YY = f2_sqr(Y)
        YZ = f2_mul(Y, Zc)
        n = f2_scalar(XX, 3)
        d = f2_scalar(YZ, 2)
        XYYZ = f2_mul(f2_mul(X, YY), Zc)
        e = f2_sub(f2_sqr(n), f2_scalar(XYYZ, 8))
        X3 = f2_mul(e, d)
        Y3 = f2_sub(
            f2_mul(n, f2_sub(f2_scalar(XYYZ, 12), f2_sqr(n))),
            f2_scalar(f2_sqr(f2_mul(YY, Zc)), 8),
        )
        Z3 = f2_mul(f2_sqr(d), d)
        cw3 = f2_scalar(f2_mul(f2_mul(YZ, Zc), (yp, 0)), 2)
        cw2 = f2_neg(f2_mul(f2_mul(n, Zc), (xp, 0)))
        c0 = f2_sub(f2_mul(n, X), f2_scalar(f2_mul(YY, Zc), 2))
        return (X3, Y3, Z3), sparse_line(c0, cw2, cw3)

    def add(T, Q2):
        X, Y, Zc = T
        x2, y2 = Q2
        n = f2_sub(f2_mul(y2, Zc), Y)
        d = f2_sub(f2_mul(x2, Zc), X)
        dd = f2_sqr(d)
        x2Z = f2_mul(x2, Zc)
        e = f2_sub(f2_mul(f2_sqr(n), Zc), f2_mul(f2_add(X, x2Z), dd))
        X3 = f2_mul(e, d)
        Y3 = f2_sub(
            f2_mul(n, f2_sub(f2_mul(x2Z, dd), e)),
            f2_mul(f2_mul(y2, Zc), f2_mul(dd, d)),
        )
        Z3 = f2_mul(Zc, f2_mul(dd, d))
        cw3 = f2_mul(d, (yp, 0))
        cw2 = f2_neg(f2_mul(n, (xp, 0)))
        c0 = f2_sub(f2_mul(n, x2), f2_mul(d, y2))
        return (X3, Y3, Z3), sparse_line(c0, cw2, cw3)

    T = (q[0], q[1], F2_ONE)
    f = F12_ONE
    for bit in bin(-Z)[3:]:
        T, line = dbl(T)
        f = f12_mul(f12_sqr(f), line)
        if bit == "1":
            T, line = add(T, q)
            f = f12_mul(f, line)
    # z < 0: f_{z} = 1 / f_{|z|} up to final exp -> conjugate
    return f12_conj(f)


def final_exponentiation_naive(f):
    return f12_pow(f, (P**12 - 1) // R)


def final_exponentiation(f):
    """Easy part + BLS12 hard part via the integer identity

        3·(p^4 - p^2 + 1)/r = (z-1)^2 (z+p) (z^2+p^2-1) + 3

    (verified exactly in tests), i.e. this computes the CUBED ate pairing —
    itself a bilinear non-degenerate pairing since gcd(3, r) = 1, and the
    standard trick for BLS12 final exponentiation. `pairing_check`
    equivalence is unaffected: f^(3·hard) = 1  <=>  f^hard = 1."""
    f = f12_mul(f12_conj(f), f12_inv(f))  # f^(p^6 - 1)
    f = f12_mul(f12_frobenius2(f), f)  # ^(p^2 + 1)

    def pow_z(x):
        # z < 0: x^z = conj(x^|z|) in the cyclotomic subgroup
        return f12_conj(f12_pow(x, -Z))

    t0 = f12_mul(pow_z(f), f12_conj(f))  # f^(z-1)
    t1 = f12_mul(pow_z(t0), f12_conj(t0))  # f^((z-1)^2) = f^A
    g = f12_mul(pow_z(t1), f12_frobenius(t1))  # f^(A(z+p))
    gz2 = pow_z(pow_z(g))  # f^(A(z+p)z^2)
    h = f12_mul(
        f12_mul(gz2, f12_frobenius2(g)), f12_conj(g)
    )  # f^(A(z+p)(z^2+p^2-1))
    return f12_mul(h, f12_mul(f12_sqr(f), f))  # * f^3


def pairing(q, p, fast: bool = True):
    f = miller_loop(q, p)
    return final_exponentiation(f) if fast else final_exponentiation_naive(f)


def pairing_check(pairs) -> bool:
    f = F12_ONE
    for p, q in pairs:
        f = f12_mul(f, miller_loop(q, p))
    return final_exponentiation(f) == F12_ONE
