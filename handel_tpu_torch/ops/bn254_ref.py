"""Pure-Python BN254 (alt_bn128): tower fields, curve groups, optimal ate pairing.

This is the framework's scalar ground truth — the role the imported
`cloudflare/bn256` library plays for the reference (bn256/cf/bn256.go:17): all
JAX/TPU kernels (ops/fp.py, ops/pairing.py) and the C++ native backend are
validated against this module, and it doubles as a (slow) host fallback scheme.

Curve: the SNARK-friendly BN curve used by cloudflare/bn256 and the Ethereum
precompiles ("alt_bn128"), parameter u = 4965661367192848881:
    p = 36u^4 + 36u^3 + 24u^2 + 6u + 1
    r = 36u^4 + 36u^3 + 18u^2 + 6u + 1
    E(Fp):  y^2 = x^3 + 3,           G1 generator (1, 2)
    E'(Fp2): y^2 = x^3 + 3/xi,       xi = 9 + i,  Fp2 = Fp[i]/(i^2+1)
Tower: Fp2 -> Fp6 = Fp2[v]/(v^3 - xi) -> Fp12 = Fp6[w]/(w^2 - v).

The pairing is the optimal ate pairing: Miller loop over 6u+2 with affine line
functions evaluated at G1 points lifted through the D-twist
psi(x', y') = (x' w^2, y' w^3), followed by the final exponentiation
(p^12 - 1)/r — both a naive pow (oracle) and the standard fast
Frobenius/addition-chain version that device kernels mirror.

Everything here is plain Python ints — clarity over speed.
"""

from __future__ import annotations

# -- curve constants --------------------------------------------------------

U = 4965661367192848881  # BN parameter
P = 36 * U**4 + 36 * U**3 + 24 * U**2 + 6 * U + 1  # field modulus
R = 36 * U**4 + 36 * U**3 + 18 * U**2 + 6 * U + 1  # group order
ATE_LOOP_COUNT = 6 * U + 2

assert P == 21888242871839275222246405745257275088696311157297823662689037894645226208583
assert R == 21888242871839275222246405745257275088548364400416034343698204186575808495617
assert P % 4 == 3 and P % 6 == 1

B = 3  # G1 curve coefficient

G1_GEN = (1, 2)

# E'(Fp2) generator (standard alt_bn128 G2 generator, as in EIP-197)
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


# -- Fp2 = Fp[i]/(i^2 + 1): elements are (c0, c1) = c0 + c1*i ---------------


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


def f2_pow(a, e):
    result = F2_ONE
    base = a
    while e:
        if e & 1:
            result = f2_mul(result, base)
        base = f2_sqr(base)
        e >>= 1
    return result


def f2_sqrt(a):
    """Square root in Fp2 for p = 3 mod 4 (complex-extension algorithm);
    returns None when `a` is not a quadratic residue."""
    if a == F2_ZERO:
        return F2_ZERO
    a1 = f2_pow(a, (P - 3) // 4)
    alpha = f2_mul(f2_sqr(a1), a)  # a^((p-1)/2)
    x0 = f2_mul(a1, a)  # a^((p+1)/4)
    if alpha == ((-1) % P, 0):
        x = f2_mul((0, 1), x0)  # i * x0
    else:
        b = f2_pow(f2_add(F2_ONE, alpha), (P - 1) // 2)
        x = f2_mul(b, x0)
    return x if f2_sqr(x) == a else None


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)  # the Fp6 non-residue: v^3 = xi


def f2_mul_xi(a):
    """Multiply by xi = 9 + i."""
    a0, a1 = a
    return ((9 * a0 - a1) % P, (9 * a1 + a0) % P)


# -- Fp6 = Fp2[v]/(v^3 - xi): elements are (c0, c1, c2) ---------------------


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    # Karatsuba/Toom-style interpolation
    c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(
        f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)),
        f2_mul_xi(t2),
    )
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_sqr(a):
    return f6_mul(a, a)


def f6_mul_v(a):
    """Multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    t0 = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)))
    t1 = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    t2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    den = f2_add(
        f2_mul(a0, t0),
        f2_mul_xi(f2_add(f2_mul(a2, t1), f2_mul(a1, t2))),
    )
    inv = f2_inv(den)
    return (f2_mul(t0, inv), f2_mul(t1, inv), f2_mul(t2, inv))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


# -- Fp12 = Fp6[w]/(w^2 - v): elements are (c0, c1) -------------------------


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
    """Conjugation = Frobenius^6: (c0, -c1)."""
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


# -- Frobenius on Fp12 ------------------------------------------------------
# gamma_j = xi^(j*(p-1)/6), j = 1..5: the twist constants for conjugating each
# w^j coordinate. Computed once at import.

_GAMMA = [None] + [f2_pow(XI, j * (P - 1) // 6) for j in range(1, 6)]


def f12_frobenius(a):
    """x -> x^p. Coordinates as w-powers: (c00, c01 v, c02 v^2) + (c10 w, c11 vw, c12 v^2 w)
    = w-degrees (0, 2, 4) and (1, 3, 5)."""
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


def f12_frobenius3(a):
    return f12_frobenius(f12_frobenius2(a))


# -- generic affine short-Weierstrass group ops -----------------------------
# Points are (x, y) tuples of field elements, or None for infinity. Generic
# over the field via a small ops record; used for G1 (Fp), G2' (Fp2) and the
# Fp12 lift inside the Miller loop.


class _FieldOps:
    def __init__(self, add, sub, mul, sqr, inv, neg, scalar, zero, one):
        self.add, self.sub, self.mul, self.sqr = add, sub, mul, sqr
        self.inv, self.neg, self.scalar = inv, neg, scalar
        self.zero, self.one = zero, one


def _fp_scalar(a, k):
    return a * k % P


FP_OPS = _FieldOps(
    lambda a, b: (a + b) % P,
    lambda a, b: (a - b) % P,
    lambda a, b: a * b % P,
    lambda a: a * a % P,
    lambda a: pow(a, -1, P),
    lambda a: (-a) % P,
    _fp_scalar,
    0,
    1,
)
F2_OPS = _FieldOps(
    f2_add, f2_sub, f2_mul, f2_sqr, f2_inv, f2_neg, f2_scalar, F2_ZERO, F2_ONE
)


def pt_is_on_curve(ops, pt, b):
    if pt is None:
        return True
    x, y = pt
    return ops.sub(ops.sqr(y), ops.add(ops.mul(ops.sqr(x), x), b)) == ops.zero


def pt_add(ops, p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 != y2:
            return None  # inverse points
        # doubling
        m = ops.mul(ops.scalar(ops.sqr(x1), 3), ops.inv(ops.scalar(y1, 2)))
    else:
        m = ops.mul(ops.sub(y2, y1), ops.inv(ops.sub(x2, x1)))
    x3 = ops.sub(ops.sub(ops.sqr(m), x1), x2)
    y3 = ops.sub(ops.mul(m, ops.sub(x1, x3)), y1)
    return (x3, y3)


def pt_neg(ops, pt):
    if pt is None:
        return None
    return (pt[0], ops.neg(pt[1]))


def pt_mul(ops, pt, k):
    """Scalar multiplication by the integer k as given — deliberately NOT
    reduced mod R: callers like the subgroup check below depend on [R]P
    actually performing the full ladder for points of unknown order."""
    result = None
    add = pt
    while k:
        if k & 1:
            result = pt_add(ops, result, add)
        add = pt_add(ops, add, add)
        k >>= 1
    return result


# -- G1 / G2 convenience ----------------------------------------------------

TWIST_B = f2_mul((3, 0), f2_inv(XI))  # 3 / xi, the E' curve coefficient


def g1_add(p1, p2):
    return pt_add(FP_OPS, p1, p2)


def g1_mul(pt, k):
    return pt_mul(FP_OPS, pt, k)


def g1_neg(pt):
    return pt_neg(FP_OPS, pt)


def g1_is_valid(pt):
    return pt_is_on_curve(FP_OPS, pt, B)


def g2_add(p1, p2):
    return pt_add(F2_OPS, p1, p2)


def g2_mul(pt, k):
    return pt_mul(F2_OPS, pt, k)


def g2_neg(pt):
    return pt_neg(F2_OPS, pt)


def g2_is_valid(pt):
    """On the twist AND in the order-r subgroup (E'(Fp2) has cofactor > 1)."""
    return pt_is_on_curve(F2_OPS, pt, TWIST_B) and (
        pt is None or g2_mul(pt, R) is None
    )


# -- pairing ----------------------------------------------------------------

# Fp12 "field ops" record for running generic point arithmetic on the lift
F12_OPS = _FieldOps(
    f12_add,
    lambda a, b: (f6_sub(a[0], b[0]), f6_sub(a[1], b[1])),
    f12_mul,
    f12_sqr,
    f12_inv,
    lambda a: (f6_neg(a[0]), f6_neg(a[1])),
    lambda a, k: f12_mul(a, _f12_from_int(k)),
    F12_ZERO,
    F12_ONE,
)


def _f12_from_int(k):
    return (((k % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


def _f12_from_f2_w2(a):
    """a * w^2 = a * v as an Fp12 element (w-degree 2 slot)."""
    return ((F2_ZERO, a, F2_ZERO), F6_ZERO)


def _f12_from_f2_w3(a):
    """a * w^3 = a * v * w (w-degree 3 slot)."""
    return (F6_ZERO, (F2_ZERO, a, F2_ZERO))


def twist(q):
    """Lift a point on E'(Fp2) to E(Fp12): psi(x', y') = (x' w^2, y' w^3)."""
    if q is None:
        return None
    return (_f12_from_f2_w2(q[0]), _f12_from_f2_w3(q[1]))


def _embed_g1(p):
    """Embed a G1 point into Fp12 coordinates."""
    return (_f12_from_int(p[0]), _f12_from_int(p[1]))


def _linefunc(p1, p2, t):
    """Evaluate the line through p1,p2 (or the tangent at p1 if equal) at t.

    Affine line function over Fp12 — the textbook formulation (cf. py_ecc);
    scaling factors are killed by the final exponentiation.
    """
    ops = F12_OPS
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = ops.mul(ops.sub(y2, y1), ops.inv(ops.sub(x2, x1)))
        return ops.sub(ops.mul(m, ops.sub(xt, x1)), ops.sub(yt, y1))
    if y1 == y2:
        m = ops.mul(ops.scalar(ops.sqr(x1), 3), ops.inv(ops.scalar(y1, 2)))
        return ops.sub(ops.mul(m, ops.sub(xt, x1)), ops.sub(yt, y1))
    return ops.sub(xt, x1)


def miller_loop(q, p):
    """Miller loop of the optimal ate pairing: f_{6u+2,Q}(P) * line corrections.

    q: point on E'(Fp2) (G2), p: point on E(Fp) (G1). Returns an unreduced
    Fp12 value; apply final_exponentiation for the pairing.
    """
    if q is None or p is None:
        return F12_ONE
    ops = F12_OPS
    Q = twist(q)
    Pt = _embed_g1(p)
    Rpt = Q
    f = F12_ONE
    for bit in bin(ATE_LOOP_COUNT)[3:]:  # MSB-first, skipping the top bit
        f = ops.mul(ops.sqr(f), _linefunc(Rpt, Rpt, Pt))
        Rpt = pt_add(ops, Rpt, Rpt)
        if bit == "1":
            f = ops.mul(f, _linefunc(Rpt, Q, Pt))
            Rpt = pt_add(ops, Rpt, Q)
    # the two Frobenius correction lines of the optimal ate pairing
    Q1 = (f12_frobenius(Q[0]), f12_frobenius(Q[1]))
    nQ2 = (f12_frobenius2(Q[0]), F12_OPS.neg(f12_frobenius2(Q[1])))
    f = ops.mul(f, _linefunc(Rpt, Q1, Pt))
    Rpt = pt_add(ops, Rpt, Q1)
    f = ops.mul(f, _linefunc(Rpt, nQ2, Pt))
    return f


def miller_loop_projective(q, p):
    """Inversion-free Miller loop — the formulation the JAX/TPU kernel uses
    (ops/pairing.py), kept here in scalar form as its oracle.

    The accumulator point T runs in homogeneous projective coordinates on the
    twist E'(Fp2); lines are evaluated directly with Fp2 coefficients placed
    into the sparse Fp12 slots (1, w, w^3). All scale factors introduced live
    in Fp2 and die in the easy part of the final exponentiation.

    Derivation (D-twist psi(x,y) = (x w^2, y w^3), slope transforms as
    lambda' = lambda * w):
      doubling at T=(X,Y,Z), line scaled by 2YZ^3:
        l = 2YZ^2*yp - 3X^2 Z*xp w + (3X^3 - 2Y^2 Z) w^3
        n = 3X^2, d = 2YZ, e = n^2 - 8XY^2 Z:
        X' = e*d, Y' = n*(12XY^2 Z - n^2) - 8Y^4 Z^2, Z' = d^3
      mixed addition T + Q=(x2,y2), n = y2 Z - Y, d = x2 Z - X, line scaled
      by d:
        l = d*yp - n*xp w + (n x2 - d y2) w^3
        e = n^2 Z - (X + x2 Z) d^2:
        X' = e*d, Y' = n*(x2 Z d^2 - e) - y2 Z d^3, Z' = Z d^3
    """
    if q is None or p is None:
        return F12_ONE
    xp, yp = p

    def sparse_line(c0, cw, cw3):
        # Fp12 slots: 1 -> a0.u0, w -> a1.u0, w^3 = v*w -> a1.u1
        return ((c0, F2_ZERO, F2_ZERO), (cw, cw3, F2_ZERO))

    def dbl(T):
        X, Y, Z = T
        XX = f2_sqr(X)
        YY = f2_sqr(Y)
        YZ = f2_mul(Y, Z)
        n = f2_scalar(XX, 3)
        d = f2_scalar(YZ, 2)
        XYY = f2_mul(X, YY)
        XYYZ = f2_mul(XYY, Z)
        e = f2_sub(f2_sqr(n), f2_scalar(XYYZ, 8))
        X3 = f2_mul(e, d)
        Y3 = f2_sub(
            f2_mul(n, f2_sub(f2_scalar(XYYZ, 12), f2_sqr(n))),
            f2_scalar(f2_mul(f2_sqr(YY), f2_sqr(Z)), 8),
        )
        Z3 = f2_mul(f2_sqr(d), d)
        c0 = f2_scalar(f2_mul(f2_mul(YZ, Z), (yp, 0)), 2)
        cw = f2_neg(f2_mul(f2_mul(n, Z), (xp, 0)))
        cw3 = f2_sub(f2_mul(n, X), f2_scalar(f2_mul(YY, Z), 2))
        return (X3, Y3, Z3), sparse_line(c0, cw, cw3)

    def add(T, Q2):
        X, Y, Z = T
        x2, y2 = Q2
        n = f2_sub(f2_mul((y2[0], y2[1]), Z), Y)
        d = f2_sub(f2_mul((x2[0], x2[1]), Z), X)
        dd = f2_sqr(d)
        x2Z = f2_mul(x2, Z)
        e = f2_sub(f2_mul(f2_sqr(n), Z), f2_mul(f2_add(X, x2Z), dd))
        X3 = f2_mul(e, d)
        Y3 = f2_sub(
            f2_mul(n, f2_sub(f2_mul(x2Z, dd), e)),
            f2_mul(f2_mul(y2, Z), f2_mul(dd, d)),
        )
        Z3 = f2_mul(Z, f2_mul(dd, d))
        c0 = f2_mul(d, ((yp % P), 0))
        cw = f2_neg(f2_mul(n, ((xp % P), 0)))
        cw3 = f2_sub(f2_mul(n, x2), f2_mul(d, y2))
        return (X3, Y3, Z3), sparse_line(c0, cw, cw3)

    T = (q[0], q[1], F2_ONE)
    f = F12_ONE
    for bit in bin(ATE_LOOP_COUNT)[3:]:
        T, line = dbl(T)
        f = f12_mul(f12_sqr(f), line)
        if bit == "1":
            T, line = add(T, q)
            f = f12_mul(f, line)
    # Frobenius corrections on the untwisted coordinates:
    # psi-Frobenius on E': (x,y) -> (conj(x)*gamma_2', conj(y)*gamma_3') with
    # gamma coefficients matching the w^2/w^3 slots of the lift.
    q1 = (
        f2_mul(f2_conj(q[0]), _GAMMA[2]),
        f2_mul(f2_conj(q[1]), _GAMMA[3]),
    )
    q2 = (
        f2_mul(f2_conj(q1[0]), _GAMMA[2]),
        f2_neg(f2_mul(f2_conj(q1[1]), _GAMMA[3])),
    )
    T, line = add(T, q1)
    f = f12_mul(f, line)
    _, line = add(T, q2)
    f = f12_mul(f, line)
    return f


def final_exponentiation_naive(f):
    """The oracle: f^((p^12-1)/r) by plain square-and-multiply."""
    return f12_pow(f, (P**12 - 1) // R)


def final_exponentiation(f):
    """Fast final exponentiation: easy part by Frobenius/conjugation, hard part
    by the standard BN addition chain (Scott et al.), using that inversion is
    conjugation in the cyclotomic subgroup."""
    # easy part: f^((p^6-1)(p^2+1))
    f = f12_mul(f12_conj(f), f12_inv(f))  # f^(p^6-1)
    f = f12_mul(f12_frobenius2(f), f)  # ^(p^2+1)

    # hard part: f^((p^4 - p^2 + 1)/r)
    fu = f12_pow(f, U)
    fu2 = f12_pow(fu, U)
    fu3 = f12_pow(fu2, U)
    y0 = f12_mul(f12_mul(f12_frobenius(f), f12_frobenius2(f)), f12_frobenius3(f))
    y1 = f12_conj(f)
    y2 = f12_frobenius2(fu2)
    y3 = f12_conj(f12_frobenius(fu))
    y4 = f12_conj(f12_mul(fu, f12_frobenius(fu2)))
    y5 = f12_conj(fu2)
    y6 = f12_conj(f12_mul(fu3, f12_frobenius(fu3)))

    t0 = f12_mul(f12_mul(f12_sqr(y6), y4), y5)
    t1 = f12_mul(f12_mul(y3, y5), t0)
    t0 = f12_mul(t0, y2)
    t1 = f12_mul(f12_sqr(t1), t0)
    t1 = f12_sqr(t1)
    t0 = f12_mul(t1, y1)
    t1 = f12_mul(t1, y0)
    t0 = f12_sqr(t0)
    t0 = f12_mul(t0, t1)
    return t0


def pairing(q, p, fast: bool = True):
    """e(P in G1, Q in G2') -> GT (Fp12)."""
    f = miller_loop(q, p)
    return final_exponentiation(f) if fast else final_exponentiation_naive(f)


def pairing_check(pairs) -> bool:
    """Product-of-pairings check: prod e(p_i, q_i) == 1.

    One shared final exponentiation over the product of Miller loops — the
    batched structure the device kernel mirrors.
    """
    f = F12_ONE
    for p, q in pairs:
        f = f12_mul(f, miller_loop(q, p))
    return final_exponentiation(f) == F12_ONE
