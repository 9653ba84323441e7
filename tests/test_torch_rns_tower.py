"""The port's residue-resident tower and pairing against the JAX package.

Seeded inputs through both packages; tolerance: bitwise. Resident values
are not canonical, and the two packages' Fermat inverses and pow chains use
different windows on the CPU (the reference picks 1 there, the port 4), so
resident tower outputs are compared after `from_resident`, where both are
canonical. The resident pairing runs against handel_tpu's scalar oracle
(ops/bn254_ref.py) here and against the JAX resident pairing in the slow
tier (tests/test_torch_rns_device.py), whose compile takes minutes.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handel_tpu.ops import bn254_ref as jbn
from handel_tpu.ops.curve import BN254Curves as JaxCurves
from handel_tpu.ops.pairing import BN254Pairing as JaxPairing
from handel_tpu_torch.ops.curve import BN254Curves
from handel_tpu_torch.ops.pairing import BN254Pairing

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    return (
        BN254Pairing(BN254Curves(device="cpu", backend="rns")),
        JaxPairing(JaxCurves(backend="rns")),
    )


def rand_f12(rng):
    return tuple(
        tuple((rng.randrange(jbn.P), rng.randrange(jbn.P)) for _ in range(3))
        for _ in range(2)
    )


def cyclotomic(f):
    """f^((p^6-1)(p^2+1)): the easy part of the final exponentiation."""
    f = jbn.f12_mul(jbn.f12_conj(f), jbn.f12_inv(f))
    return jbn.f12_mul(jbn.f12_frobenius(jbn.f12_frobenius(f)), f)


def flat_out(pr, f):
    """A resident Fp12 element as 12 canonical limb arrays (numpy int64)."""
    return [np.asarray(x).astype(np.int64) for x in pr.T._flatten12(pr._f12_out(f))]


def resident_in(pr, vals, lift: int):
    """Fp12 values -> resident elements whose coordinates represent
    x + lift * p (so the operands are not canonical), as residues of both
    packages' fields from the same host integers."""
    F = pr.F
    ms = [int(m) for m in F._m_all]

    def coord(xs):
        return np.array(
            [[(x * F.mont_r % F.p + lift * F.p) % m for x in xs] for m in ms], np.int32
        )

    out = []
    for i in range(2):
        row = []
        for j in range(3):
            row.append(tuple(coord([v[i][j][k] for v in vals]) for k in range(2)))
        out.append(tuple(row))
    return tuple(out)


def to_torch(tree):
    if isinstance(tree, tuple):
        return tuple(to_torch(t) for t in tree)
    return torch.from_numpy(np.ascontiguousarray(tree))


def to_jax(tree):
    if isinstance(tree, tuple):
        return tuple(to_jax(t) for t in tree)
    return jnp.asarray(tree)


def assert_flat_equal(ours, theirs):
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape and (a == b).all()


@pytest.mark.parametrize("op", ["f12_cyclo_sqr", "f12_frobenius", "f12_inv"])
def test_resident_tower_ops_match_after_from_resident(engines, op):
    ours, theirs = engines
    rng = random.Random(op)
    vals = [rand_f12(rng) for _ in range(2)]
    if op == "f12_cyclo_sqr":
        vals = [cyclotomic(v) for v in vals]
    host = resident_in(ours, vals, lift=(1 << 20) + 3)
    got = getattr(ours._Tw, op)(to_torch(host))
    want = getattr(theirs._Tw, op)(to_jax(host))
    assert_flat_equal(flat_out(ours, got), flat_out(theirs, want))
    ref = {"f12_cyclo_sqr": lambda f: jbn.f12_mul(f, f), "f12_frobenius": jbn.f12_frobenius,
           "f12_inv": jbn.f12_inv}[op]
    assert ours.T.f12_unpack(ours._f12_out(got)) == [ref(v) for v in vals]


def test_as_resident_is_cached_and_refuses_cios():
    pr = BN254Pairing(BN254Curves(device="cpu", backend="rns"))
    assert pr.resident and pr._Tw is pr.T.as_resident() and pr._Tw.F is pr.F.resident()
    cios = BN254Pairing(device="cpu")
    assert not cios.resident and cios._Tw is cios.T
    with pytest.raises(TypeError, match="rns"):
        cios.T.as_resident()
    with pytest.raises(ValueError, match="rns"):
        BN254Pairing(BN254Curves(device="cpu"), resident=True)
    assert not BN254Pairing(BN254Curves(device="cpu", backend="rns"), resident=False).resident


def pack_points(pr, ps, qs):
    F, T = pr.F, pr.T
    return (
        (F.pack([x[0] for x in ps]), F.pack([x[1] for x in ps])),
        (T.f2_pack([x[0] for x in qs]), T.f2_pack([x[1] for x in qs])),
    )


def test_resident_pairing_matches_oracle_and_counts(engines):
    """Four lanes (P, Q), (aP, Q), (P, aQ) and a masked one: e(P, Q) from
    the resident pairing equals the oracle, bilinearity holds, the masked
    lane is 1, and one pairing converts 5 times in and once out, as the
    reference's trace counts."""
    pr, jpr = engines
    rng = random.Random(77)
    a = rng.randrange(2, jbn.R)
    p = jbn.g1_mul(jbn.G1_GEN, rng.randrange(1, jbn.R))
    q = jbn.g2_mul(jbn.G2_GEN, rng.randrange(1, jbn.R))
    ps = [p, jbn.g1_mul(p, a), p, p]
    qs = [q, q, jbn.g2_mul(q, a), q]
    P, Q = pack_points(pr, ps, qs)
    mask = torch.tensor([True, True, True, False])
    pr.F.reset_conversion_counts()
    gt = pr.T.f12_unpack(pr.pairing(P, Q, mask))
    assert pr.F.conversion_counts() == {"to_resident": 5, "from_resident": 1, "total": 6}
    e = jbn.pairing(q, p)
    assert gt[0] == e and gt[1] == gt[2] == jbn.f12_pow(e, a) and gt[3] == jbn.F12_ONE
    # the reference counts the same at trace time
    jP, jQ = pack_points(jpr, ps, qs)
    jpr.F.reset_conversion_counts()
    jax.eval_shape(lambda P, Q: jpr.pairing(P, Q), jP, jQ)
    assert jpr.F.conversion_counts() == pr.F.conversion_counts()


def test_resident_pairing_check_verdicts_and_counts(engines):
    """e(H, X) e(-S, B2) == 1 per candidate in the pair-chunk-major layout:
    true for S = x H, false for S = (x+1) H; 5 conversions in, 1 out."""
    pr, jpr = engines
    rng = random.Random(5)
    x = rng.randrange(2, jbn.R)
    h = jbn.g1_mul(jbn.G1_GEN, rng.randrange(1, jbn.R))
    X = jbn.g2_mul(jbn.G2_GEN, x)
    good, bad = jbn.g1_mul(h, x), jbn.g1_mul(h, x + 1)
    ps = [h, h, jbn.g1_neg(good), jbn.g1_neg(bad)]
    qs = [X, X, jbn.G2_GEN, jbn.G2_GEN]
    P, Q = pack_points(pr, ps, qs)
    pr.F.reset_conversion_counts()
    assert pr.pairing_check(P, Q, torch.ones(4, dtype=torch.bool), 2).tolist() == [True, False]
    assert pr.F.conversion_counts() == {"to_resident": 5, "from_resident": 1, "total": 6}
    jP, jQ = pack_points(jpr, ps, qs)
    jpr.F.reset_conversion_counts()
    jax.eval_shape(lambda P, Q: jpr.pairing_check(P, Q, jnp.ones((4,), bool), 2), jP, jQ)
    assert jpr.F.conversion_counts() == pr.F.conversion_counts()
