"""The port's Tower and Curve against the JAX package's, run eagerly on the CPU.

Seeded inputs through both packages; every output limb must be equal. The
JAX Field is its plain XLA version (`use_pallas=False`); widths stay small
(<= 16 lanes) because the JAX side dispatches op by op.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handel_tpu.ops import bn254_ref as jbn
from handel_tpu.ops.curve import BN254Curves as JaxCurves
from handel_tpu.ops.fp import Field as JaxField
from handel_tpu.ops.tower import Tower as JaxTower
from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops.curve import BN254Curves

torch.set_num_threads(1)

rng = random.Random(1234)


@pytest.fixture(scope="module")
def stacks():
    J = JaxField(jbn.P, use_pallas=False)
    return BN254Curves(device="cpu"), JaxCurves(field=J, tower=JaxTower(J))


def to_jax(tree):
    if isinstance(tree, tuple):
        return tuple(to_jax(t) for t in tree)
    return jnp.asarray(tree.numpy().astype(np.uint32))


def assert_same(ours, theirs):
    """Equal tree shape and equal limbs (the JAX side in uint32)."""
    if isinstance(ours, tuple):
        assert isinstance(theirs, tuple) and len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert_same(a, b)
        return
    t = np.asarray(theirs)
    assert ours.shape == t.shape
    assert (ours.numpy().astype(np.int64) == t.astype(np.int64)).all()


def rand_f2():
    return (rng.randrange(bn.P), rng.randrange(bn.P))


def rand_f12():
    return tuple(tuple(rand_f2() for _ in range(3)) for _ in range(2))


def cyclotomic(f):
    """f^((p^6-1)(p^2+1)): the easy part of the final exponentiation."""
    f = bn.f12_mul(bn.f12_conj(f), bn.f12_inv(f))
    return bn.f12_mul(bn.f12_frobenius2(f), f)


def test_f2_mul_sqr_inv_match_jax(stacks):
    C, J = stacks
    T, JT = C.T, J.T
    xs = [rand_f2() for _ in range(6)] + [(0, 0), (1, 0), (0, 1)]
    ys = [rand_f2() for _ in range(9)]
    a, b = T.f2_pack(xs), T.f2_pack(ys)
    ja, jb = to_jax(a), to_jax(b)
    assert_same(T.f2_mul(a, b), JT.f2_mul(ja, jb))
    assert_same(T.f2_sqr(a), JT.f2_sqr(ja))
    assert_same(T.f2_inv(a), JT.f2_inv(ja))
    assert_same(T.f2_mul_xi(a), JT.f2_mul_xi(ja))
    assert T.f2_unpack(T.f2_mul(a, b)) == [bn.f2_mul(x, y) for x, y in zip(xs, ys)]
    assert T.f2_unpack(T.f2_inv(a)) == [
        bn.f2_inv(x) if x != (0, 0) else (0, 0) for x in xs
    ]


def test_f12_mul_sqr_inv_match_jax(stacks):
    C, J = stacks
    T, JT = C.T, J.T
    xs, ys = [rand_f12() for _ in range(2)], [rand_f12() for _ in range(2)]
    a, b = T.f12_pack(xs), T.f12_pack(ys)
    ja, jb = to_jax(a), to_jax(b)
    assert_same(T.f12_mul(a, b), JT.f12_mul(ja, jb))
    assert_same(T.f12_sqr(a), JT.f12_sqr(ja))
    assert_same(T.f12_inv(a), JT.f12_inv(ja))
    assert T.f12_unpack(T.f12_mul(a, b)) == [bn.f12_mul(x, y) for x, y in zip(xs, ys)]
    assert T.f12_unpack(T.f12_inv(a)) == [bn.f12_inv(x) for x in xs]


def test_f12_frobenius_and_cyclotomic_match_jax(stacks):
    C, J = stacks
    T, JT = C.T, J.T
    xs = [cyclotomic(rand_f12()) for _ in range(2)]
    a = T.f12_pack(xs)
    ja = to_jax(a)
    assert_same(T.f12_frobenius(a), JT.f12_frobenius(ja))
    assert_same(T.f12_frobenius2(a), JT.f12_frobenius2(ja))
    assert_same(T.f12_conj(a), JT.f12_conj(ja))
    assert_same(T.f12_cyclo_sqr(a), JT.f12_cyclo_sqr(ja))
    assert T.f12_unpack(T.f12_frobenius(a)) == [bn.f12_frobenius(x) for x in xs]
    assert T.f12_unpack(T.f12_cyclo_sqr(a)) == [bn.f12_mul(x, x) for x in xs]


def test_f12_pow_u_matches_oracle(stacks):
    """Both squarings of the port's windowed a^U against the oracle (the
    JAX side's scan would compile the whole Fp12 graph)."""
    T = stacks[0].T
    xs = [cyclotomic(rand_f12())]
    a = T.f12_pack(xs)
    want = [bn.f12_pow(xs[0], bn.U)]
    assert T.f12_unpack(T.f12_pow_u(a)) == want
    assert T.f12_unpack(T.f12_pow_u(a, cyclo=True)) == want
    with pytest.raises(TypeError):
        from handel_tpu.ops import bls12_381_ref
        from handel_tpu_torch.ops.tower import Tower

        Tower(stacks[0].F, params=bls12_381_ref).f12_pow_u(a)


def g1_points(k):
    return [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(k)]


def g2_points(k):
    return [bn.g2_mul(bn.G2_GEN, rng.randrange(1, 1 << 64)) for _ in range(k)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_curve_add_double_match_jax(stacks, group):
    C, J = stacks
    pts = g1_points(4) if group == "g1" else g2_points(4)
    pack = C.pack_g1 if group == "g1" else C.pack_g2
    # generic adds, a doubling, an inverse pair and the identity
    P = pack(pts + [pts[0], None])
    Q = pack(pts[::-1] + [pts[0], pts[1]])
    ours, theirs = getattr(C, group), getattr(J, group)
    assert_same(ours.add(P, Q), theirs.add(to_jax(P), to_jax(Q)))
    assert_same(ours.double(P), theirs.double(to_jax(P)))
    assert_same(ours.neg(P), theirs.neg(to_jax(P)))
    add = bn.g1_add if group == "g1" else bn.g2_add
    unpack = C.unpack_g1 if group == "g1" else C.unpack_g2
    want = [add(p, q) for p, q in zip(pts + [pts[0], None], pts[::-1] + [pts[0], pts[1]])]
    assert unpack(ours.add(P, Q)) == want
    assert ours.on_curve(P).all()


def test_g2_masked_sum_prefix_scan_to_affine_match_jax(stacks):
    C, J = stacks
    pts = g2_points(8)
    P = C.pack_g2(pts)
    jP = to_jax(P)
    mask = torch.tensor([True, False, True, True, False, True, True, False])
    assert_same(
        C.g2.masked_sum(P, mask, 8),
        J.g2.masked_sum(jP, jnp.asarray(mask.numpy()), 8),
    )
    scan = C.g2.prefix_scan(P)
    assert_same(scan, J.g2.prefix_scan(jP))
    assert_same(C.g2.to_affine(scan), J.g2.to_affine(to_jax(scan)))
    acc, want = None, []
    for p in pts:
        acc = bn.g2_add(acc, p)
        want.append(acc)
    assert C.unpack_g2(scan) == want
    total = None
    for p, m in zip(pts, mask.tolist()):
        total = bn.g2_add(total, p) if m else total
    assert C.unpack_g2(C.g2.masked_sum(P, mask, 8)) == [total]


def test_g1_sum_points_and_to_affine_match_jax(stacks):
    C, J = stacks
    pts = g1_points(5) + [None]  # odd block counts pad with infinity
    P = C.pack_g1(pts)
    s = C.g1.sum_points(P, 3)  # 3 blocks of 2 lanes
    assert_same(s, J.g1.sum_points(to_jax(P), 3))
    assert_same(C.g1.to_affine(s), J.g1.to_affine(to_jax(s)))
    want = [bn.g1_add(bn.g1_add(pts[i], pts[2 + i]), pts[4 + i]) for i in range(2)]
    assert C.unpack_g1(s) == want


def test_scalar_mul_matches_oracle(stacks):
    C = stacks[0]
    pts = g1_points(3)
    ks = [rng.randrange(1, 1 << 20) for _ in pts]
    out = C.g1.scalar_mul(C.pack_g1(pts), C.scalar_bits(ks, nbits=20))
    assert C.unpack_g1(out) == [bn.g1_mul(p, k) for p, k in zip(pts, ks)]
