"""The port's batched pairing against the scalar oracle, and (slow tier)
against the JAX package's BN254Pairing.

The fast tier holds the port to handel_tpu's ops/bn254_ref.py — the oracle
the JAX pairing is itself validated against — because a JAX pairing graph
takes minutes of XLA compilation on the CPU.
"""

import random

import numpy as np
import pytest
import torch

from handel_tpu.ops import bn254_ref as jbn
from handel_tpu_torch.ops.pairing import BN254Pairing

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pr():
    return BN254Pairing(device="cpu")


@pytest.fixture(scope="module")
def points():
    rng = random.Random(77)
    a = rng.randrange(2, jbn.R)
    p = jbn.g1_mul(jbn.G1_GEN, rng.randrange(1, jbn.R))
    q = jbn.g2_mul(jbn.G2_GEN, rng.randrange(1, jbn.R))
    return a, p, q


def pack(pr, ps, qs):
    F, T = pr.F, pr.T
    return (
        (F.pack([x[0] for x in ps]), F.pack([x[1] for x in ps])),
        (T.f2_pack([x[0] for x in qs]), T.f2_pack([x[1] for x in qs])),
    )


def test_pairing_oracle_bilinear_and_masked(pr, points):
    """Lanes (P, Q), (aP, Q), (P, aQ) and a masked lane in one batch: the
    Miller values and the pairings equal the oracle's, e(aP, Q) = e(P, aQ)
    = e(P, Q)^a, and the masked lane is exactly 1."""
    a, p, q = points
    ap, aq = jbn.g1_mul(p, a), jbn.g2_mul(q, a)
    ps, qs = [p, ap, p, ap], [q, q, aq, aq]
    P, Q = pack(pr, ps, qs)
    mask = torch.tensor([True, True, True, False])
    f = pr.miller_loop(P, Q, mask)
    ml = pr.T.f12_unpack(f)
    assert ml[:3] == [jbn.miller_loop_projective(y, x) for x, y in zip(ps[:3], qs[:3])]
    assert ml[3] == jbn.F12_ONE
    gt = pr.T.f12_unpack(pr.final_exp(f))
    e = jbn.pairing(q, p)
    assert gt[0] == e
    assert gt[1] == gt[2] == jbn.f12_pow(e, a)
    assert gt[3] == jbn.F12_ONE
    assert pr.gt_is_one(pr.final_exp(f)).tolist() == [False, False, False, True]


def test_pairing_check_bls_verdicts(pr, points):
    """Two candidates in the pair-chunk-major layout: e(H, X) e(-S, B2) == 1
    holds for S = x H and fails for S = (x+1) H."""
    x, h, _ = points
    X = jbn.g2_mul(jbn.G2_GEN, x)
    good, bad = jbn.g1_mul(h, x), jbn.g1_mul(h, x + 1)
    # lane i*2 + j = pair i of candidate j
    ps = [h, h, jbn.g1_neg(good), jbn.g1_neg(bad)]
    qs = [X, X, jbn.G2_GEN, jbn.G2_GEN]
    P, Q = pack(pr, ps, qs)
    mask = torch.ones(4, dtype=torch.bool)
    assert pr.pairing_check(P, Q, mask, 2).tolist() == [True, False]
    assert jbn.pairing_check(list(zip(ps[::2], qs[::2])))


@pytest.mark.slow
def test_pairing_matches_jax(pr, points):
    """Bit-identical GT elements from the JAX BN254Pairing (minutes of XLA)."""
    import jax.numpy as jnp

    from handel_tpu.ops.curve import BN254Curves as JaxCurves
    from handel_tpu.ops.fp import Field as JaxField
    from handel_tpu.ops.pairing import BN254Pairing as JaxPairing

    a, p, q = points
    P, Q = pack(pr, [p, jbn.g1_mul(p, a)], [q, q])
    jpr = JaxPairing(JaxCurves(field=JaxField(jbn.P, use_pallas=False)))
    tj = lambda t: jnp.asarray(t.numpy().astype(np.uint32))  # noqa: E731
    jP = (tj(P[0]), tj(P[1]))
    jQ = ((tj(Q[0][0]), tj(Q[0][1])), (tj(Q[1][0]), tj(Q[1][1])))
    ours = pr.T._flatten12(pr.pairing(P, Q))
    theirs = jpr.T._flatten12(jpr.pairing(jP, jQ))
    for x, y in zip(ours, theirs):
        assert (x.numpy() == np.asarray(y).astype(np.int32)).all()
