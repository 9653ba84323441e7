"""The port's BLS12-381 verification engine (models/bls12_381_torch.py) on
the CPU, against the JAX package.

Requests are built with the JAX package's BitSet, key and signature objects
and handed unchanged to both packages (the port's packer duck-types them).
Verdicts must equal handel_tpu.models.bls12_381's host verify and the ones
known by construction, on both field backends; the engine's combine must
equal the oracle's sums. The slow tier puts the same inputs through the JAX
package's BLS12Curves/BLS12Pairing (both backends) and
BLS12381JaxConstructor (minutes of XLA compilation each).
"""

import random

import numpy as np
import pytest
import torch

from handel_tpu.core.bitset import BitSet
from handel_tpu.models.bls12_381 import (
    BLS12381Constructor,
    BLS12381PublicKey,
    BLS12381Signature,
    hash_to_g1,
    new_keypair,
)
from handel_tpu.ops import bls12_381_ref as jbls
from handel_tpu_torch.models.bls12_381_torch import (
    BLS12381Device,
    BLS12381TorchConstructor,
    BLS12381TorchScheme,
)
from handel_tpu_torch.models.bn254_torch import BN254TorchConstructor

torch.set_num_threads(1)

MSG = b"bls12-381 device e2e"
N = 16
C = 4


class SmallCapDevice(BLS12381Device):
    """A lowered hole cap, so that a 16-key registry reaches the dense class."""

    MISS_CAP = 2


@pytest.fixture(scope="module")
def registry():
    rng = random.Random(31)
    sks = [rng.randrange(1, 1 << 30) for _ in range(N)]
    return sks, [BLS12381PublicKey(jbls.g2_mul(jbls.G2_GEN, s)) for s in sks]


def candidate(sks, idx, forge=False, msg=MSG, n=N):
    bs = BitSet(n)
    for i in idx:
        bs.set(i, True)
    k = (sum(sks[i] for i in idx) + (1 if forge else 0)) % jbls.R
    return bs, BLS12381Signature(jbls.g1_mul(hash_to_g1(msg), k) if k else None)


def reference_case():
    """tests/test_bls12_381_jax.py's end-to-end case: 8 seeded keypairs, 4
    requests, the last one forged."""
    rng = random.Random(13)
    keys = [new_keypair(seed=i) for i in range(8)]
    reqs, expect = [], []
    for j in range(C):
        signers = sorted(rng.sample(range(8), rng.randrange(2, 8)))
        bs = BitSet(8)
        sig = None
        for i in signers:
            bs.set(i, True)
            s = keys[i][0].sign(MSG)
            sig = s if sig is None else sig.combine(s)
        if j == C - 1:
            sig = BLS12381Signature(jbls.g1_mul(jbls.G1_GEN, 12345))
        reqs.append((bs, sig))
        expect.append(j != C - 1)
    return [pk for _, pk in keys], reqs, expect


@pytest.mark.parametrize("backend", ["cios", "rns"])
def test_batch_verify_on_the_reference_case(backend):
    pks, reqs, expect = reference_case()
    cons = BLS12381TorchConstructor(batch_size=C, device="cpu", fp_backend=backend,
                                    warmup=False)
    got = cons.batch_verify(MSG, pks, reqs)
    assert got == expect
    assert got == BLS12381Constructor().batch_verify(MSG, pks, reqs)
    eng = cons._device
    assert type(eng) is BLS12381Device and eng.curves.F.nlimbs == 24
    assert eng.pairing.resident == (backend == "rns")


def test_constructor_binds_the_family_and_the_wire_format():
    cons = BLS12381TorchScheme(batch_size=C, device="cpu", warmup=False).constructor
    assert isinstance(cons, BN254TorchConstructor)
    assert cons.signature_size() == 96
    sk, _ = new_keypair(seed=3)
    sig = sk.sign(MSG)
    assert cons.unmarshal_signature(sig.marshal()).point == sig.point
    assert cons.device_combine([[sig.point]]) is None  # no engine yet


def test_range_launches_match_host_verify(registry):
    sks, pks = registry
    reqs = [
        candidate(sks, range(2, 10)),  # contiguous range
        candidate(sks, [3, 4, 6, 8, 9, 10, 11, 12]),  # range with holes
        candidate(sks, range(0, 6), forge=True),  # wrong signature
        candidate(sks, range(5, 9), msg=b"another message"),  # wrong message
        candidate(sks, []),  # empty bitset
        candidate(sks, [15]),  # second launch: three padded lanes
    ]
    dev = BLS12381Device(pks, batch_size=C, device="cpu")
    assert dev._pack_requests(reqs[:C]).kind == "range"
    got = dev.batch_verify(MSG, reqs)
    assert got == BLS12381Constructor().batch_verify(MSG, pks, reqs)
    assert got == [True, True, False, False, False, True]
    assert dev.host_pack_launches == dev.host_dispatch_launches == 2


def test_dense_launch_matches_host_verify(registry):
    sks, pks = registry
    reqs = [
        candidate(sks, [0, 15]),
        candidate(sks, range(0, 16, 3)),
        candidate(sks, [1, 7, 14], forge=True),
    ]
    dev = SmallCapDevice(pks, batch_size=C, device="cpu")
    assert dev._pack_requests(reqs).kind == "dense"
    assert dev.batch_verify(MSG, reqs) == [True, True, False]


def test_rns_engine_prepares_warms_and_combines_on_the_cios_field(registry):
    """prepare() with warmup on the rns backend: the prefix table and the
    combine classes 2, 4 and 8 exist afterwards; a range launch with holes
    verifies, and device_combine's sums (on the engine's cios field) equal
    the oracle's."""
    sks, pks = registry
    cons = BLS12381TorchConstructor(batch_size=C, device="cpu", fp_backend="rns")
    eng = cons.prepare(pks)
    assert eng.bank.prefix is not None and eng._combine_ready == {2, 4, 8}
    assert eng._combine_curves.F.backend == "cios" and eng._combine_curves.F.nlimbs == 24
    reqs = [candidate(sks, [1, 2, 4, 5, 6, 9]), candidate(sks, range(4, 12), forge=True)]
    assert cons.batch_verify(MSG, pks, reqs) == [True, False]
    rng = random.Random(5)
    pts = [jbls.g1_mul(jbls.G1_GEN, rng.randrange(1, jbls.R)) for _ in range(8)]
    groups = [pts[:2], pts[2:6], [pts[6], None, jbls.g1_neg(pts[6])], pts]
    want = []
    for g in groups:
        acc = None
        for p in g:
            acc = jbls.g1_add(acc, p)
        want.append(acc)
    assert want[2] is None
    assert cons.device_combine(groups) == want


# -- slow tier: the JAX package's BLS12-381 device code on the same inputs -------


def _jax(t):
    import jax.numpy as jnp

    return jnp.asarray(t.numpy().astype(np.uint32))


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["cios", "rns"])
def test_curves_and_pairing_match_jax(backend):
    """The same G1/G2 points through the JAX BLS12Curves/BLS12Pairing and the
    port's: the same canonical limbs for a G2 add and for whole pairings."""
    from handel_tpu.ops.curve import BLS12Curves as JaxCurves
    from handel_tpu.ops.pairing import BLS12Pairing as JaxPairing
    from handel_tpu_torch.ops.curve import BLS12Curves
    from handel_tpu_torch.ops.pairing import BLS12Pairing

    rng = random.Random(41)
    g1 = [jbls.g1_mul(jbls.G1_GEN, rng.randrange(1, jbls.R)) for _ in range(2)]
    g2 = [jbls.g2_mul(jbls.G2_GEN, rng.randrange(1, jbls.R)) for _ in range(2)]
    curves = BLS12Curves(device="cpu", backend=backend)
    pr = BLS12Pairing(curves)
    jcurves = JaxCurves(backend=backend)
    jpr = JaxPairing(jcurves)
    F, T = curves.F, curves.T
    p = (F.pack([x[0] for x in g1]), F.pack([x[1] for x in g1]))
    q = (T.f2_pack([x[0] for x in g2]), T.f2_pack([x[1] for x in g2]))
    jp = (_jax(p[0]), _jax(p[1]))
    jq = ((_jax(q[0][0]), _jax(q[0][1])), (_jax(q[1][0]), _jax(q[1][1])))
    ours = T._flatten12(pr.pairing(p, q))
    theirs = jpr.T._flatten12(jpr.pairing(jp, jq))
    for x, y in zip(ours, theirs):
        assert (x.numpy() == np.asarray(y).astype(np.int32)).all()
    Q = curves.pack_g2(g2)
    jQ = jcurves.pack_g2(g2)
    assert curves.unpack_g2(curves.g2.add(Q, Q)) == jcurves.unpack_g2(jcurves.g2.add(jQ, jQ))


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["cios", "rns"])
def test_batch_verify_matches_jax_constructor(backend):
    from handel_tpu.models.bls12_381_jax import BLS12381JaxConstructor

    pks, reqs, expect = reference_case()
    theirs = BLS12381JaxConstructor(batch_size=C, fp_backend=backend).batch_verify(MSG, pks, reqs)
    ours = BLS12381TorchConstructor(batch_size=C, device="cpu", fp_backend=backend,
                                    warmup=False).batch_verify(MSG, pks, reqs)
    assert ours == theirs == expect
