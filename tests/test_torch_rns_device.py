"""The port's verification engine on the RNS field backend
(`fp_backend="rns"`: per-mul RNS products for the aggregation, the
residue-resident pairing check) against the JAX package.

Verdicts must equal handel_tpu.models.bn254's host verify and the ones
known by construction; a registry bank packed by the JAX BN254Device on the
rns backend (Montgomery constant M), carried over with bank_from_numpy, must
be bit-identical to the port's own, prefix table included. Tolerance:
bitwise. The slow tier adds
verdict parity with BN254JaxScheme(fp_backend="rns") and the JAX resident
pairing, whose compiles take minutes.
"""

import random

import numpy as np
import pytest
import torch

from handel_tpu import native as nat
from handel_tpu.core.bitset import BitSet
from handel_tpu.models.bn254 import BN254PublicKey, BN254Scheme, BN254Signature, hash_to_g1
from handel_tpu.models.bn254_jax import BN254Device as JaxDevice
from handel_tpu.ops import bn254_ref as jbn
from handel_tpu.ops.curve import BN254Curves as JaxCurves
from handel_tpu_torch.kernels.fp_mont import mont_mul
from handel_tpu_torch.models.bn254_torch import (
    BN254Device,
    BN254TorchScheme,
    bank_from_numpy,
)
from handel_tpu_torch.ops.curve import BN254Curves

torch.set_num_threads(1)

N = 16
C = 4
MSG = b"rns device parity"


class SmallCapDevice(BN254Device):
    """A lowered hole cap, so that a 16-key registry reaches the dense class."""

    MISS_CAP = 2


@pytest.fixture(scope="module")
def registry():
    rng = random.Random(41)
    sks = [rng.randrange(1, 1 << 20) for _ in range(N)]
    pks = [BN254PublicKey(p) for p in nat.g2_mul_batch([jbn.G2_GEN] * N, sks)]
    return sks, pks


def candidate(sks, idx, forge=False, msg=MSG):
    bs = BitSet(N)
    for i in idx:
        bs.set(i, True)
    k = (sum(sks[i] for i in idx) + (1 if forge else 0)) % jbn.R
    return bs, BN254Signature(jbn.g1_mul(hash_to_g1(msg), k) if k else None)


def host_verdicts(pks, requests):
    return BN254Scheme().constructor.batch_verify(MSG, pks, requests)


def test_rns_range_and_dense_launches_match_host_verify(registry):
    sks, pks = registry
    rng_reqs = [
        candidate(sks, range(2, 10)),
        candidate(sks, [3, 4, 6, 8, 9, 10, 11, 12]),  # range with holes
        candidate(sks, range(0, 6), forge=True),  # wrong signature
        candidate(sks, range(5, 9), msg=b"another message"),  # wrong message
        candidate(sks, []),  # empty bitset
        candidate(sks, [15]),  # second launch: two padded lanes
    ]
    dense = [
        candidate(sks, [0, 15]),
        candidate(sks, [1, 4, 9, 13, 14], forge=True),
        candidate(sks, [0, 3, 6, 9, 12]),
    ]
    dev = BN254Device(pks, batch_size=C, device="cpu", fp_backend="rns")
    sdev = SmallCapDevice(pks, batch_size=C, curves=dev.curves)
    assert dev.curves.F.backend == "rns" and dev.pairing.resident
    assert dev._pack_requests(rng_reqs[:C]).kind == "range"
    assert sdev._pack_requests(dense).kind == "dense"
    before = mont_mul.launches
    F = dev.curves.F
    F.reset_conversion_counts()
    got = dev.batch_verify(MSG, rng_reqs)
    assert got == host_verdicts(pks, rng_reqs) == [True, True, False, False, False, True]
    got = sdev.batch_verify(MSG, dense)
    assert got == host_verdicts(pks, dense) == [True, False, True]
    assert mont_mul.launches == before
    # every pairing check converted its points in (1 + 4) and its verdict
    # out (1); the rest are the per-mul products of aggregation and affine
    counts = F.conversion_counts()
    assert counts["to_resident"] - counts["from_resident"] == 4 * 3


def test_rns_resident_off_gives_same_verdicts(registry):
    sks, pks = registry
    reqs = [candidate(sks, range(4, 12)), candidate(sks, [1, 2, 5], forge=True)]
    dev = BN254Device(pks, batch_size=2, device="cpu", fp_backend="rns", rns_resident=False)
    assert not dev.pairing.resident
    assert dev.batch_verify(MSG, reqs) == [True, False]
    with pytest.raises(ValueError, match="rns"):
        BN254Device(pks, batch_size=2, device="cpu", rns_resident=True)


def test_rns_bank_from_jax_device_is_bit_identical(registry):
    """The JAX BN254Device on the rns backend packs its registry with the
    Montgomery constant M; bank_from_numpy carries it over unchanged, equal
    to the port's own rns packing, and an engine on it verifies."""
    sks, pks = registry
    jdev = JaxDevice(pks, batch_size=C, curves=JaxCurves(backend="rns"))
    assert jdev.curves.F.mont_r == jdev.curves.F.M % jbn.P
    bank = bank_from_numpy(
        [np.asarray(a) for a in jdev._reg_x], [np.asarray(a) for a in jdev._reg_y],
        device="cpu",
    )
    curves = BN254Curves(device="cpu", backend="rns")
    own = BN254Device(pks, batch_size=C, curves=curves)
    for ours, theirs in zip(own.bank.reg_x + own.bank.reg_y, bank.reg_x + bank.reg_y):
        assert ours.dtype == theirs.dtype == torch.int32 and torch.equal(ours, theirs)
    # the cios packing differs (constant R): the bank is backend-specific
    cios = BN254Device(pks, batch_size=C, device="cpu")
    assert not torch.equal(cios.bank.reg_x[0], bank.reg_x[0])
    reqs = [candidate(sks, range(4, 12)), candidate(sks, [1, 2, 5], forge=True)]
    dev = BN254Device(batch_size=C, curves=curves, bank=bank)
    assert dev.batch_verify(MSG, reqs) == host_verdicts(pks, reqs) == [True, False]


def test_rns_scheme_surface():
    scheme = BN254TorchScheme(batch_size=C, device="cpu", warmup=False, fp_backend="rns")
    cons = scheme.constructor
    assert cons.fp_backend == "rns" and cons.curves.F.backend == "rns"
    assert BN254TorchScheme(device="cpu", warmup=False).constructor.curves.F.backend == "cios"
    with pytest.raises(ValueError, match="unknown Field backend"):
        BN254TorchScheme(device="cpu", fp_backend="vpu")


def test_rns_prefix_from_jax_device_is_bit_identical(registry):
    """The JAX rns device's prefix table (a jitted scan, ~40 s of XLA on
    one core) equals the port's own rns prefix scan, limb for limb."""
    sks, pks = registry
    jdev = JaxDevice(pks, batch_size=C, curves=JaxCurves(backend="rns"))
    (px0, px1), (py0, py1), inf = jdev._prefix
    bank = bank_from_numpy(
        [np.asarray(a) for a in jdev._reg_x], [np.asarray(a) for a in jdev._reg_y],
        prefix=((px0, px1), (py0, py1), inf), device="cpu",
    )
    own = BN254Device(pks, batch_size=C, device="cpu", fp_backend="rns")
    flat = lambda p: [p[0][0], p[0][1], p[1][0], p[1][1], p[2]]  # noqa: E731
    for ours, theirs in zip(flat(own._prefix), flat(bank.prefix)):
        assert torch.equal(ours, theirs)


@pytest.mark.slow
def test_rns_verdicts_match_jax_scheme_on_forged_batch(registry):
    """Verdict parity with BN254JaxScheme(fp_backend="rns")'s device path."""
    from handel_tpu.models.bn254_jax import BN254JaxScheme

    sks, pks = registry
    reqs = [
        candidate(sks, range(0, 8)),
        candidate(sks, range(2, 7), forge=True),
        candidate(sks, [1, 3, 5], msg=b"another message"),
        candidate(sks, range(8, 16)),
    ]
    jax_cons = BN254JaxScheme(batch_size=C, warmup=False, fp_backend="rns").constructor
    ours = BN254TorchScheme(batch_size=C, device="cpu", warmup=False, fp_backend="rns").constructor
    want = jax_cons.batch_verify(MSG, pks, reqs)
    assert ours.batch_verify(MSG, pks, reqs) == want == [True, False, False, True]


@pytest.mark.slow
def test_resident_pairing_matches_jax_resident_pairing():
    """Bit-identical GT elements from the JAX resident pairing, both taken
    out of residues with `_f12_out` (~11.5 min of XLA on one core)."""
    import jax.numpy as jnp

    from handel_tpu.ops.pairing import BN254Pairing as JaxPairing
    from handel_tpu_torch.ops.pairing import BN254Pairing

    rng = random.Random(99)
    ps = [jbn.g1_mul(jbn.G1_GEN, rng.randrange(1, jbn.R)) for _ in range(2)]
    qs = [jbn.g2_mul(jbn.G2_GEN, rng.randrange(1, jbn.R)) for _ in range(2)]
    pr = BN254Pairing(BN254Curves(device="cpu", backend="rns"))
    jpr = JaxPairing(JaxCurves(backend="rns"))
    assert pr.resident and jpr.resident
    F, T = pr.F, pr.T
    P = (F.pack([x[0] for x in ps]), F.pack([x[1] for x in ps]))
    Q = (T.f2_pack([x[0] for x in qs]), T.f2_pack([x[1] for x in qs]))
    tj = lambda t: jnp.asarray(t.numpy().astype(np.uint32))  # noqa: E731
    jP = (tj(P[0]), tj(P[1]))
    jQ = ((tj(Q[0][0]), tj(Q[0][1])), (tj(Q[1][0]), tj(Q[1][1])))
    ours = T._flatten12(pr.pairing(P, Q))
    theirs = jpr.T._flatten12(jpr.pairing(jP, jQ))
    for x, y in zip(ours, theirs):
        assert (x.numpy() == np.asarray(y).astype(np.int32)).all()
    assert T.f12_unpack(pr.pairing(P, Q)) == [jbn.pairing(q, p) for p, q in zip(ps, qs)]
