"""The port's batched aggregate combine (models/bn254_torch.py
`BN254Device.combine_batch`, `BN254TorchConstructor.device_combine`) against
the host fold and against the JAX package's `BN254Device.combine_batch`.

Groups hold seeded random G1 points and infinities; a chunk wider than
batch_size runs the chunking. Exact equality throughout: the same affine
points (None = infinity) per group, the same declines.
"""

import random

import pytest
import torch

from handel_tpu import native as nat
from handel_tpu.models.bn254 import BN254PublicKey as JaxPublicKey
from handel_tpu.models.bn254_jax import BN254Device as JaxDevice
from handel_tpu.ops import bn254_ref as jbn
from handel_tpu_torch.models.bn254 import BN254PublicKey
from handel_tpu_torch.models.bn254_torch import BN254Device, BN254TorchConstructor
from handel_tpu_torch.ops import bn254_ref as bn

torch.set_num_threads(1)

N = 4
C = 4


@pytest.fixture(scope="module")
def points():
    rng = random.Random(19)
    sks = [rng.randrange(1, 1 << 20) for _ in range(N)]
    pks = nat.g2_mul_batch([jbn.G2_GEN] * N, sks)
    g1 = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(12)]
    return pks, g1


@pytest.fixture(scope="module")
def device(points):
    pks, _ = points
    return BN254Device([BN254PublicKey(p) for p in pks], batch_size=C, device="cpu")


@pytest.fixture(scope="module")
def jax_device(points):
    pks, _ = points
    return JaxDevice([JaxPublicKey(p) for p in pks], batch_size=C)


def host_fold(group):
    acc = None
    for p in group:
        if p is not None:
            acc = p if acc is None else bn.g1_add(acc, p)
    return acc


def class_groups(g1, k: int, seed: int):
    """2C + 1 groups (a chunk wider than batch_size) whose widest member has
    k points, so the chunks' class is k; some points are infinity, and one
    group cancels to infinity (P + (-P))."""
    rng = random.Random(seed)
    groups = [
        [rng.choice(g1 + [None]) for _ in range(rng.randrange(1, k + 1))]
        for _ in range(2 * C + 1)
    ]
    for start in (0, C, 2 * C):  # every chunk reaches the class width
        groups[start] = [rng.choice(g1) for _ in range(k - 1)] + [None]
    p = rng.choice(g1)
    groups[1] = [p, bn.g1_neg(p)]
    return groups


@pytest.mark.parametrize("k", [2, 4, 8])
def test_combine_batch_matches_host_fold(device, points, k):
    _, g1 = points
    groups = class_groups(g1, k, seed=100 + k)
    got = device.combine_batch(groups)
    assert got == [host_fold(g) for g in groups]
    assert got[1] is None  # P + (-P)
    assert k in device._combine_ready


@pytest.mark.parametrize("k", [2, 4, 8])
def test_combine_batch_matches_jax_device(device, jax_device, points, k):
    _, g1 = points
    groups = class_groups(g1, k, seed=200 + k)
    assert device.combine_batch(groups) == jax_device.combine_batch(groups)


def test_compiled_only_declines_an_unready_class(device, jax_device, points):
    """k = 16 has not run on either side: both decline the chunk."""
    _, g1 = points
    groups = [g1[:9], g1[:2]]
    assert device.combine_batch(groups, compiled_only=True) == [None, None]
    assert jax_device.combine_batch(groups, compiled_only=True) == [None, None]
    assert 16 not in device._combine_ready
    got = device.combine_batch(groups)  # compiled_only=False runs the class
    assert got == [host_fold(g) for g in groups]
    assert device.combine_batch(groups, compiled_only=True) == got


def test_device_combine_before_prepare_and_after_warmup(points):
    pks, g1 = points
    cons = BN254TorchConstructor(batch_size=C, device="cpu", warmup=False)
    assert cons.device_combine([[bn.G1_GEN, bn.G1_GEN]]) is None
    cons.prepare([BN254PublicKey(p) for p in pks])
    # no warmup: no class has run, so the hook declines per group
    assert cons.device_combine([g1[:2], g1[:3]]) == [None, None]
    assert cons._device.warmup() == 4  # one verify launch, classes 2, 4, 8
    assert cons._device._combine_ready == {2, 4, 8}
    groups = [g1[:2], g1[:3], g1[3:8]]
    assert cons.device_combine(groups) == [host_fold(g) for g in groups]


def test_rns_engine_combines_on_the_cios_field(points):
    """An rns engine's combine runs on the cios field while its verify stays
    on rns; the sums equal the host fold."""
    pks, g1 = points
    dev = BN254Device([BN254PublicKey(p) for p in pks], batch_size=C, device="cpu",
                      fp_backend="rns")
    assert dev.curves.F.backend == "rns"
    assert dev._combine_curves.F.backend == "cios"
    groups = class_groups(g1, 4, seed=304)
    assert dev.combine_batch(groups) == [host_fold(g) for g in groups]


def test_combine_op_counts_per_field():
    """utils/opcount.py's combine count: on the cios field the chunk's
    multiplies are 332 kernel calls (325 of them the Fermat inverse); on
    the rns field the per-mul product issues more than 30x the ops, which is
    why the engine combines on cios whatever its backend."""
    from handel_tpu_torch.utils.opcount import count_combine

    cios, rns = count_combine("cios", C), count_combine("rns", C)
    assert (cios["kernel_calls"], cios["scopes"]["field_inv"]) == (332, 325)
    assert rns["kernel_calls"] == 0
    assert rns["kernel_launching_ops"] > 30 * cios["kernel_launching_ops"]
