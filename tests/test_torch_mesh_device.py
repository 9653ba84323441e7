"""The port's sharded pairing check and its engine over a mesh
(`BN254Device(mesh_devices=K)`), on K shards of the CPU.

The JAX package's sharded pairing check and its wired mesh engine are in
its slow tier (tests/test_sharding.py), so the port's are held here against
the port's own single-device `pairing_check` and engine, whose verdicts the
other tests hold to the JAX package's, and against the host oracle
(ops/bn254_ref.py). The launch classes run through the shards as on the
card: a range launch aggregates on the first shard and splits its
candidates' pairing checks over the shards; a dense launch sums the
registry shard by shard, edge-padded where K does not divide it.
"""

import functools
import random

import pytest
import torch

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.models.bn254 import (
    BN254PublicKey,
    BN254Scheme,
    BN254Signature,
    hash_to_g1,
)
from handel_tpu_torch.models.bn254_torch import BN254Device
from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops.curve import BN254Curves
from handel_tpu_torch.ops.pairing import BN254Pairing
from handel_tpu_torch.parallel.sharding import make_mesh, sharded_pairing_check

GROUPS = 4


@functools.lru_cache(maxsize=None)
def pairing_inputs():
    """Pair 0 e(H, pk_j), pair 1 e(-sig_j, G2): a BLS verify as one product
    per candidate, candidate 2 forged, candidate 3 masked out; the oracle's
    verdicts beside them."""
    rng = random.Random(41)
    h = bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R))
    sks = [rng.randrange(1, bn.R) for _ in range(GROUPS)]
    pks = [bn.g2_mul(bn.G2_GEN, sk) for sk in sks]
    sigs = [bn.g1_mul(h, sk) for sk in sks]
    sigs[2] = bn.g1_mul(h, sks[2] + 1)
    mask = [True, True, True, False]
    oracle = [
        m and bn.f12_mul(bn.pairing(pk, h), bn.pairing(bn.G2_GEN, bn.g1_neg(s))) == bn.F12_ONE
        for pk, s, m in zip(pks, sigs, mask)
    ]
    return h, pks, sigs, mask, oracle


def packed(curves):
    h, pks, sigs, mask, _ = pairing_inputs()
    F, T = curves.F, curves.T

    def pack1(pts):
        return F.pack([p[0] for p in pts]), F.pack([p[1] for p in pts])

    def pack2(pts):
        return T.f2_pack([q[0] for q in pts]), T.f2_pack([q[1] for q in pts])

    ps = (pack1([h] * GROUPS), pack1([bn.g1_neg(s) for s in sigs]))
    qs = (pack2(pks), pack2([bn.G2_GEN] * GROUPS))
    return ps, qs, torch.tensor(mask)


@functools.lru_cache(maxsize=None)
def single_device_verdicts():
    """The port's single-device pairing_check on the same lanes, in its
    chunk-major layout, with the mask folded in."""
    curves = BN254Curves(device="cpu")
    (p0, p1), (q0, q1), mask = packed(curves)
    cat = lambda a, b: torch.cat([a, b], dim=1)  # noqa: E731
    px, py = cat(p0[0], p1[0]), cat(p0[1], p1[1])
    qx = (cat(q0[0][0], q1[0][0]), cat(q0[0][1], q1[0][1]))
    qy = (cat(q0[1][0], q1[1][0]), cat(q0[1][1], q1[1][1]))
    ok = BN254Pairing(curves).pairing_check((px, py), (qx, qy), torch.cat([mask, mask]), GROUPS)
    return (ok & mask).tolist()


@pytest.mark.parametrize("k", [1, 2, 3])
def test_sharded_pairing_check_matches_single_device_and_oracle(k):
    """k in {1, 2, 3}: 4 candidates split 4, 2/2 and 2/2/pad (6 lanes a pair,
    the padded ones invalid); the verdicts are the single-device check's and
    the host oracle's, the masked candidate False."""
    curves = BN254Curves(device="cpu")
    ps, qs, mask = packed(curves)
    fn = sharded_pairing_check(BN254Pairing(curves), make_mesh(k, devices=["cpu"] * k), GROUPS)
    got = fn(ps, qs, mask).tolist()
    assert got == single_device_verdicts() == pairing_inputs()[4] == [True, True, False, False]


# -- the wired engine ----------------------------------------------------------------

N_REG = 50  # 50 % 3 == 2: the last registry shard carries one padded point
MSG = b"sharded-verify"


@functools.lru_cache(maxsize=None)
def registry(seed=7):
    rng = random.Random(seed)
    sks = [rng.randrange(1, 1 << 30) for _ in range(N_REG)]
    return sks, [BN254PublicKey(bn.g2_mul(bn.G2_GEN, s)) for s in sks]


def candidate(sks, signers, forge=False):
    bs = BitSet(N_REG)
    for i in signers:
        bs.set(i, True)
    k = (sum(sks[i] for i in signers) + forge) % bn.R
    return bs, BN254Signature(bn.g1_mul(hash_to_g1(MSG), k))


@functools.lru_cache(maxsize=None)
def candidates():
    """Range candidates (contiguous ranges with a few holes) and dense ones
    (scattered halves of the registry: more holes than the dense test's
    engine allows a range launch), one forged in each."""
    sks, _ = registry()
    rng = random.Random(11)
    ranges = [candidate(sks, [i for i in range(lo, lo + 20) if i % 7], forge=(j == 1))
              for j, lo in enumerate((0, 5, 17, 30))]
    dense = [candidate(sks, sorted(rng.sample(range(N_REG), N_REG // 2)), forge=(j == 3))
             for j in range(4)]
    return ranges, dense


@functools.lru_cache(maxsize=None)
def single_engine_verdicts():
    """The single-device engine's verdicts on every candidate, range and
    dense, in one launch of 8 lanes (on the rns backend: the verdicts are
    the cios engine's, tests/test_torch_rns_device.py)."""
    _, pks = registry()
    ranges, dense = candidates()
    return BN254Device(pks, batch_size=8, device="cpu", fp_backend="rns").batch_verify(
        MSG, ranges + dense)


def mesh_engine(fp_backend=None, miss_cap=None):
    _, pks = registry()
    eng = BN254Device(pks, batch_size=4, device="cpu", mesh_devices=3, fp_backend=fp_backend)
    if miss_cap is not None:
        eng.MISS_CAP = miss_cap  # scattered halves of 50 keys pack dense
    return eng


def test_mesh_dense_batch_verify_equals_the_single_device_engine():
    """The main path's field (cios): a dense launch over 3 shards, the
    registry summed shard by shard; verdicts as the single-device engine's,
    the forgery rejected; the mesh counters count it."""
    eng = mesh_engine(miss_cap=8)
    assert eng.mesh.size == 3 and eng._mesh_pad == 1
    _, dense = candidates()
    assert eng._pack_requests(dense).kind == "dense"
    got = eng.batch_verify(MSG, dense)
    assert got == single_engine_verdicts()[4:] == [True, True, True, False]
    assert (eng.mesh_launches, eng.mesh_candidates) == (1, 4)


def test_mesh_range_batch_verify_equals_the_single_device_engine():
    """A range launch on the rns backend (the resident pairing on each
    shard): aggregation on the first shard, the candidates' checks over 3
    shards; verdicts as the single-device engine's."""
    eng = mesh_engine(fp_backend="rns")
    ranges, _ = candidates()
    assert eng._pack_requests(ranges).kind == "range"
    got = eng.batch_verify(MSG, ranges)
    assert got == single_engine_verdicts()[:4] == [True, False, True, True]
    assert eng.mesh_launches == 1


def test_mesh_epoch_flip_recommits_the_shards_and_refuses_a_resize():
    """An equal-size rotation re-commits the registry shards: a candidate
    signed by the new set verifies and the same signers' old aggregate does
    not. A staged set of another size is refused with the reference's
    words, and the active set keeps serving."""
    eng = mesh_engine(fp_backend="rns")
    sks_b, pks_b = registry(seed=8)
    assert eng.stage_registry(pks_b) == N_REG
    assert eng.activate_staged() == 1
    shards = eng._reg_sharded[0][0]
    assert [tuple(s.shape) for s in shards] == [(16, 17)] * 3
    assert torch.equal(torch.cat(list(shards), dim=1)[:, :N_REG], eng.bank.reg_x[0])
    sks_a, _ = registry()
    signers = list(range(3, 40))
    reqs = [candidate(sks_b, signers), candidate(sks_a, signers)]
    assert eng.batch_verify(MSG, reqs) == [True, False]
    eng.stage_registry(pks_b[:-1])
    with pytest.raises(RuntimeError, match=rf"equal-size validator set \(active {N_REG}, "
                                           rf"staged {N_REG - 1}\)"):
        eng.activate_staged()
    assert eng.epoch == 1 and eng.n == N_REG


def test_mesh_engine_through_the_scheme_and_the_host_oracle():
    """`BN254TorchScheme(mesh_devices=2, device="cpu")` builds a two-shard
    engine; the host scheme's oracle agrees with it on a forged and an
    honest candidate."""
    from handel_tpu_torch.models.bn254_torch import BN254TorchScheme

    sks, pks = registry()
    cons = BN254TorchScheme(batch_size=2, device="cpu", mesh_devices=2, warmup=False,
                            fp_backend="rns").constructor
    reqs = [candidate(sks, range(0, 30), forge=True), candidate(sks, range(10, 50))]
    got = cons.batch_verify(MSG, pks, reqs)
    assert cons._device.mesh.size == 2 and cons._device.mesh_launches == 1
    assert got == BN254Scheme().constructor.batch_verify(MSG, pks, reqs) == [False, True]


# -- the reference's slow-tier shapes (tests/test_sharding.py:362, :403) ------------


def _scaled_keys(n, seed):
    rng = random.Random(seed)
    sks = [rng.randrange(1, 1 << 30) for _ in range(n)]
    return sks, [BN254PublicKey(bn.g2_mul(bn.G2_GEN, s)) for s in sks]


@pytest.mark.slow
def test_device_batch_verify_sharded_over_eight_shards():
    """The wired dense path at the reference's shape: 50 keys over 8 shards
    (50 % 8 == 2), 16 lanes, 6 scattered halves, the fourth forged."""
    n = 50
    sks, pks = _scaled_keys(n, 7)
    h = hash_to_g1(MSG)
    rng = random.Random(11)
    requests = []
    for j in range(6):
        signers = sorted(rng.sample(range(n), n // 2))
        bs = BitSet(n)
        for i in signers:
            bs.set(i, True)
        agg = sum(sks[i] for i in signers) + (j == 3)
        requests.append((bs, BN254Signature(bn.g1_mul(h, agg % bn.R))))
    dev = BN254Device(pks, batch_size=16, device="cpu", mesh_devices=8)
    dev.MISS_CAP = 8  # the reference's halves of 50 keys pack dense there
    assert dev._pack_requests(requests).kind == "dense"
    assert dev.batch_verify(MSG, requests) == [True, True, True, False, True, True]


@pytest.mark.slow
def test_sharded_pipeline_reference_scale():
    """1030 keys (padded over 8 shards), 32 range candidates of 64 to 256
    keys with a few holes, two launches of 16 lanes: every one verifies."""
    n, n_cand = 1030, 32
    sks, pks = _scaled_keys(n, 23)
    h = hash_to_g1(MSG)
    rng = random.Random(29)
    requests = []
    for _ in range(n_cand):
        size = rng.choice([64, 128, 256])
        lo = rng.randrange(0, n - size)
        holes = set(rng.sample(range(lo, lo + size), rng.randrange(0, 5)))
        signers = [i for i in range(lo, lo + size) if i not in holes]
        bs = BitSet(n)
        for i in signers:
            bs.set(i, True)
        requests.append((bs, BN254Signature(bn.g1_mul(h, sum(sks[i] for i in signers) % bn.R))))
    dev = BN254Device(pks, batch_size=16, device="cpu", mesh_devices=8)
    assert dev.batch_verify(MSG, requests) == [True] * n_cand
