"""Validator-set rotation in the port: the engine's `stage_registry` /
`activate_staged` (handel_tpu_torch/models/bn254_torch.py) and the
lifecycle plane's `EpochManager` (handel_tpu_torch/lifecycle/epoch.py)
against the JAX package.

The same seeded registries and requests go through the JAX BN254Device and
the port's engine across a size-changing rotation (37 keys to 41) and an
equal-size one (41 to another 41): the staged prefix tables are limb-equal
to the JAX device's, a staged but unflipped bank still serves the old set,
and the range aggregates after each flip are limb-equal to the JAX
device's `_range_agg_kernel` and, with the dense ones, to the JAX
package's host oracle. The rns engine and the BLS12-381 engine rotate
against the host oracle. `EpochManager` runs the reference's rotation
case over both packages' services, and over the port's service with the
port's engine on the CPU. Tolerance: bitwise everywhere.
"""

import asyncio
import random
import time

import jax
import numpy as np
import pytest
import torch

from handel_tpu import native as nat
from handel_tpu.core.bitset import BitSet
from handel_tpu.lifecycle import EpochManager as JEpochManager
from handel_tpu.models.bls12_381 import BLS12381PublicKey
from handel_tpu.models.bn254 import BN254PublicKey, BN254Signature, hash_to_g1
from handel_tpu.models.bn254_jax import BN254Device as JaxDevice
from handel_tpu.ops import bls12_381_ref as jbls
from handel_tpu.ops import bn254_ref as jbn
from handel_tpu.parallel.batch_verifier import BatchVerifierService as JService
from handel_tpu.service import SessionManager as JSessionManager
from handel_tpu_torch.lifecycle import EpochManager
from handel_tpu_torch.models.bls12_381_torch import BLS12381Device
from handel_tpu_torch.models.bn254_torch import BN254Device
from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
from handel_tpu_torch.service import SessionManager

torch.set_num_threads(1)

C = 4
MSG = b"epoch rotation"


def bn_keys(seed, n):
    rng = random.Random(seed)
    sks = [rng.randrange(1, 1 << 20) for _ in range(n)]
    return sks, [BN254PublicKey(p) for p in nat.g2_mul_batch([jbn.G2_GEN] * n, sks)]


def range_requests(seed, n, sig=None):
    """C candidates of contiguous ranges with up to two holes each."""
    rng = random.Random(seed)
    sig = sig or BN254Signature(jbn.G1_GEN)
    reqs = []
    for _ in range(C):
        size = rng.randrange(3, n)
        lo = rng.randrange(0, n - size + 1)
        holes = set(rng.sample(range(lo + 1, lo + size - 1), min(2, size - 2)))
        bs = BitSet(n)
        for i in range(lo, lo + size):
            if i not in holes:
                bs.set(i, True)
        reqs.append((bs, sig))
    return reqs


def dense_requests(seed, n, sig):
    """C random subsets: their hulls have far more holes than MISS_CAP."""
    rng = random.Random(seed)
    reqs = []
    for _ in range(C):
        bs = BitSet(n)
        for i in rng.sample(range(n), rng.randrange(2, n // 2)):
            bs.set(i, True)
        reqs.append((bs, sig))
    return reqs


def host_agg(ref, pks, bs):
    """The JAX package's host oracle: the signers' keys summed in G2."""
    acc = None
    for i in bs.indices():
        acc = pks[i].point if acc is None else ref.g2_add(acc, pks[i].point)
    return acc


def port_aggs(dev, reqs):
    """The port's aggregate keys (affine, host ints) of one packed launch."""
    plan = dev._pack_requests(reqs)
    staged = dev._stage_plan(plan)
    bank = dev.bank
    if plan.kind == "range":
        lo, hi, mi, mo = staged[:4]
        agg = dev._range_aggregate(
            lo, hi, mi, mo, dev._prefix, bank.reg_x, bank.reg_y, plan.miss_k
        )
    else:
        words32, _, _, valid = staged
        agg = dev._dense_aggregate(bank.reg_x, bank.reg_y, words32, valid)
    return plan.kind, affine(dev.curves, agg, len(reqs))


def affine(curves, agg, k):
    x, y, inf = curves.g2.to_affine(agg)
    xs, ys = curves.T.f2_unpack(x), curves.T.f2_unpack(y)
    infs = np.asarray(inf)
    return [None if infs[j] else (xs[j], ys[j]) for j in range(k)]


def jax_range_aggs(jdev, reqs):
    plan = jdev._pack_requests(reqs)
    agg = jdev._range_agg_kernel(plan.miss_k)(*jdev._stage_plan(plan)[:4])
    jax.block_until_ready(agg)
    return affine(jdev.curves, agg, len(reqs))


def prefix_limbs(prefix):
    (x0, x1), (y0, y1), inf = prefix
    return [np.asarray(a).astype(np.int64) for a in (x0, x1, y0, y1, inf)]


class SmallCapDevice(BN254Device):
    """A lowered hole cap, so that random subsets take the dense class."""

    MISS_CAP = 2


# -- the engine: the port against the JAX BN254Device ---------------------------

A, B, B2 = bn_keys(37, 37), bn_keys(41, 41), bn_keys(43, 41)


@pytest.fixture(scope="module")
def journey():
    """Both engines through A (37 keys) -> B (41) -> B2 (41), recording at
    each step what the cases below compare. The JAX device compiles its
    prefix scan at each staging and its range kernel at each registry size
    (about a minute each on one core), so the journey runs once for the
    module, and A's bank on the JAX device (limb-equal to the port's since
    tests/test_torch_bn254_device.py) is never scanned: before the first
    flip the port answers to the host oracle alone."""
    jdev = JaxDevice(A[1], batch_size=C)
    pdev = BN254Device(A[1], batch_size=C, device="cpu")
    rec = {}
    for name, (_, old), (_, new), seed in (("size change", A, B, 3), ("equal size", B, B2, 5)):
        n_old, n_new = len(old), len(new)
        reqs_old = range_requests(seed, n_old)
        step = {"n": (n_old, n_new)}
        assert pdev.stage_registry(new) == jdev.stage_registry(new) == n_new
        step["staged prefix"] = (
            prefix_limbs(jdev._staged["prefix"]), prefix_limbs(pdev._staged.prefix)
        )
        # staged, not flipped: the old set still serves
        step["unflipped"] = (
            jax_range_aggs(jdev, reqs_old) if name == "equal size" else None,
            port_aggs(pdev, reqs_old)[1],
            [host_agg(jbn, old, bs) for bs, _ in reqs_old],
        )
        epochs = (jdev.activate_staged(), pdev.activate_staged())
        step["epochs"] = epochs
        step["n after"] = (jdev.n, pdev.n, pdev.bank.n, pdev._stage[0].words.shape[1])
        reqs_new = range_requests(seed + 1, n_new)
        step["flipped range"] = (
            jax_range_aggs(jdev, reqs_new),
            port_aggs(pdev, reqs_new),
            [host_agg(jbn, new, bs) for bs, _ in reqs_new],
        )
        rec[name] = step
    return rec, pdev


@pytest.mark.parametrize("step", ["size change", "equal size"])
def test_rotation_matches_jax_device(journey, step):
    rec, _ = journey
    st = rec[step]
    n_old, n_new = st["n"]
    j, p = st["staged prefix"]
    assert p[0].shape == (16, n_new + 1)
    assert all((a == b).all() for a, b in zip(j, p))
    jax_old, port_old, host_old = st["unflipped"]
    assert port_old == host_old
    if jax_old is not None:
        assert port_old == jax_old
    assert st["epochs"] == ((1, 1) if step == "size change" else (2, 2))
    assert st["n after"] == (n_new, n_new, n_new, (n_new + 63) // 64)
    jax_new, (kind, port_new), host_new = st["flipped range"]
    assert kind == "range"
    assert port_new == jax_new == host_new


def test_dense_aggregates_after_rotations_match_host():
    dev = SmallCapDevice(A[1], batch_size=C, device="cpu")
    sig = BN254Signature(jbn.G1_GEN)
    for _, pks in (B, B2):
        dev.stage_registry(pks, build_prefix=False)
        assert dev._staged.prefix is None
        dev.activate_staged()
        reqs = dense_requests(len(pks), len(pks), sig)
        kind, got = port_aggs(dev, reqs)
        assert kind == "dense"
        assert got == [host_agg(jbn, pks, bs) for bs, _ in reqs]
    assert dev.epoch == 2 and dev.registry_stagings == 2


def test_verdicts_follow_the_flip():
    """A candidate signed under the new set verifies only after the flip;
    one signed under the old set only before it."""
    (sks_a, pks_a), (sks_b, pks_b) = bn_keys(7, 8), bn_keys(8, 8)
    dev = BN254Device(pks_a, batch_size=C, device="cpu")

    def cand(sks, idx):
        bs = BitSet(8)
        for i in idx:
            bs.set(i, True)
        k = sum(sks[i] for i in idx) % jbn.R
        return bs, BN254Signature(jbn.g1_mul(hash_to_g1(MSG), k))

    reqs = [cand(sks_a, range(1, 6)), cand(sks_b, range(1, 6))]
    assert dev.batch_verify(MSG, reqs) == [True, False]
    dev.stage_registry(pks_b)
    assert dev.batch_verify(MSG, reqs) == [True, False]
    dev.activate_staged()
    assert dev.batch_verify(MSG, reqs) == [False, True]


def test_activate_without_stage_raises_as_the_reference():
    dev = BN254Device(A[1][:8], batch_size=C, device="cpu")
    with pytest.raises(RuntimeError, match="no staged registry: call stage_registry first"):
        dev.activate_staged()
    dev.stage_registry(A[1][:8])
    dev.activate_staged()
    with pytest.raises(RuntimeError, match="no staged registry: call stage_registry first"):
        dev.activate_staged()
    with pytest.raises(ValueError, match="valid G2 points"):
        dev.stage_registry([BN254PublicKey(None)])


def test_rns_engine_rotates():
    (_, pks_a), (_, pks_b) = bn_keys(21, 10), bn_keys(22, 12)
    dev = BN254Device(pks_a, batch_size=C, device="cpu", fp_backend="rns")
    assert dev.stage_registry(pks_b) == 12
    reqs_a = range_requests(9, 10)
    assert port_aggs(dev, reqs_a)[1] == [host_agg(jbn, pks_a, bs) for bs, _ in reqs_a]
    assert dev.activate_staged() == 1
    reqs_b = range_requests(10, 12)
    assert port_aggs(dev, reqs_b)[1] == [host_agg(jbn, pks_b, bs) for bs, _ in reqs_b]


def test_bls12_381_engine_rotates():
    def keys(seed, n):
        rng = random.Random(seed)
        return [BLS12381PublicKey(jbls.g2_mul(jbls.G2_GEN, rng.randrange(1, 1 << 30)))
                for _ in range(n)]

    pks_a, pks_b = keys(1, 6), keys(2, 6)
    dev = BLS12381Device(pks_a, batch_size=C, device="cpu")
    assert dev.stage_registry(pks_b) == 6
    assert dev.activate_staged() == 1
    reqs = range_requests(12, 6)
    kind, got = port_aggs(dev, reqs)
    assert kind == "range" and got == [host_agg(jbls, pks_b, bs) for bs, _ in reqs]


# -- EpochManager over the service ----------------------------------------------


class _Sig:
    def __init__(self, tag: int = 0):
        self.tag = tag

    def marshal(self) -> bytes:
        return self.tag.to_bytes(4, "big")


def _req(tag: int, n: int = 16):
    bs = BitSet(n)
    bs.set(tag % n, True)
    return (bs, _Sig(tag))


class StubEngine:
    """tests/test_lifecycle.py's dispatch_multi stub with the epoch-rotation
    protocol."""

    def __init__(self, launch_s: float = 0.0):
        self.batch_size = 16
        self.launch_s = launch_s
        self.dispatched = 0
        self.epoch = 0
        self._staged = None

    def stage_registry(self, registry_pubkeys, build_prefix: bool = True):
        self._staged = list(registry_pubkeys)
        return len(self._staged)

    def activate_staged(self):
        if self._staged is None:
            raise RuntimeError("no staged registry")
        self._staged = None
        self.epoch += 1
        return self.epoch

    def dispatch_multi(self, items):
        if self.launch_s:
            time.sleep(self.launch_s)
        self.dispatched += 1
        return [True] * len(items)

    def fetch(self, handle):
        return handle


PKGS = {
    "ref": (JService, JSessionManager, JEpochManager),
    "port": (BatchVerifierService, SessionManager, EpochManager),
}


def rotation_case(pkg):
    """tests/test_lifecycle.py::test_epoch_rotation_zero_drops_and_versioned_dedup."""
    Service, Manager, Epochs = PKGS[pkg]

    async def go():
        eng = StubEngine(launch_s=0.002)
        svc = Service(eng, max_delay_ms=0.2)
        mgr = Manager(service=svc, max_sessions=4)
        em = Epochs(svc, mgr)
        before = [asyncio.ensure_future(svc.verify(b"m", [], [_req(i)], session="s"))
                  for i in range(6)]
        await asyncio.sleep(0.001)
        d0 = eng.dispatched
        stall = await em.rotate([f"pk{i}" for i in range(8)])
        after = [asyncio.ensure_future(svc.verify(b"m", [], [_req(i)], session="s"))
                 for i in range(6)]
        r_before = await asyncio.gather(*before)
        r_after = await asyncio.gather(*after)
        svc.stop()
        vals = em.values()
        return {
            "verdicts": r_before + r_after,
            "epochs": (svc.epoch, mgr.epoch, em.epoch, eng.epoch),
            "staged": eng._staged,
            "rotations": em.rotations,
            "redispatched": eng.dispatched > d0,
            "stall matches": vals["lastEpochSwapStallMs"] == pytest.approx(stall * 1e3),
            "keys": sorted(vals),
            "gauges": sorted(em.gauge_keys()),
            "counts": (vals["epoch"], vals["epochRotations"], vals["epochStagings"]),
        }

    return asyncio.run(go())


def test_epoch_rotation_zero_drops_and_versioned_dedup_as_the_reference():
    got, ref = rotation_case("port"), rotation_case("ref")
    assert got == ref
    assert got["verdicts"] == [[True]] * 12
    assert got["epochs"] == (1, 1, 1, 1) and got["staged"] is None
    assert got["redispatched"] and got["stall matches"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_commit_without_stage_raises(pkg):
    Service, _, Epochs = PKGS[pkg]

    async def go():
        em = Epochs(Service(StubEngine()))
        with pytest.raises(RuntimeError, match="no staged rotation: call begin_rotation first"):
            await em.commit_rotation()

    asyncio.run(go())


def test_epoch_manager_rotates_the_port_engine_under_the_service():
    """The card phase's rotation on the CPU: the port's engine behind the
    port's service, a launch in flight while the next set stages, and the
    epoch's dedup keys versioned, so a candidate sent again after the flip
    is judged against the new bank."""
    (sks_a, pks_a), (sks_b, pks_b) = bn_keys(7, 8), bn_keys(8, 8)

    def cand(sks, idx):
        bs = BitSet(8)
        for i in idx:
            bs.set(i, True)
        k = sum(sks[i] for i in idx) % jbn.R
        return bs, BN254Signature(jbn.g1_mul(hash_to_g1(MSG), k))

    async def go():
        dev = BN254Device(pks_a, batch_size=C, device="cpu")
        svc = BatchVerifierService(dev, max_delay_ms=1.0, fallback=None)
        em = EpochManager(svc)
        old = cand(sks_a, range(0, 5))
        r0 = await svc.verify(MSG, pks_a, [old, cand(sks_a, range(2, 8))], session="s0")
        inflight = asyncio.ensure_future(
            svc.verify(MSG, pks_a, [cand(sks_a, range(1, 4))], session="s1"))
        await em.begin_rotation(pks_b)
        await em.commit_rotation()
        r_in = await inflight
        r1 = await svc.verify(MSG, pks_b, [old, cand(sks_b, range(0, 6))], session="s0")
        vals = svc.values()
        svc.stop()
        return dev, svc, r0, r_in, r1, vals

    dev, svc, r0, r_in, r1, vals = asyncio.run(go())
    assert r0 == [True, True] and r_in == [True]
    assert r1 == [False, True]  # the old candidate again: not a dedup hit
    assert svc.epoch == dev.epoch == 1 and dev.registry_stagings == 1
    assert vals["failoverCandidates"] == 0.0
