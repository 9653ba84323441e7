"""The port's verification engine (handel_tpu_torch/models/bn254_torch.py)
against the JAX package: verdicts, launch packing and the registry bank.

Requests are built with the JAX package's BitSet and signature objects and
handed unchanged to both packages (the port's packer duck-types them, as it
must when handel_tpu's LocalCluster drives a port scheme). Verdicts must
equal handel_tpu.models.bn254's host verify and the ones known by
construction; plans must equal the per-candidate oracle and the JAX
packer's; a bank taken from a JAX BN254Device must equal the port's own.
"""

import asyncio
import random

import numpy as np
import pytest
import torch

from handel_tpu import native as nat
from handel_tpu.core.bitset import BitSet
from handel_tpu.models.bn254 import BN254PublicKey, BN254Scheme, BN254Signature, hash_to_g1
from handel_tpu.models.bn254_jax import BN254Device as JaxDevice
from handel_tpu.ops import bn254_ref as jbn
from handel_tpu_torch.models.bn254_torch import (
    BN254Device,
    BN254TorchScheme,
    bank_from_numpy,
)

torch.set_num_threads(1)

N = 16
C = 4
MSG = b"device parity"


class SmallCapDevice(BN254Device):
    """A lowered hole cap, so that a 16-key registry reaches the dense class."""

    MISS_CAP = 2


@pytest.fixture(scope="module")
def registry():
    rng = random.Random(31)
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


def test_range_launches_match_host_verify(registry):
    sks, pks = registry
    reqs = [
        candidate(sks, range(2, 10)),  # contiguous range
        candidate(sks, [3, 4, 6, 8, 9, 10, 11, 12]),  # range with holes
        candidate(sks, range(0, 6), forge=True),  # wrong signature
        candidate(sks, range(5, 9), msg=b"another message"),  # wrong message
        candidate(sks, []),  # empty bitset
        candidate(sks, [0, 1]),
        candidate(sks, [15]),  # second launch: one padded lane
    ]
    dev = BN254Device(pks, batch_size=C, device="cpu")
    assert dev._pack_requests(reqs[:C]).kind == "range"
    got = dev.batch_verify(MSG, reqs)
    assert got == host_verdicts(pks, reqs)
    assert got == [True, True, False, False, False, True, True]
    assert dev.host_pack_launches == dev.host_dispatch_launches == 2


def test_dense_launch_matches_host_verify(registry):
    sks, pks = registry
    reqs = [
        candidate(sks, [0, 15]),
        candidate(sks, [1, 4, 9, 13, 14], forge=True),
        candidate(sks, [2, 7, 11], msg=b"another message"),
        candidate(sks, []),  # empty bitset
        candidate(sks, [0, 3, 6, 9, 12]),  # second launch: three padded lanes
    ]
    dev = SmallCapDevice(pks, batch_size=C, device="cpu")
    for chunk in (reqs[:C], reqs[C:]):
        plan = dev._pack_requests(chunk)
        assert plan.kind == "dense"
        # the on-device unpack of the words equals the loop oracle's mask
        words32 = torch.from_numpy(plan.words.view(np.int64)).view(torch.int32)
        mask = dev._unpack_words(words32, torch.from_numpy(plan.valid)).reshape(N, C)
        assert (mask.numpy() == dev._pack_requests_loop(chunk).mask).all()
    got = dev.batch_verify(MSG, reqs)
    assert got == host_verdicts(pks, reqs) == [True, False, False, False, True]


def test_unpack_words_reads_bit_31_and_63():
    """int32 shifts are arithmetic: the top bit of each 32-bit half must
    still read as a set bit, and nothing beyond it."""
    pks = [BN254PublicKey(p) for p in nat.g2_mul_batch([jbn.G2_GEN] * 64, range(1, 65))]
    dev = BN254Device(pks, batch_size=2, device="cpu")
    words = np.array([[1 << 31 | 1 << 63], [1 << 32]], dtype=np.uint64)
    words32 = torch.from_numpy(words.view(np.int64)).view(torch.int32)
    mask = dev._unpack_words(words32, torch.tensor([True, True])).reshape(64, 2)
    assert mask[:, 0].nonzero().flatten().tolist() == [31, 63]
    assert mask[:, 1].nonzero().flatten().tolist() == [32]


def test_port_bitset_matches_jax_bitset():
    from handel_tpu_torch.core.bitset import BitSet as PortBitSet

    rng = random.Random(9)
    for n in (0, 1, 63, 64, 65, 130):
        ours, theirs = PortBitSet(n), BitSet(n)
        for i in rng.sample(range(n), n // 3):
            ours.set(i, True)
            theirs.set(i, True)
        if n:
            ours.set(n - 1, False)
            theirs.set(n - 1, False)
        assert len(ours) == len(theirs) == n
        assert (ours.words() == theirs.words()).all()
        assert ours.indices() == theirs.indices()
        assert ours.cardinality() == theirs.cardinality()
        assert ours.clone() == ours and all(ours.get(i) == theirs.get(i) for i in range(n))
    with pytest.raises(IndexError):
        PortBitSet(4).set(4, True)


def _rand_request(rng, n, kind, sig):
    bs = BitSet(n)
    if kind == "empty":
        return (bs, sig)
    if kind == "nosig":
        for i in rng.sample(range(n), 5):
            bs.set(i, True)
        return (bs, object())  # no .point: the lane is masked out
    max_holes = {"range8": 9, "range64": 60, "dense": None}[kind]
    size = rng.randrange(1, n)
    lo = rng.randrange(0, n - size + 1)
    n_holes = rng.randrange(0, size if max_holes is None else min(size, max_holes))
    holes = set(rng.sample(range(lo, lo + size), n_holes)) - {lo, lo + size - 1}
    for i in range(lo, lo + size):
        if i not in holes:
            bs.set(i, True)
    return (bs, sig)


def _mask(plan, n):
    """A dense plan's (n, C) candidate mask: the loop oracle's own, or
    unpacked from the words the device receives."""
    if plan.mask is not None:
        return np.asarray(plan.mask)
    bits = np.unpackbits(
        np.asarray(plan.words).view(np.uint8), axis=1, count=n, bitorder="little"
    ).view(np.bool_)
    return (bits & np.asarray(plan.valid)[:, None]).T


def _assert_plans_equal(a, b, n, ctx):
    assert (a.kind, a.miss_k) == (b.kind, b.miss_k), ctx
    for f in ("lo", "hi", "miss_idx", "miss_ok", "valid", "sig_x", "sig_y"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), (ctx, f)
        if x is not None:
            x, y = np.asarray(x).astype(np.int64), np.asarray(y).astype(np.int64)
            assert x.shape == y.shape and (x == y).all(), (ctx, f)
    if a.kind == "dense":
        assert (_mask(a, n) == _mask(b, n)).all(), (ctx, "mask")


def test_pack_requests_matches_loop_oracle_and_jax():
    """Vectorized packing == the loop oracle == the JAX packer, over random
    batches of every class, across staging-rotation boundaries."""
    n = 130  # > MISS_CAP + 3: the dense class is reachable
    rng = random.Random(5)
    sks = [rng.randrange(1, 1 << 20) for _ in range(n)]
    pks = [BN254PublicKey(p) for p in nat.g2_mul_batch([jbn.G2_GEN] * n, sks)]
    dev = BN254Device(pks, batch_size=8, device="cpu")
    jdev = JaxDevice(pks, batch_size=8)
    pts = [BN254Signature(jbn.g1_mul(jbn.G1_GEN, k)) for k in range(2, 6)]
    kinds = ["range8", "range64", "dense", "empty", "nosig"]
    seen = set()
    for trial in range(40):
        reqs = [
            _rand_request(rng, n, rng.choice(kinds), rng.choice(pts))
            for _ in range(rng.randrange(0, 9))
        ]
        plan = dev._pack_requests(reqs)
        seen.add(plan.kind)
        _assert_plans_equal(plan, dev._pack_requests_loop(reqs), n, trial)
        _assert_plans_equal(plan, jdev._pack_requests(reqs), n, trial)
    assert seen == {"range", "dense"}
    with pytest.raises(ValueError):
        dev._pack_requests([(BitSet(n - 1), pts[0])])


def test_bank_from_jax_device_is_bit_identical(registry):
    """The JAX BN254Device's registry bank and prefix table, carried over
    with bank_from_numpy, equal the port's own packing and prefix scan, and
    a device built on that bank gives the same verdicts."""
    sks, pks = registry
    jdev = JaxDevice(pks, batch_size=C)
    (px0, px1), (py0, py1), inf = jdev._prefix
    bank = bank_from_numpy(
        [np.asarray(a) for a in jdev._reg_x],
        [np.asarray(a) for a in jdev._reg_y],
        prefix=((px0, px1), (py0, py1), inf),
        device="cpu",
    )
    own = BN254Device(pks, batch_size=C, device="cpu")
    for ours, theirs in zip(own.bank.reg_x + own.bank.reg_y, bank.reg_x + bank.reg_y):
        assert ours.dtype == theirs.dtype == torch.int32 and torch.equal(ours, theirs)
    own_prefix = own._prefix
    flat = lambda p: [p[0][0], p[0][1], p[1][0], p[1][1], p[2]]  # noqa: E731
    for ours, theirs in zip(flat(own_prefix), flat(bank.prefix)):
        assert torch.equal(ours, theirs)
    reqs = [
        candidate(sks, range(4, 12)),
        candidate(sks, [1, 2, 5], forge=True),
        candidate(sks, range(0, 16)),
    ]
    dev = BN254Device(batch_size=C, device="cpu", bank=bank)
    assert dev.n == N
    assert dev.batch_verify(MSG, reqs) == host_verdicts(pks, reqs) == [True, False, True]


def test_scheme_surface(registry):
    """The constructor API a Handel node calls, and its refusals."""
    sks, pks = registry
    scheme = BN254TorchScheme(batch_size=C, device="cpu", warmup=False)
    sk, pk = scheme.keygen(3)
    jsk, jpk = BN254Scheme().keygen(3)
    assert sk.scalar == jsk.scalar and pk.point == jpk.point
    assert pk.marshal() == jpk.marshal()
    assert scheme.unmarshal_public(jpk.marshal()).point == jpk.point
    sig = sk.sign(MSG)
    assert sig.marshal() == jsk.sign(MSG).marshal()
    cons = scheme.constructor
    assert cons.signature_size() == 64
    assert cons.unmarshal_signature(sig.marshal()).point == sig.point
    assert pk.verify(MSG, sig) and not pk.verify(b"other", sig)
    rcons = BN254TorchScheme(batch_size=C, device="cpu", warmup=False, batch_check="rlc").constructor
    assert rcons.batch_check == "rlc"
    rdev = rcons.prepare(pks)
    assert rdev.batch_check == "rlc" and rdev.rlc_stats.rlc_launches == 0
    with pytest.raises(ValueError, match="per_candidate.*rlc"):
        BN254TorchScheme(batch_check="bogus", device="cpu")


@pytest.mark.slow
def test_local_cluster_with_port_scheme():
    """The twin of tests/test_protocol_bn254.py's device test: an 8-node
    LocalCluster reaches threshold with the port's scheme on the CPU."""
    from handel_tpu.core.crypto import verify_multisignature
    from handel_tpu.core.test_harness import LocalCluster

    scheme = BN254TorchScheme(batch_size=8, device="cpu")
    msg = b"hello world"

    async def go():
        cluster = LocalCluster(8, scheme=scheme, msg=msg)
        cluster.start()
        try:
            return cluster, await cluster.wait_complete_success(timeout=1800.0)
        finally:
            cluster.stop()

    cluster, results = asyncio.run(go())
    assert len(results) == 8
    for sig in results.values():
        assert sig.cardinality() >= cluster.threshold
        assert verify_multisignature(msg, sig, cluster.registry, scheme.constructor)


@pytest.mark.slow
def test_verdicts_match_jax_scheme_on_forged_batch(registry):
    """Verdict parity with BN254JaxScheme's device path on a forged batch."""
    from handel_tpu.models.bn254_jax import BN254JaxScheme

    sks, pks = registry
    reqs = [
        candidate(sks, range(0, 8)),
        candidate(sks, range(2, 7), forge=True),
        candidate(sks, [1, 3, 5], msg=b"another message"),
        candidate(sks, range(8, 16)),
    ]
    jax_cons = BN254JaxScheme(batch_size=C, warmup=False).constructor
    ours = BN254TorchScheme(batch_size=C, device="cpu", warmup=False).constructor
    want = jax_cons.batch_verify(MSG, pks, reqs)
    assert ours.batch_verify(MSG, pks, reqs) == want == [True, False, False, True]


def test_launch_smoke_on_the_cpu(capsys):
    """The port's counterpart of scripts/launch_smoke.py on the CPU, cut from
    8 launches to 1 (a whole 4-lane launch takes about 10 s on one CPU core): the
    aggregates against the host oracle, the verdicts as built, and the
    batched combine against host folds."""
    from handel_tpu_torch.scripts import launch_smoke

    assert launch_smoke.main(["--device", "cpu", "--launches", "1"]) == 0
    out = capsys.readouterr().out
    assert "1 launches on cpu, 4 aggregates and verdicts checked" in out
    assert "combine_batch verified on 8 groups" in out


def test_make_async_verifier_runs_the_engine_off_the_event_loop():
    """make_async_verifier (the reference's bn254_jax.py:1641) awaits the
    engine's batch_verify on an executor thread, as the reference's does,
    and hands back its verdicts."""
    import threading

    from handel_tpu.models.bn254_jax import make_async_verifier as jmake
    from handel_tpu_torch.models.bn254_torch import make_async_verifier

    class Engine:
        def __init__(self):
            self.calls = []

        def batch_verify(self, msg, requests):
            self.calls.append((msg, requests, threading.current_thread()))
            return [r % 2 == 0 for r in requests]

    async def run(make):
        engine = Engine()
        got = await make(engine)(MSG, ["pks"], [0, 1, 2])
        return got, engine.calls, threading.current_thread()

    for make in (make_async_verifier, jmake):
        got, calls, loop_thread = asyncio.run(run(make))
        assert got == [True, False, True]
        assert [(m, r) for m, r, _ in calls] == [(MSG, [0, 1, 2])]
        assert calls[0][2] is not loop_thread
