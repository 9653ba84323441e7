"""The port's RLC batch check (handel_tpu_torch/models/rlc.py, ops/curve.py
`Curve.msm` and `scalar_bits64`, service/driver.py `HostDevice` RLC mode)
against the JAX package's.

Host-side parts take the same seeded inputs in both packages and must give
the same scalars, verdicts and counters; the port's MSM is held against the
JAX package's jax-free scalar oracle (handel_tpu/ops/bn254_ref.py), with the
cases of tests/test_msm.py, and, in the slow tier, against the compiled JAX
`Curve.msm` at a tiny shape. Last, the RLC launch's op count
(utils/opcount.py), which grows with the batch width only in the MSMs.
"""

import asyncio
import random

import numpy as np
import pytest
import torch

from handel_tpu import native as nat
from handel_tpu.core.bitset import BitSet as JBitSet
from handel_tpu.models import rlc as jrlc
from handel_tpu.models.bn254 import BN254Scheme as JScheme
from handel_tpu.ops import bn254_ref as jbn
from handel_tpu.ops.curve import BN254Curves as JCurves
from handel_tpu.parallel.batch_verifier import BatchVerifierService as JService
from handel_tpu.parallel.plane import host_plane as jhost_plane
from handel_tpu.service.driver import HostDevice as JHostDevice
from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.models import rlc
from handel_tpu_torch.models.bn254 import BN254Scheme
from handel_tpu_torch.ops.curve import BN254Curves
from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
from handel_tpu_torch.parallel.plane import host_plane
from handel_tpu_torch.service.driver import HostDevice

torch.set_num_threads(1)

N = 16  # registry keys of the host checks
EDGE = [0, 1, (1 << 64) - 1]


# -- scalars, modes, bisection ------------------------------------------------


@pytest.mark.parametrize("seed, n", [(1, 1), (7, 5), (2024, 64)])
def test_draw_scalars_match(seed, n):
    ours = rlc.draw_scalars(n, random.Random(seed))
    assert ours == jrlc.draw_scalars(n, random.Random(seed))
    assert ours[0] == 1 and all(0 < r < 1 << 64 for r in ours)


def test_modes_and_validation_match():
    assert rlc.BATCH_CHECK_MODES == jrlc.BATCH_CHECK_MODES
    assert rlc.SCALAR_BITS == jrlc.SCALAR_BITS == 64
    for mode in rlc.BATCH_CHECK_MODES:
        assert rlc.validate_batch_check(mode) == jrlc.validate_batch_check(mode)
    with pytest.raises(ValueError) as ours:
        rlc.validate_batch_check("bogus")
    with pytest.raises(ValueError) as theirs:
        jrlc.validate_batch_check("bogus")
    assert str(ours.value) == str(theirs.value)


IDXS = [1, 2, 4, 5, 6, 8, 9, 11]  # a launch's valid lanes, not contiguous
FORGERIES = {
    "none": (IDXS, set()),
    "first": (IDXS, {1}),
    "last": (IDXS, {11}),
    "two_adjacent": (IDXS, {5, 6}),
    "all": (IDXS, set(IDXS)),
    "single_honest": ([3], set()),
    "single_forged": ([3], {3}),
}


@pytest.mark.parametrize("pattern", sorted(FORGERIES))
def test_bisect_verify_matches(pattern):
    """The same verdicts, the same combined/oracle call sequence and the
    same counters over stubs: a combined check passes iff its subset holds
    no forgery, the oracle answers for one candidate."""
    idxs, forged = FORGERIES[pattern]

    def side(mod):
        calls = []

        def combined(sub):
            calls.append(("combined", tuple(sub)))
            return not (set(sub) & forged)

        def oracle(i):
            calls.append(("oracle", i))
            return i not in forged

        stats = mod.RlcStats()
        out = mod.bisect_verify(idxs, combined, oracle, stats)
        return out, calls, (stats.rlc_launches, stats.bisection_ct, stats.bisection_depth_max)

    ours = side(rlc)
    assert ours == side(jrlc)
    out, calls, _ = ours
    assert out == {i: i not in forged for i in idxs}
    if len(idxs) > 1:
        assert calls[0] == ("combined", tuple(idxs))
    assert rlc.bisect_verify([], None, None) == {}


# -- the host combined check and HostDevice ------------------------------------


@pytest.fixture(scope="module")
def keys():
    """The same N key pairs from both packages' keygen (equal scalars)."""
    ours = [BN254Scheme().keygen(i) for i in range(N)]
    theirs = [JScheme().keygen(i) for i in range(N)]
    assert [pk.point for _, pk in ours] == [pk.point for _, pk in theirs]
    return ours, theirs


def items_for(pkg_keys, bitset_cls, spec):
    """(msg, pubkeys, bitset, sig) per (msg, signers, forged) in `spec`; a
    forged candidate's signers sign another message."""
    pubs = [pk for _, pk in pkg_keys]
    out = []
    for msg, signers, forged in spec:
        bs = bitset_cls(N)
        sig = None
        for i in signers:
            bs.set(i, True)
            s = pkg_keys[i][0].sign(msg + b" (forged)" if forged else msg)
            sig = s if sig is None else sig.combine(s)
        out.append((msg, pubs, bs, sig))
    return out


BATCHES = {
    "honest_one_message": [(b"m1", [0, 1, 2], False), (b"m1", [3, 4], False),
                           (b"m1", [5, 9, 12], False), (b"m1", [7], False)],
    "one_forged": [(b"m1", [0, 1], False), (b"m1", [2, 3, 4], True),
                   (b"m1", [8, 9], False), (b"m1", [10], False)],
    "mixed_messages": [(b"m1", [0, 1], False), (b"m2", [2, 3], False),
                       (b"m3", [4, 5, 6], False), (b"m2", [11, 14], False),
                       (b"m1", [15], False)],
    "mixed_two_forged": [(b"m1", [0, 1], False), (b"m2", [2, 3], True),
                         (b"m3", [4, 5, 6], False), (b"m2", [11, 14], True),
                         (b"m1", [15], False), (b"m3", [], False)],
}


def stats_tuple(st):
    return (st.rlc_launches, st.bisection_ct, st.bisection_depth_max,
            st.miller_lanes, st.final_exp_lanes)


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_host_rlc_check_matches(keys, batch):
    """One combined check over the batch's valid candidates, from equal
    scalar seeds: the same bool and the same counters."""
    ours_k, theirs_k = keys

    def cands(pkg_keys, bitset_cls, cons):
        return [
            (msg, cons.aggregate_public_keys(pubs, bs).point, sig.point)
            for msg, pubs, bs, sig in items_for(pkg_keys, bitset_cls, BATCHES[batch])
            if sig is not None
        ]

    ours_st, theirs_st = rlc.RlcStats(), jrlc.RlcStats()
    ours = rlc.host_rlc_check(rlc.bn254_host_ops(),
                              cands(ours_k, BitSet, BN254Scheme().constructor),
                              random.Random(5), ours_st)
    theirs = jrlc.host_rlc_check(jrlc.bn254_host_ops(),
                                 cands(theirs_k, JBitSet, JScheme().constructor),
                                 random.Random(5), theirs_st)
    assert ours == theirs == ("forged" not in batch)
    assert stats_tuple(ours_st) == stats_tuple(theirs_st)


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_host_device_rlc_matches(keys, batch):
    """HostDevice in RLC mode, rlc_rng = Random(7) in both packages: the
    same verdicts and RlcStats, and the per-candidate HostDevice's
    verdicts."""
    ours_k, theirs_k = keys
    ours = HostDevice(BN254Scheme().constructor, batch_check="rlc", rlc_rng=random.Random(7))
    theirs = JHostDevice(JScheme().constructor, batch_check="rlc", rlc_rng=random.Random(7))
    got = ours.fetch(ours.dispatch_multi(items_for(ours_k, BitSet, BATCHES[batch])))
    want = theirs.fetch(theirs.dispatch_multi(items_for(theirs_k, JBitSet, BATCHES[batch])))
    assert got == want
    assert stats_tuple(ours.rlc_stats) == stats_tuple(theirs.rlc_stats)
    pc = HostDevice(BN254Scheme().constructor)
    assert got == pc.fetch(pc.dispatch_multi(items_for(ours_k, BitSet, BATCHES[batch])))
    assert got == [not forged and bool(signers) for _, signers, forged in BATCHES[batch]]
    if "forged" not in batch:
        messages = len({m for m, _, _ in BATCHES[batch]})
        assert stats_tuple(ours.rlc_stats) == (1, 0, 0, messages + 1, 1)


def test_host_ops_for_names_the_schemes_with_an_rlc_seam():
    from handel_tpu_torch.models.bn254_torch import BN254TorchConstructor
    from handel_tpu_torch.models.fake import FakeScheme

    assert rlc.host_ops_for(BN254Scheme().constructor) is not None
    assert rlc.host_ops_for(BN254TorchConstructor(device="cpu", warmup=False)) is not None
    assert rlc.host_ops_for(FakeScheme().constructor) is None


def test_rlc_host_plane_through_the_service_matches(keys):
    """host_plane(batch_check="rlc") reaches its engines, and the service's
    values() report the RLC plane as the reference's do: two sessions with
    different messages fuse into one launch, whose forged candidate is
    isolated by bisection."""
    ours_k, theirs_k = keys

    def side(pkg_keys, bitset_cls, scheme, plane_fn, svc_cls):
        plane = plane_fn(scheme.constructor, 1, batch_size=8, batch_check="rlc")
        assert plane.lanes[0].engine.batch_check == "rlc"
        s0 = items_for(pkg_keys, bitset_cls, BATCHES["one_forged"][:2])
        s1 = items_for(pkg_keys, bitset_cls, [(b"m2", [5, 6], False)])

        async def go():
            svc = svc_cls(plane, fallback=None, max_delay_ms=50.0)
            try:
                return await asyncio.gather(
                    svc.verify(b"m1", s0[0][1], [(it[2], it[3]) for it in s0], session="s0"),
                    svc.verify(b"m2", s1[0][1], [(it[2], it[3]) for it in s1], session="s1"),
                ), svc.values()
            finally:
                svc.stop()

        verdicts, values = asyncio.run(go())
        keep = ("checkMode", "rlcLaunches", "bisectionCt", "bisectionDepthMax",
                "verifierLaunches", "verifierCandidates")
        return verdicts, {k: values[k] for k in keep}

    ours = side(ours_k, BitSet, BN254Scheme(), host_plane, BatchVerifierService)
    assert ours == side(theirs_k, JBitSet, JScheme(), jhost_plane, JService)
    assert ours == ([[True, False], [True]], {
        "checkMode": 1.0, "rlcLaunches": 1.0, "bisectionCt": 4.0, "bisectionDepthMax": 2.0,
        "verifierLaunches": 1.0, "verifierCandidates": 3.0})


# -- scalar bits and the MSM ----------------------------------------------------


def test_scalar_bits64_matches_reference():
    rng = random.Random(0x35A1)
    ks = EDGE + [rng.randrange(1 << 64) for _ in range(13)]
    want = np.asarray(JCurves.scalar_bits64(ks))
    got = BN254Curves.scalar_bits64_np(ks)
    assert got.dtype == np.int32 and got.shape == (64, len(ks))
    assert (got == want).all()
    t = BN254Curves(device="cpu").scalar_bits64(ks)
    assert t.dtype == torch.int32 and (t.numpy() == want).all()
    assert BN254Curves.scalar_bits64_np([]).shape == (64, 0)


def host_msm(pts, ks, add, mul):
    acc = None
    for p, k in zip(pts, ks):
        if k == 0 or p is None:
            continue
        t = mul(p, k) if k != 1 else p
        acc = t if acc is None else add(acc, t)
    return acc


@pytest.fixture(scope="module")
def curves():
    return BN254Curves(device="cpu")


@pytest.mark.parametrize("window", [1, 2, 4])
def test_g1_msm_random_and_edge_scalars(curves, window):
    rng = random.Random(100 + window)
    n, b = 4, 2
    pts = [jbn.g1_mul(jbn.G1_GEN, rng.randrange(1, jbn.R)) for _ in range(n * b)]
    ks = [rng.randrange(0, 1 << 64) for _ in range(n * b)]
    ks[0], ks[1], ks[2] = EDGE
    got = curves.unpack_g1(curves.g1.msm(curves.pack_g1(pts), curves.scalar_bits64(ks), n,
                                         window=window))
    for j in range(b):
        want = host_msm([pts[i * b + j] for i in range(n)], [ks[i * b + j] for i in range(n)],
                        jbn.g1_add, jbn.g1_mul)
        assert got[j] == want, (window, j)


def test_g1_msm_masked_hull_lanes(curves):
    """Zeroed scalar columns (the launch-hull mask) and infinity points both
    contribute the identity; an all-masked lane sums to infinity."""
    rng = random.Random(7)
    n, b = 4, 2
    pts = [jbn.g1_mul(jbn.G1_GEN, rng.randrange(1, jbn.R)) for _ in range(n * b)]
    pts[2 * b] = None
    ks = [rng.randrange(1, 1 << 64) for _ in range(n * b)]
    for i in range(n):
        ks[i * b + 1] = 0
    got = curves.unpack_g1(curves.g1.msm(curves.pack_g1(pts), curves.scalar_bits64(ks), n,
                                         window=2))
    assert got[1] is None
    assert got[0] == host_msm([pts[i * b] for i in range(n)], [ks[i * b] for i in range(n)],
                              jbn.g1_add, jbn.g1_mul)


@pytest.mark.parametrize("window", [2, 4])
def test_g2_msm_random_and_edge_scalars(curves, window):
    rng = random.Random(200 + window)
    n = 3
    pts = [jbn.g2_mul(jbn.G2_GEN, rng.randrange(1, jbn.R)) for _ in range(n)]
    ks = [0, (1 << 64) - 1, rng.randrange(1 << 64)]
    got = curves.unpack_g2(curves.g2.msm(curves.pack_g2(pts), curves.scalar_bits64(ks), n,
                                         window=window))
    assert got[0] == host_msm(pts, ks, jbn.g2_add, jbn.g2_mul)


@pytest.mark.slow
def test_g1_msm_matches_the_compiled_jax_msm(curves):
    """The port's MSM against the JAX package's compiled Curve.msm at a tiny
    shape, projective limbs through the affine boundary (minutes of XLA, as
    tests/test_msm.py's device cases)."""
    rng = random.Random(11)
    n, b = 2, 1
    pts = [jbn.g1_mul(jbn.G1_GEN, rng.randrange(1, jbn.R)) for _ in range(n * b)]
    ks = [(1 << 64) - 1, rng.randrange(1 << 64)]
    jc = JCurves()
    want = jc.unpack_g1(jc.g1.msm(jc.pack_g1(pts), jc.scalar_bits64(ks), n, window=2))
    got = curves.unpack_g1(curves.g1.msm(curves.pack_g1(pts), curves.scalar_bits64(ks), n,
                                         window=2))
    assert got == want == [host_msm(pts, ks, jbn.g1_add, jbn.g1_mul)]


def test_native_oracle_is_the_scalar_oracle():
    """The reference's host ops take its native library when it is built;
    the port has none and takes the scalar oracle: the two agree."""
    if not nat.available():
        pytest.skip("the JAX package's native library is not built here")
    rng = random.Random(3)
    pts = [jbn.g2_mul(jbn.G2_GEN, rng.randrange(1, jbn.R)) for _ in range(3)]
    ks = [rng.randrange(1 << 64) for _ in range(3)]
    ops = rlc.bn254_host_ops()
    assert ops.g2_sum(ops.g2_mul_batch(pts, ks)) == nat.g2_sum(nat.g2_mul_batch(pts, ks))


# -- the op count --------------------------------------------------------------


def test_rlc_opcount_depends_on_the_width_only_in_the_msm_tree():
    """utils/opcount.py's RLC range count: positive, with the pairing tail
    and everything outside the MSMs independent of the batch width, as the
    per-candidate count is; the MSMs' masked sums over C candidate blocks
    add ceil(log2 C) tree stages a window, so their count grows with C."""
    from handel_tpu_torch.utils.opcount import count_rlc_launch

    two, four = count_rlc_launch("cios", 16, 2), count_rlc_launch("cios", 16, 4)
    outside = lambda c: c["kernel_launching_ops"] - c["scopes"]["msm"]  # noqa: E731
    assert two["kernel_launching_ops"] > 0 and outside(two) == outside(four) > 0
    assert two["scopes"]["rlc_pairing_tail"] == four["scopes"]["rlc_pairing_tail"] > 0
    assert four["scopes"]["msm"] > two["scopes"]["msm"] > 0


def test_rlc_smoke_on_the_cpu(capsys):
    """The port's counterpart of scripts/rlc_smoke.py on the CPU, its host
    launches cut from 64 candidates to 8 (the scalar oracle's pairings take
    about 2 s a candidate on one CPU core): verdict parity, the M+1 / 1 counters,
    exact culprits, the BLS12-381 seam and the engine's routing."""
    from handel_tpu_torch.scripts import rlc_smoke

    assert rlc_smoke.main(["--device", "cpu", "--candidates", "8"]) == 0
    out = capsys.readouterr().out
    assert "valid batch of 8: verdict parity, 2 Miller loops + 1 final exp" in out
    assert "rlc-mode device routes range + dense packing classes" in out
