"""Tests of the port that need an NVIDIA GPU: the CUDA kernels have no CPU mode.

Marked `cuda`; each skips, saying why, where torch sees no card. On a
machine with a card and nvcc (JAX need not be installed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports nothing of the JAX package, so it also runs there.
"""

import random

import numpy as np
import pytest
import torch

from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops.fp import Field

BLS12_381_P = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaaab",
    16,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


# widths around the kernels' tiles and warps, and the Fp12 width at 128 lanes
RAGGED = [1, 7, 31, 33, 63, 65, 127, 129, 255, 257, 4099, 13824]


@pytest.mark.parametrize("p", [bn.P, BLS12_381_P], ids=["bn254", "bls12_381"])
@pytest.mark.parametrize("cols", RAGGED)
def test_kernel_matches_plain_at_ragged_widths(card, p, cols):
    from handel_tpu_torch.kernels.fp_mont import TPI_CHOICES, mont_mul

    F = Field(p, device=card)
    rng = random.Random(cols)
    xs = [rng.randrange(p) for _ in range(cols)]
    ys = [rng.randrange(p) for _ in range(cols)]
    a, b = F.pack(xs), F.pack(ys)
    want = F._mul_plain(a, b)
    assert F.unpack(want) == [x * y % p for x, y in zip(xs, ys)]
    # row slices of a wider operand take the kernel's row stride; an odd
    # column offset leaves the rows unaligned
    wide = torch.cat([a] * 4, dim=1)
    try:
        for tpi in (None, *TPI_CHOICES):
            mont_mul.tpi = tpi
            before = mont_mul.launches
            got = F.mul(a, b)
            assert mont_mul.launches == before + 1
            assert torch.equal(got, want), tpi
            assert torch.equal(F.mul(wide[:, cols:2 * cols], b), want), tpi
            assert torch.equal(F.mul(wide[:, 3:3 + cols], b), F._mul_plain(wide[:, 3:3 + cols], b))
    finally:
        mont_mul.tpi = None


def test_wrapper_contract(card):
    from handel_tpu_torch.kernels.fp_mont import mont_mul

    F = Field(bn.P, device=card)
    a = F.pack([3, 4, 5])
    empty = mont_mul(F, a[:, :0], a[:, :0])
    assert empty.shape == (F.nlimbs, 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mont_mul(F, a.cpu(), a)
    with pytest.raises(ValueError, match="dtype"):
        mont_mul(F, a.long(), a.long())
    with pytest.raises(ValueError, match="shape"):
        mont_mul(F, a[:8], a[:8])
    with pytest.raises(ValueError, match="column stride"):
        mont_mul(F, a.t().contiguous().t(), a)
    with pytest.raises(ValueError, match="shapes differ"):
        mont_mul(F, a, a[:, :2])
    # Field.mul makes a broadcast operand contiguous before the launch
    assert F.unpack(F.mul(a, F.constant(2, 3))) == [6, 8, 10]


def _residues(F, cols, seed):
    """(k_all, cols) int32 residues, each row below its modulus, with 0
    and m_i - 1 in the first two columns (as far as they reach)."""
    gen = torch.Generator().manual_seed(seed)
    m = torch.from_numpy(F._m_all).long()[:, None]
    r = torch.randint(0, 1 << 30, (F.k_all, cols), generator=gen) % m
    r[:, :1] = 0
    r[:, 1:2] = m - 1
    return r.to(torch.int32)


@pytest.mark.parametrize("p", [bn.P, BLS12_381_P], ids=["bn254", "bls12_381"])
@pytest.mark.parametrize("cols", RAGGED)
def test_rns_kernel_matches_plain_at_ragged_widths(card, p, cols):
    from handel_tpu_torch.kernels.rns_mont import TILES, rns_mul_resident

    F = Field(p, backend="rns", device=card)
    a, b = _residues(F, cols, cols).to(card), _residues(F, cols, cols + 1).to(card)
    want = F._mul_resident_core(a, b)
    # row slices of a wider operand take the kernel's row stride: at a
    # column offset of 3 the rows are not 16-byte aligned (4-byte copies)
    wide = torch.cat([a] * 4, dim=1)
    default = rns_mul_resident.tile
    try:
        for tile in TILES:
            rns_mul_resident.tile = tile
            before = rns_mul_resident.launches
            got = F.mul_resident(a, b)
            assert rns_mul_resident.launches == before + 1
            assert torch.equal(got, want), tile
            assert torch.equal(F.mul_resident(wide[:, cols:2 * cols], b), want), tile
            assert torch.equal(F.mul_resident(wide[:, 3:3 + cols], b),
                               F._mul_resident_core(wide[:, 3:3 + cols], b)), tile
    finally:
        rns_mul_resident.tile = default
    # the integer identity through the resident conversions
    rng = random.Random(cols)
    xs = [rng.randrange(p) for _ in range(cols)]
    ys = [rng.randrange(p) for _ in range(cols)]
    r = F.mul_resident(F.to_resident(F.pack(xs, mont=False)), F.to_resident(F.pack(ys, mont=False)))
    minv = pow(F.M, -1, p)
    assert F.unpack(F.from_resident(r), mont=False) == [x * y * minv % p for x, y in zip(xs, ys)]


def test_rns_wrapper_contract(card):
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident

    F = Field(bn.P, backend="rns", device=card)
    a = F.to_resident(F.pack([3, 4, 5]))
    empty = rns_mul_resident(F, a[:, :0], a[:, :0])
    assert empty.shape == (F.k_all, 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rns_mul_resident(F, a.cpu(), a)
    with pytest.raises(ValueError, match="dtype"):
        rns_mul_resident(F, a.long(), a.long())
    with pytest.raises(ValueError, match="shape"):
        rns_mul_resident(F, a[:20], a[:20])
    with pytest.raises(ValueError, match="column stride"):
        rns_mul_resident(F, a.t().contiguous().t(), a)
    with pytest.raises(ValueError, match="shapes differ"):
        rns_mul_resident(F, a, a[:, :2])
    with pytest.raises(ValueError, match="field on"):
        rns_mul_resident(Field(bn.P, backend="rns", device="cpu"), a, a)
    # mul_resident makes a broadcast operand dense before the launch, and
    # the per-mul path never reaches kernel B1
    A = F.resident()
    before = mont_mul.launches
    assert A.unpack(A.mul(a, A.constant(2, 3))) == [6, 8, 10]
    assert F.unpack(F.mul(F.pack([3, 4]), F.pack([5, 6]))) == [15, 24]
    assert mont_mul.launches == before


def test_verify_on_card(card):
    """A range and a dense launch on the card with a small registry."""
    from handel_tpu_torch.core.bitset import BitSet
    from handel_tpu_torch.models.bn254 import BN254PublicKey, BN254Signature, hash_to_g1
    from handel_tpu_torch.models.bn254_torch import BN254Device

    rng = random.Random(7)
    n = 80
    sks = [rng.randrange(1, 1 << 30) for _ in range(n)]
    pks = [BN254PublicKey(bn.g2_mul(bn.G2_GEN, s)) for s in sks]
    dev = BN254Device(pks, batch_size=4, device=card)
    h = hash_to_g1(b"m")

    def cand(idx, forge=False):
        bs = BitSet(n)
        for i in idx:
            bs.set(i, True)
        k = (sum(sks[i] for i in idx) + forge) % bn.R
        return bs, BN254Signature(bn.g1_mul(h, k))

    rng_reqs = [cand(range(3, 40)), cand(range(5, 9), forge=True), cand([7, 9, 11])]
    assert dev._pack_requests(rng_reqs).kind == "range"
    assert dev.batch_verify(b"m", rng_reqs) == [True, False, True]
    dense = [cand([0, 79]), cand(range(0, 80, 3)), cand([1, 78], forge=True)]
    assert dev._pack_requests(dense).kind == "dense"
    assert dev.batch_verify(b"m", dense) == [True, True, False]


@pytest.mark.parametrize("backend", ["cios", "rns"])
def test_combine_batch_on_card_equals_cpu(card, backend):
    """BN254Device.combine_batch on the card equals the same call on the CPU
    and the host fold, in the warmed classes 2, 4 and 8 and across chunks;
    it launches B1 on either backend (the combine runs on the cios field)."""
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.models.bn254 import BN254PublicKey
    from handel_tpu_torch.models.bn254_torch import BN254Device

    rng = random.Random(17)
    pks = [BN254PublicKey(bn.g2_mul(bn.G2_GEN, rng.randrange(1, 1 << 30))) for _ in range(4)]
    pts = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(12)]
    groups = [[rng.choice(pts + [None]) for _ in range(rng.randrange(1, 9))]
              for _ in range(9)]
    p = rng.choice(pts)
    groups[2] = [p, bn.g1_neg(p)]  # sums to infinity
    want = []
    for g in groups:
        acc = None
        for q in g:
            if q is not None:
                acc = q if acc is None else bn.g1_add(acc, q)
        want.append(acc)
    on_cpu = BN254Device(pks, batch_size=4, device="cpu", fp_backend=backend)
    on_card = BN254Device(pks, batch_size=4, device=card, fp_backend=backend)
    before = mont_mul.launches
    got = on_card.combine_batch(groups)
    assert mont_mul.launches > before
    assert got == on_cpu.combine_batch(groups) == want
    on_card.warmup()
    for k in (2, 3, 4, 7, 8):
        assert on_card.combine_batch([pts[:k]], compiled_only=True) == on_cpu.combine_batch(
            [pts[:k]])


def test_rns_verify_on_card(card):
    """The rns backend's range and dense launches on the card: B2 launched,
    B1 not."""
    from handel_tpu_torch.core.bitset import BitSet
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident
    from handel_tpu_torch.models.bn254 import BN254PublicKey, BN254Signature, hash_to_g1
    from handel_tpu_torch.models.bn254_torch import BN254Device

    rng = random.Random(8)
    n = 80
    sks = [rng.randrange(1, 1 << 30) for _ in range(n)]
    pks = [BN254PublicKey(bn.g2_mul(bn.G2_GEN, s)) for s in sks]
    dev = BN254Device(pks, batch_size=4, device=card, fp_backend="rns")
    assert dev.pairing.resident
    h = hash_to_g1(b"m")

    def cand(idx, forge=False):
        bs = BitSet(n)
        for i in idx:
            bs.set(i, True)
        k = (sum(sks[i] for i in idx) + forge) % bn.R
        return bs, BN254Signature(bn.g1_mul(h, k))

    b1, b2 = mont_mul.launches, rns_mul_resident.launches
    assert dev.batch_verify(b"m", [cand(range(3, 40)), cand(range(5, 9), forge=True)]) == [True, False]
    assert dev.batch_verify(b"m", [cand([0, 79]), cand([1, 78], forge=True)]) == [True, False]
    assert rns_mul_resident.launches > b2 and mont_mul.launches == b1


@pytest.mark.parametrize("backend", ["cios", "rns"])
def test_rlc_launch_on_card_equals_cpu(card, backend):
    """An RLC launch on the card (two messages, one forged candidate, range
    class) gives the CPU engine's verdicts and counters, with the same
    scalars the same (S, X) from its MSM stage; the bisection's relaunches
    run on the engine's verify stream under its dispatch lock. B1 launches
    on cios, B2 on rns."""
    from handel_tpu_torch.core.bitset import BitSet
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident
    from handel_tpu_torch.models.bn254 import BN254PublicKey, BN254Signature, hash_to_g1
    from handel_tpu_torch.models.bn254_torch import BN254Device

    rng = random.Random(9)
    n = 40
    sks = [rng.randrange(1, 1 << 30) for _ in range(n)]
    pks = [BN254PublicKey(bn.g2_mul(bn.G2_GEN, s)) for s in sks]

    def cand(msg, idx, forge=False):
        bs = BitSet(n)
        for i in idx:
            bs.set(i, True)
        k = (sum(sks[i] for i in idx) + forge) % bn.R
        return (msg, None, bs, BN254Signature(bn.g1_mul(hash_to_g1(msg), k)))

    items = [cand(b"m1", range(3, 20)), cand(b"m2", range(5, 9), forge=True),
             cand(b"m2", [7, 9, 11]), cand(b"m1", range(30, 40))]
    engines = {d: BN254Device(pks, batch_size=4, device=d, fp_backend=backend,
                              batch_check="rlc", rlc_rng=random.Random(5))
               for d in ("cpu", card)}
    outs, streams = {d: [] for d in engines}, []
    for d, eng in engines.items():
        def tap(*a, _t=eng._rlc_msm_tail, _d=d):
            outs[_d].append(_t(*a))
            return outs[_d][-1]

        eng._rlc_msm_tail = tap
        if d != "cpu":
            one = eng._dispatch_one

            def watched(*a, _one=one, _eng=eng):
                streams.append((torch.cuda.current_stream(card) == _eng._verify_stream,
                                _eng._dispatch_lock.locked()))
                return _one(*a)

            eng._dispatch_one = watched
    b1, b2 = mont_mul.launches, rns_mul_resident.launches
    got = {d: eng.fetch(eng.dispatch_multi(items)) for d, eng in engines.items()}
    assert got["cpu"] == got[card] == [True, False, True, True]
    stats = {d: eng.rlc_stats for d, eng in engines.items()}
    assert stats["cpu"] == stats[card] and stats[card].bisection_ct > 0
    assert streams and all(on_stream and locked for on_stream, locked in streams)
    flat = lambda o: [t.cpu() for t in torch.utils._pytree.tree_leaves(o)]  # noqa: E731
    assert len(outs["cpu"]) == len(outs[card]) == 3  # the top check and two halves
    assert all(torch.equal(a, b) for a, b in zip(flat(outs["cpu"]), flat(outs[card])))
    if backend == "cios":
        assert mont_mul.launches > b1 and rns_mul_resident.launches == b2
    else:
        assert rns_mul_resident.launches > b2 and mont_mul.launches == b1


def test_per_candidate_dispatch_multi_on_card(card):
    """A mixed-message per-candidate launch on the card: per-lane H(m)
    columns, the verdicts of one launch per message."""
    from handel_tpu_torch.core.bitset import BitSet
    from handel_tpu_torch.models.bn254 import BN254PublicKey, BN254Signature, hash_to_g1
    from handel_tpu_torch.models.bn254_torch import BN254Device

    rng = random.Random(10)
    n = 24
    sks = [rng.randrange(1, 1 << 30) for _ in range(n)]
    pks = [BN254PublicKey(bn.g2_mul(bn.G2_GEN, s)) for s in sks]
    dev = BN254Device(pks, batch_size=4, device=card)

    def cand(msg, idx, forge=False):
        bs = BitSet(n)
        for i in idx:
            bs.set(i, True)
        k = (sum(sks[i] for i in idx) + forge) % bn.R
        return (msg, None, bs, BN254Signature(bn.g1_mul(hash_to_g1(msg), k)))

    items = [cand(b"m1", range(0, 5)), cand(b"m2", range(4, 9), forge=True),
             cand(b"m2", range(2, 6)), cand(b"m3", [1, 3])]
    assert dev.fetch(dev.dispatch_multi(items)) == [True, False, True, True]
    assert dev.multi_msg_launches == 1


LAB_FORMS = ("cios_fullwidth", "separated")


@pytest.mark.parametrize("form", LAB_FORMS)
@pytest.mark.parametrize("p", [bn.P, BLS12_381_P], ids=["bn254", "bls12_381"])
@pytest.mark.parametrize("cols", [1, 7, 31, 33, 255, 257, 4099, (1 << 18) + 3])
def test_lab_kernels_match_plain_and_b1_at_ragged_widths(card, p, cols, form):
    """Every instance (warps per block) at widths ragged around a warp's 32
    columns and a block's 64 to 256, exactly: against the plain body and B1
    on canonical columns, the plain body on raw digits, and on row slices
    of a wider operand."""
    from handel_tpu_torch.kernels import lab_mont
    from handel_tpu_torch.scripts.fp_kernel_lab import LabField

    F = Field(p, device=card)
    lab = LabField(F)
    counter = getattr(lab_mont, f"lab_{form}")
    gen = np.random.default_rng(cols + len(form))
    xs = [int.from_bytes(gen.bytes(48), "little") % p for _ in range(cols)]
    ys = [int.from_bytes(gen.bytes(48), "little") % p for _ in range(cols)]
    a, b = F.pack(xs, mont=False), F.pack(ys, mont=False)
    tgen = torch.Generator().manual_seed(cols)
    ra = torch.randint(0, 1 << 16, (F.nlimbs, cols), generator=tgen, dtype=torch.int32).to(card)
    rb = torch.randint(0, 1 << 16, (F.nlimbs, cols), generator=tgen, dtype=torch.int32).to(card)
    wide = torch.cat([a, a], dim=1)
    b1 = F.mul(a, b)  # kernel B1
    for warps in lab_mont.WARPS:
        before = counter.launches
        got = lab.kernel(form, warps)(a, b)
        assert counter.launches == before + 1
        assert torch.equal(got, lab.body(form)(a, b))
        assert torch.equal(got, b1)
        # raw 16-bit digits: the plain body's bits
        assert torch.equal(lab.kernel(form, warps)(ra, rb), lab.body(form)(ra, rb))
        # row slices of a wider operand take the kernel's row stride
        assert torch.equal(lab.kernel(form, warps)(wide[:, cols:], b), got)
    rinv = pow(F.mont_r, -1, p)
    check = range(cols) if cols < 5000 else range(0, cols, 997)
    out = F.unpack(got, mont=False)
    assert [out[i] for i in check] == [xs[i] * ys[i] * rinv % p for i in check]


def test_lab_wrapper_contract(card):
    from handel_tpu_torch.kernels.lab_mont import lab_cios_fullwidth, lab_separated
    from handel_tpu_torch.scripts.fp_kernel_lab import LabField

    lab = LabField(Field(bn.P, device=card))
    a = lab.F.pack([3, 4, 5])
    for k in (lab_cios_fullwidth, lab_separated):
        assert k(lab, a[:, :0], a[:, :0]).shape == (lab.n, 0)
        with pytest.raises(ValueError, match="CUDA tensor"):
            k(lab, a.cpu(), a)
        with pytest.raises(ValueError, match="dtype"):
            k(lab, a.long(), a.long())
        with pytest.raises(ValueError, match="shape"):
            k(lab, a[:8], a[:8])
        with pytest.raises(ValueError, match="column stride"):
            k(lab, a.t().contiguous().t(), a)
        with pytest.raises(ValueError, match="shapes differ"):
            k(lab, a, a[:, :2])
        with pytest.raises(ValueError, match="warps"):
            k(lab, a, a, warps=16)
        before = k.launches
        assert lab.F.unpack(k(lab, a, lab.F.pack([2, 2, 2]))) == [6, 8, 10]
        assert k.launches == before + 1


@pytest.mark.parametrize("kernel", ["fp_mont_mul", "rns_mont_mul_resident",
                                    "lab_cios_fullwidth", "lab_separated"])
def test_graph_replay_equals_eager_chain(card, kernel):
    """A chain captured in one CUDA graph and replayed over a sentinel gives
    the eager chain's bits; the launch counter moves at capture only."""
    from handel_tpu_torch.kernels import lab_mont
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident
    from handel_tpu_torch.ops.fp import ChainGraph, ChainTally, chain
    from handel_tpu_torch.scripts.fp_kernel_lab import LabField

    F = Field(bn.P, device=card)
    rng = random.Random(5)
    xs = [rng.randrange(bn.P) for _ in range(1000)]
    a, b = F.pack(xs), F.pack(xs[::-1])
    if kernel == "fp_mont_mul":
        fn, counter = F.mul, mont_mul
    elif kernel == "rns_mont_mul_resident":
        R = Field(bn.P, backend="rns", device=card)
        a, b = R.to_resident(a), R.to_resident(b)
        fn, counter = R.mul_resident, rns_mul_resident
    else:
        form = kernel.removeprefix("lab_")
        fn, counter = LabField(F).kernel(form), getattr(lab_mont, kernel)
    tally = ChainTally()
    before = counter.launches
    g = ChainGraph(fn, a, b, 6, tally)
    assert counter.launches == before + 3 + 6  # 3 warm calls, 6 captured
    g.out.fill_(-1)
    before = counter.launches
    got = g.replay().clone()
    g.replay()
    assert counter.launches == before
    assert tally.graphs == 1 and tally.captured_calls == 6
    assert (tally.replays, tally.replayed_calls) == (2, 12)
    assert torch.equal(got, chain(fn, a, b, 6))


def _service_keys():
    """16 registry keys from seeded scalars, and the scalars."""
    from handel_tpu_torch.models.bn254 import BN254PublicKey

    rng = random.Random(41)
    sks = [rng.randrange(1, 1 << 20) for _ in range(16)]
    return sks, [BN254PublicKey(bn.g2_mul(bn.G2_GEN, s)) for s in sks]


def _service_engine(card):
    """A prepared 16-key, 4-lane cios engine on the card, and its keys."""
    from handel_tpu_torch.models.bn254_torch import BN254TorchConstructor

    sks, pks = _service_keys()
    cons = BN254TorchConstructor(batch_size=4, device=card)
    return cons.prepare(pks), sks, pks


def _service_candidates(sks):
    """Two launches' worth: forged signatures, a wrong message, an empty
    bitset among valid ranges; and the verdicts each must get."""
    from handel_tpu_torch.core.bitset import BitSet
    from handel_tpu_torch.models.bn254 import BN254Signature, hash_to_g1

    def cand(idx, forge=False, msg=b"service engine"):
        bs = BitSet(16)
        for i in idx:
            bs.set(i, True)
        k = (sum(sks[i] for i in idx) + forge) % bn.R
        return bs, BN254Signature(bn.g1_mul(hash_to_g1(msg), k) if k else None)

    reqs = [cand(range(2, 10)), cand(range(0, 6), forge=True), cand([3, 4, 6, 8, 9]),
            cand(range(5, 9), msg=b"another message"), cand([]), cand(range(9, 16)),
            cand([0, 1], forge=True), cand([15])]
    return reqs, [True, False, True, False, False, True, False, True]


def _combine_groups(seed):
    rng = random.Random(seed)
    pts = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(6)]
    groups = [[rng.choice(pts + [None]) for _ in range(rng.randrange(1, 5))] for _ in range(5)]
    want = []
    for g in groups:
        acc = None
        for q in g:
            if q is not None:
                acc = q if acc is None else bn.g1_add(acc, q)
        want.append(acc)
    return groups, want


def test_service_over_engine_on_card_with_concurrent_combines(card):
    """The concurrency case of tests/test_torch_service_engine.py on the
    card: verify and combine on streams of their own, two launches through
    a BatchVerifierService(max_inflight=2) while the event-loop thread
    combines; verdicts equal sequential batch_verify and the host oracle,
    sums equal the host fold, B1 launched."""
    import asyncio

    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.models.bn254 import BN254Scheme
    from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService

    eng, sks, pks = _service_engine(card)
    streams = {eng._verify_stream, eng._combine_stream, torch.cuda.current_stream(card)}
    assert None not in streams and len(streams) == 3
    reqs, want = _service_candidates(sks)
    groups, want_sums = _combine_groups(5)

    async def go():
        svc = BatchVerifierService(eng, max_delay_ms=1.0, max_inflight=2, fallback=None)
        try:
            verify = asyncio.gather(*(svc.verify(b"service engine", pks, reqs[i:i + 2],
                                                 session=f"s{i // 2}")
                                      for i in range(0, len(reqs), 2)))
            await asyncio.sleep(0.05)
            sums, overlapped = [], []
            for _ in range(3):
                sums.append(eng.combine_batch(groups))
                overlapped.append(not verify.done())
                await asyncio.sleep(0)
            return [v for part in await verify for v in part], sums, overlapped, svc.values()
        finally:
            svc.stop()

    before = mont_mul.launches
    got, sums, overlapped, values = asyncio.run(go())
    assert mont_mul.launches > before
    assert overlapped[0], "the combine did not run while a launch was in flight"
    assert got == want
    assert eng.batch_verify(b"service engine", reqs) == want
    assert BN254Scheme().constructor.batch_verify(b"service engine", pks, reqs) == want
    assert all(s == want_sums for s in sums)
    assert values["verifierLaunches"] == 2.0
    assert values["failoverBatches"] == values["deviceRetryCt"] == 0.0


def test_combine_is_not_held_behind_an_inflight_verify_launch(card):
    """A verify launch is dispatched from a worker thread behind about 3 s
    of device work at the head of the verify stream; a combine_batch that
    starts meanwhile on this thread returns in well under that time (it
    waits for the combine stream only), and before the launch's fetch."""
    import threading
    import time

    eng, sks, _ = _service_engine(card)
    reqs, want = _service_candidates(sks)
    groups, want_sums = _combine_groups(6)
    with torch.cuda.stream(eng._verify_stream):
        torch.cuda._sleep(int(3 * 1.98e9))  # >= 3 s at the H100's highest clock
    out = {}

    def verify():
        handle = eng.dispatch(b"service engine", reqs[:4])
        out["verdicts"] = eng.fetch(handle)
        out["fetched"] = time.perf_counter()

    worker = threading.Thread(target=verify)
    worker.start()
    t0 = time.perf_counter()
    sums = eng.combine_batch(groups)
    combined = time.perf_counter()
    worker.join()
    assert sums == want_sums
    assert combined - t0 < 1.5, f"the combine waited {combined - t0:.2f} s"
    assert combined < out["fetched"]
    assert out["verdicts"] == want[:4]


def test_bn254_plane_on_the_card(card):
    """bn254_plane puts one warmed engine on each card (here cuda:0); a
    service over the plane verifies through it."""
    import asyncio

    from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
    from handel_tpu_torch.parallel.plane import bn254_plane

    sks, pks = _service_keys()
    reqs, want = _service_candidates(sks)
    plane = bn254_plane(pks, 1, batch_size=4)
    (lane,) = plane.lanes
    assert lane.engine.device == card and lane.engine._combine_ready == {2, 4, 8}

    async def go():
        svc = BatchVerifierService(plane, fallback=None)
        try:
            return await svc.verify(b"service engine", pks, reqs[:4])
        finally:
            svc.stop()

    assert asyncio.run(go()) == want[:4]


def test_sim_entry_point_runs_bn254_cuda_on_the_card(card, tmp_path):
    """python -m handel_tpu_torch.sim on a 16-node bn254-cuda config (two
    node processes, UDP, one shared verifier each, 16 lanes): every node
    finishes OK with a final that verifies, the shared verifiers launched,
    and kernel B1 ran in each node process."""
    import csv
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from handel_tpu_torch.sim.config import RunConfig, SimConfig, dump_config

    root = Path(__file__).resolve().parents[1]
    cfg = SimConfig(network="udp", scheme="bn254-cuda", shared_verifier=True,
                    batch_size=16, max_timeout_s=300.0,
                    runs=[RunConfig(nodes=16, threshold=12, processes=2)])
    (tmp_path / "sim.toml").write_text(dump_config(cfg))
    env = dict(os.environ, HANDEL_TORCH_DEVICE="cuda",
               PYTHONPATH=os.pathsep.join([str(root), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "handel_tpu_torch.sim", "--config", str(tmp_path / "sim.toml"),
         "--workdir", str(tmp_path)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    with open(tmp_path / "results_0.csv") as f:
        header, row = list(csv.reader(f))[:2]
    col = dict(zip(header, map(float, row)))
    assert col["device_verifier_verifierLaunches_sum"] >= 2
    assert col["device_verifier_verifierCandidates_sum"] > 0
    assert col["device_verifier_failoverBatches_sum"] == 0
    for p in range(2):
        text = (tmp_path / f"node_0_{p}.out").read_text()
        assert "node process finished OK" in text
        (kern,) = [json.loads(ln.split(": ", 1)[1]) for ln in text.splitlines()
                   if ln.startswith("node process kernels: ")]
        assert kern["device"].startswith("cuda")
        assert kern["launches_in_round"]["fp_mont_mul"] > 0
        assert kern["verifier_launches"] >= 1


# -- BLS12-381 (chip_smoke.py phase 11) -----------------------------------------

# the widths the phase-11 launches at 64 lanes give the kernels: the Fermat
# inverse's 64 columns, the Miller loop's stacked Fp2 products, an Fp12
# multiply over the 128 pairing lanes and, for B1, the widest stacked G2 add
# of the 1024-key dense class (18 base products over 1024 x 64 / 2 points)
BLS_B1_WIDTHS = [64, 1152, 6912, 9 * 1024 * 64]
BLS_B2_WIDTHS = [64, 768, 1152, 6912]


@pytest.mark.parametrize("cols", BLS_B1_WIDTHS)
def test_b1_at_24_limbs_matches_plain_at_the_bls12_381_widths(card, cols):
    from handel_tpu_torch.kernels.fp_mont import mont_mul

    F = Field(BLS12_381_P, device=card)
    rng = random.Random(cols)
    xs = [rng.randrange(BLS12_381_P) for _ in range(cols)]
    ys = [rng.randrange(BLS12_381_P) for _ in range(cols)]
    a, b = F.pack(xs), F.pack(ys)
    before = mont_mul.launches
    got = F.mul(a, b)
    assert mont_mul.launches == before + 1
    assert torch.equal(got, F._mul_plain(a, b))


@pytest.mark.parametrize("cols", BLS_B2_WIDTHS)
def test_b2_at_k_all_65_matches_plain_at_the_bls12_381_widths(card, cols):
    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident

    F = Field(BLS12_381_P, backend="rns", device=card)
    assert F.k_all == 65
    a, b = _residues(F, cols, cols).to(card), _residues(F, cols, cols + 7).to(card)
    before = rns_mul_resident.launches
    got = F.mul_resident(a, b)
    assert rns_mul_resident.launches == before + 1
    assert torch.equal(got, F._mul_resident_core(a, b))


@pytest.mark.parametrize("backend", ["cios", "rns"])
def test_bls12_381_launch_on_card(card, backend):
    """4-lane BLS12-381 range and dense launches on the card give the host
    oracle's verdicts; B1 launches on cios, B2 on rns and B1 not there."""
    from handel_tpu_torch.core.bitset import BitSet
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident
    from handel_tpu_torch.models.bls12_381 import (
        BLS12381Constructor,
        BLS12381PublicKey,
        BLS12381Signature,
        hash_to_g1,
    )
    from handel_tpu_torch.models.bls12_381_torch import BLS12381Device
    from handel_tpu_torch.ops import bls12_381_ref as bls

    rng = random.Random(9)
    n = 80
    sks = [rng.randrange(1, 1 << 30) for _ in range(n)]
    pks = [BLS12381PublicKey(bls.g2_mul(bls.G2_GEN, s)) for s in sks]
    dev = BLS12381Device(pks, batch_size=4, device=card, fp_backend=backend)
    assert dev.pairing.resident == (backend == "rns")
    h = hash_to_g1(b"m")

    def cand(idx, forge=False):
        bs = BitSet(n)
        for i in idx:
            bs.set(i, True)
        k = (sum(sks[i] for i in idx) + forge) % bls.R
        return bs, BLS12381Signature(bls.g1_mul(h, k))

    ranges = [cand(range(3, 40)), cand(range(5, 9), forge=True), cand([7, 9, 11])]
    dense = [cand([0, 79]), cand(range(0, 80, 3)), cand([1, 78], forge=True)]
    assert dev._pack_requests(ranges).kind == "range"
    assert dev._pack_requests(dense).kind == "dense"
    b1, b2 = mont_mul.launches, rns_mul_resident.launches
    host = BLS12381Constructor()
    assert dev.batch_verify(b"m", ranges) == host.batch_verify(b"m", pks, ranges) == [
        True, False, True]
    assert dev.batch_verify(b"m", dense) == host.batch_verify(b"m", pks, dense) == [
        True, True, False]
    if backend == "cios":
        assert mont_mul.launches > b1 and rns_mul_resident.launches == b2
    else:
        assert rns_mul_resident.launches > b2 and mont_mul.launches == b1


def test_device_telemetry_reads_the_card(card, tmp_path):
    """The metrics plane's device collector on the card: memory gauges from
    torch.cuda.memory_stats above 0 while a tensor lives, and a profile
    capture taken on another thread while this one launches B1 names B1's
    kernel (the capture is process-wide, as the /debug/profile handler
    runs on the metrics server's thread)."""
    import json
    import os
    import threading

    from handel_tpu_torch.parallel.telemetry import DeviceTelemetry

    F = Field(bn.P, device=card)
    a = F.pack(list(range(1, 4097)))
    tel = DeviceTelemetry(device=card, trace_dir=str(tmp_path))
    vals = tel.values()
    assert vals["memBytesInUse"] > 0 and vals["memBytesReserved"] > 0
    assert vals["memBytesPeak"] >= vals["memBytesInUse"]
    assert {"memBytesInUse", "kernelLibsLoaded"} <= tel.gauge_keys()
    stop = threading.Event()

    def launch():
        while not stop.is_set():
            F.mul(a, a)
            torch.cuda.synchronize(card)

    worker = threading.Thread(target=launch)
    worker.start()
    try:
        out = tel.profile(1.0)
    finally:
        stop.set()
        worker.join()
    with open(os.path.join(out, "kernels.json")) as f:
        kernels = json.load(f)
    assert any("mont_mul_kernel" in k for k in kernels), sorted(kernels)[:10]
    assert tel.values()["profileCaptures"] == 1.0


# -- the launch's span on the card, the fleet and watch (phases 12, 13) -----------


def test_launch_on_device_span_is_the_launch_on_its_stream(card):
    """A traced service over the card engine: each launch's
    `launch_on_device` span runs from its first op on the verify stream to
    its last (the engine's CUDA events mapped onto the trace clock), so it
    starts while the host-bound dispatch still issues (inside
    `launch_staged`) and ends by the verdicts (`launch_fetched`); the lane
    is busy most of its window. On the CPU the engine gives no span."""
    import asyncio

    from handel_tpu_torch.core.trace import FlightRecorder
    from handel_tpu_torch.models.bn254_torch import BN254TorchConstructor
    from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
    from handel_tpu_torch.sim import trace_cli

    eng, sks, pks = _service_engine(card)
    reqs, want = _service_candidates(sks)
    rec = FlightRecorder(capacity=1 << 12)

    async def go():
        svc = BatchVerifierService(eng, max_delay_ms=1.0, fallback=None, recorder=rec)
        try:
            got = []
            for i in range(0, len(reqs), 4):  # one launch at a time
                got += await svc.verify(b"service engine", pks, reqs[i:i + 4])
            return got
        finally:
            svc.stop()

    assert asyncio.run(go()) == want
    events = rec.export()["traceEvents"]
    spans = {name: sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                          if e.get("ph") == "X" and e["name"] == name)
             for name in ("launch_staged", "launch_on_device", "launch_fetched")}
    assert len(spans["launch_on_device"]) == len(spans["launch_staged"]) == 2
    for (s0, s1), (d0, d1), (_, f1) in zip(*spans.values()):
        slack = 1e3  # µs: the anchor's own record, and the host's clock reads
        assert s0 - slack <= d0 < s1  # the first op ran while the dispatch issued
        assert d1 <= f1 + slack and d1 - d0 > 0.5 * (s1 - s0)
    assert trace_cli.lane_occupancy(events)["mean"] > 0.5
    cpu = BN254TorchConstructor(batch_size=4, device="cpu", warmup=False).prepare(pks)
    assert cpu.device_span(cpu.dispatch(b"service engine", reqs[:1])) is None


def _fleet_toml(tmp_path, **changes):
    from pathlib import Path

    from handel_tpu_torch.sim.config import RunConfig, SimConfig, dump_config

    cfg = SimConfig(network="udp", scheme="bn254-cuda", shared_verifier=True, batch_size=16,
                    max_timeout_s=300.0, runs=[RunConfig(nodes=8, threshold=8, processes=1)],
                    **changes)
    path = Path(tmp_path) / "fleet.toml"
    path.write_text(dump_config(cfg))
    return path


def _kernel_lines(run_dir):
    import json

    out = {}
    for p in sorted(run_dir.glob("node_0_*.out")):
        text = p.read_text()
        assert "node process finished OK" in text, text[-2000:]
        (out[p.name],) = [json.loads(ln.split(": ", 1)[1]) for ln in text.splitlines()
                          if ln.startswith("node process kernels: ")]
    return out


def test_remote_platform_device_host_serves_a_chipless_host(card, tmp_path):
    """`--platform remote` on two localhost-as-remote hosts (A with the
    card, B without): A's process builds the kernels in its staging dir and
    launches B1; B's process ships its candidates over RPC and never
    initialises CUDA."""
    import csv
    import os
    import subprocess
    import sys
    from pathlib import Path

    from handel_tpu_torch.sim.config import HostSpec

    root = Path(__file__).resolve().parents[1]
    cfg = _fleet_toml(tmp_path, hosts=[
        HostSpec(connect="local", workdir=str(tmp_path / "hostA"), device=True),
        HostSpec(connect="local", workdir=str(tmp_path / "hostB"))])
    env = dict(os.environ, HANDEL_TORCH_DEVICE="cuda",
               PYTHONPATH=os.pathsep.join([str(root), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "handel_tpu_torch.sim", "--config", str(cfg), "--workdir",
         str(tmp_path / "out"), "--platform", "remote"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert list((tmp_path / "hostA" / "build" / "torch_kernels").glob("libfp_mont-*.so"))
    kern = _kernel_lines(tmp_path / "out")
    a, b = kern["node_0_0_0.out"], kern["node_0_1_1.out"]
    assert a["initialized_cuda"] and a["launches_in_round"]["fp_mont_mul"] > 0
    assert a["verifier_launches"] >= 1
    assert not b["initialized_cuda"] and b["launches"]["fp_mont_mul"] == 0
    with open(tmp_path / "out" / "results_0.csv") as f:
        row = next(csv.DictReader(f))
    assert float(row["device_rpc_rpcSentCandidates_sum"]) > 0
    assert float(row["device_verifier_failoverBatches_sum"]) == 0


WATCH_CONTEXT = r"""
import sys
import torch
from handel_tpu_torch.sim.watch_cli import main
rc = main(sys.argv[1:])
print("watch cuda initialized:", torch.cuda.is_initialized())
sys.exit(rc)
"""


def test_watch_runs_a_card_fleet_without_a_context_of_its_own(card, tmp_path):
    """`sim watch` launches a card run on a thread of its own process: the
    node processes launch B1, the dashboard renders, and the watching
    process never initialises CUDA."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    cfg = _fleet_toml(tmp_path, metrics=True)
    env = dict(os.environ, HANDEL_TORCH_DEVICE="cuda",
               PYTHONPATH=os.pathsep.join([str(root), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-c", WATCH_CONTEXT, str(cfg), "--workdir", str(tmp_path / "w"),
         "--interval", "0.5", "--snapshot", str(tmp_path / "snap.txt")],
        cwd=root, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "watch cuda initialized: False" in out.stdout
    assert "aggregation wave" in out.stdout
    kern = _kernel_lines(tmp_path / "w")
    assert kern and all(k["launches_in_round"]["fp_mont_mul"] > 0 for k in kern.values())


def test_registry_staging_runs_beside_an_inflight_launch_on_its_own_stream(card):
    """The epoch rotation on the card. A verify launch is dispatched from a
    worker thread behind about 3 s of device work at the head of the verify
    stream; `stage_registry` on this thread meanwhile builds bank B's prefix
    table with B1 on the registry stream and returns in well under that
    time, before the launch's verdicts, which are still bank A's. The flip
    launches no B1, and the next launch verifies against bank B."""
    import threading
    import time

    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.models.bn254 import BN254PublicKey

    eng, sks, _ = _service_engine(card)
    reqs, want = _service_candidates(sks)
    rng = random.Random(99)
    sks_b = [rng.randrange(1, 1 << 30) for _ in range(16)]
    pks_b = [BN254PublicKey(bn.g2_mul(bn.G2_GEN, s)) for s in sks_b]
    reqs_b, want_b = _service_candidates(sks_b)
    with torch.cuda.stream(eng._verify_stream):
        torch.cuda._sleep(int(3 * 1.98e9))  # >= 3 s at the H100's highest clock
    out = {}

    def verify():
        handle = eng.dispatch(b"service engine", reqs[:4])
        out["verdicts"] = eng.fetch(handle)
        out["fetched"] = time.perf_counter()

    worker = threading.Thread(target=verify)
    worker.start()
    t0 = time.perf_counter()
    with mont_mul.tally() as staged_widths:
        assert eng.stage_registry(pks_b) == 16
    staged = time.perf_counter()
    worker.join()
    assert staged - t0 < 1.5, f"the staging waited {staged - t0:.2f} s"
    assert staged < out["fetched"]
    assert sum(staged_widths.values()) > 0
    assert out["verdicts"] == want[:4]  # bank A served the launch in flight
    with mont_mul.tally() as flip_widths:
        assert eng.activate_staged() == 1
    assert sum(flip_widths.values()) == 0
    assert eng._staged is None and eng.epoch == 1
    assert eng.batch_verify(b"service engine", reqs_b) == want_b


def test_size_changing_rotation_on_card_matches_the_cpu_engine(card):
    """A rotation from 16 keys to 12 on the card and on the CPU: the staged
    prefix tables are equal limb for limb, and the verdicts after the flip
    are equal and as known by construction."""
    from handel_tpu_torch.core.bitset import BitSet
    from handel_tpu_torch.models.bn254 import BN254PublicKey, BN254Signature, hash_to_g1
    from handel_tpu_torch.models.bn254_torch import BN254Device

    eng, _sks, _ = _service_engine(card)
    rng = random.Random(12)
    sks_c = [rng.randrange(1, 1 << 30) for _ in range(12)]
    pks_c = [BN254PublicKey(bn.g2_mul(bn.G2_GEN, s)) for s in sks_c]
    cpu = BN254Device(_service_keys()[1], batch_size=4, device="cpu")
    for e in (eng, cpu):
        e.stage_registry(pks_c)
    for a, b in zip(eng._staged.tensors(), cpu._staged.tensors()):
        assert torch.equal(a.cpu(), b)
    assert eng.activate_staged() == cpu.activate_staged() == 1
    assert eng.n == 12 and eng._stage[0].words.shape == (4, 1)

    def cand(idx, forge=False):
        bs = BitSet(12)
        for i in idx:
            bs.set(i, True)
        k = (sum(sks_c[i] for i in idx) + forge) % bn.R
        return bs, BN254Signature(bn.g1_mul(hash_to_g1(b"m"), k))

    reqs = [cand(range(0, 7)), cand([2, 3, 5, 8, 11]), cand(range(4, 9), forge=True)]
    assert eng.batch_verify(b"m", reqs) == cpu.batch_verify(b"m", reqs) == [True, True, False]


# -- stake weights and departures (chip_smoke.py phase 15) ---------------------


def _weighted_round_on(device, n: int, batch: int):
    """A weighted, churning n-node round through one
    BatchVerifierService(fallback=None) over a BN254TorchScheme engine on
    `device`: pareto stake (seed 7) gated at 0.55 of it, the highest id a
    churner leaving at once. Every batch the nodes send the service is
    logged with its verdicts; after the round one forged candidate (node
    0's signature over another message) goes through the same service and
    is logged last. Returns the finals' stakes, the departures each
    survivor marked, the gate, the service's values, B1's launches in the
    round, the log, the message and the public keys."""
    import asyncio
    from types import SimpleNamespace

    from handel_tpu_torch.core.bitset import BitSet
    from handel_tpu_torch.core.config import Config
    from handel_tpu_torch.core.crypto import verify_multisignature
    from handel_tpu_torch.core.test_harness import LocalCluster
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.models.bn254 import BN254Scheme
    from handel_tpu_torch.models.bn254_torch import BN254TorchScheme
    from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
    from handel_tpu_torch.scenario.weights import make_weights
    from handel_tpu_torch.sim.adversary import forged_signature

    w = make_weights("pareto", n, seed=7)
    gate = 0.55 * sum(w)
    scheme = BN254TorchScheme(batch_size=batch, device=device)
    log = []

    async def go():
        engine = scheme.constructor.prepare(LocalCluster(n, scheme=scheme).registry.public_keys())
        svc = BatchVerifierService(engine, max_delay_ms=1.0, fallback=None)

        async def logged(msg, pubkeys, requests):
            verdicts = await svc.verify(msg, pubkeys, requests)
            log.append((list(requests), list(verdicts)))
            return verdicts

        def factory(i):
            c = Config()
            c.verifier = logged
            c.rand = random.Random(1 + i)
            c.weights = w
            c.weight_threshold = gate
            return c

        cluster = LocalCluster(n, scheme=scheme, config_factory=factory,
                               adversaries={n - 1: "churner"}, churn_after_s=0.0,
                               verifier_service=svc)
        before = mont_mul.launches
        cluster.start()
        try:
            finals = await cluster.wait_complete_success(timeout=600.0)
            b1 = mont_mul.launches - before
            bs = BitSet(n)
            bs.set(0, True)
            forged = forged_signature(scheme.keygen(0)[0], cluster.msg)
            await logged(cluster.msg, cluster.registry.public_keys(), [(bs, forged)])
        finally:
            cluster.stop()
            svc.stop()
        return cluster, finals, svc.values(), b1

    cluster, finals, values, b1 = asyncio.run(go())
    host = BN254Scheme().constructor
    assert all(verify_multisignature(cluster.msg, f, cluster.registry, host)
               for f in finals.values())
    return SimpleNamespace(
        stakes={i: f.bitset.weight_sum(w) for i, f in sorted(finals.items())},
        departed={i: sorted(h.departed) for i, h in sorted(cluster.handels.items())},
        gate=gate, values=values, b1=b1, log=log, msg=cluster.msg,
        pks=cluster.registry.public_keys())


def _replayed(run, constructor):
    """`run`'s logged batches through another constructor, batch by batch."""
    return [constructor.batch_verify(run.msg, run.pks, reqs) for reqs, _ in run.log]


def test_weighted_churning_round_on_the_card_engine(card):
    """8 nodes on the card engine: every survivor's final verifies on the
    host oracle and clears the stake gate, every survivor marked the
    churner, B1 launched, no failover or retry; every verdict the card gave
    in the round equals the host oracle's on the same candidates, and the
    forged candidate is rejected."""
    from handel_tpu_torch.models.bn254 import BN254Scheme

    run = _weighted_round_on(card, 8, 8)
    assert sorted(run.stakes) == list(range(7))
    assert all(s >= run.gate for s in run.stakes.values())
    assert run.departed == {i: [7] for i in range(7)}
    assert run.values["failoverBatches"] == run.values["deviceRetryCt"] == 0.0
    assert run.values["verifierLaunches"] >= 1 and run.b1 > 0
    card_verdicts = [v for _, v in run.log]
    assert card_verdicts[-1] == [False] and any(v == [True] for v in card_verdicts[:-1])
    assert _replayed(run, BN254Scheme().constructor) == card_verdicts


def test_weighted_churning_round_on_card_matches_the_cpu_engine(card):
    """The same 4-node round on the card and on the CPU engine: the same
    gate and departures, every final over the gate on both; the card's
    round's batches replayed through the CPU engine and the host oracle
    give the card's verdicts one for one, the forgery rejected by all
    three."""
    from handel_tpu_torch.models.bn254 import BN254Scheme
    from handel_tpu_torch.models.bn254_torch import BN254TorchScheme

    ours = _weighted_round_on(card, 4, 4)
    cpu = _weighted_round_on("cpu", 4, 4)
    assert ours.gate == cpu.gate and ours.departed == cpu.departed == {i: [3] for i in range(3)}
    assert sorted(ours.stakes) == sorted(cpu.stakes) == [0, 1, 2]
    assert all(s >= ours.gate for s in [*ours.stakes.values(), *cpu.stakes.values()])
    assert ours.b1 > 0 and cpu.b1 == 0
    card_verdicts = [v for _, v in ours.log]
    assert card_verdicts[-1] == [False]
    cpu_engine = BN254TorchScheme(batch_size=4, device="cpu").constructor
    assert _replayed(ours, cpu_engine) == card_verdicts
    assert _replayed(ours, BN254Scheme().constructor) == card_verdicts
    assert [v for _, v in cpu.log] == _replayed(cpu, BN254Scheme().constructor)


def test_mesh_launch_on_card_equals_the_single_card_engine(card):
    """A K = 2 mesh (cuda:0 and cuda:1 when two cards are visible, else two
    shards on cuda:0) over a registry that 2 does not divide: a range and a
    dense launch give the single-card engine's verdicts, B1 launching inside
    each on every shard's card, and the host oracle replays the forgery and
    an honest candidate to the same verdicts."""
    from handel_tpu_torch.core.bitset import BitSet
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.models.bn254 import (
        BN254PublicKey,
        BN254Scheme,
        BN254Signature,
        hash_to_g1,
    )
    from handel_tpu_torch.models.bn254_torch import BN254Device
    from handel_tpu_torch.parallel.mesh_plane import bn254_mesh_engine
    from handel_tpu_torch.parallel.sharding import make_mesh

    rng = random.Random(15)
    n = 81  # the second shard's last point is edge padding
    sks = [rng.randrange(1, 1 << 30) for _ in range(n)]
    pks = [BN254PublicKey(bn.g2_mul(bn.G2_GEN, s)) for s in sks]
    h = hash_to_g1(b"m")

    def cand(idx, forge=False):
        bs = BitSet(n)
        for i in idx:
            bs.set(i, True)
        k = (sum(sks[i] for i in idx) + forge) % bn.R
        return bs, BN254Signature(bn.g1_mul(h, k))

    devices = ([torch.device("cuda", i) for i in range(2)]
               if torch.cuda.device_count() >= 2 else [card, card])
    eng = bn254_mesh_engine(pks, 2, batch_size=4, mesh=make_mesh(2, devices=devices))
    single = BN254Device(pks, batch_size=4, device=card)
    range_reqs = [cand(range(3, 60)), cand(range(5, 9), forge=True), cand([7, 9, 11])]
    dense = [cand([0, 80]), cand(range(0, 81, 3)), cand([1, 78], forge=True)]
    for reqs, kind in ((range_reqs, "range"), (dense, "dense")):
        assert eng._pack_requests(reqs).kind == kind
        before, launches = dict(mont_mul.devices), mont_mul.launches
        got = eng.batch_verify(b"m", reqs)
        assert mont_mul.launches > launches
        assert {d for d, c in mont_mul.devices.items() if c != before.get(d, 0)} == {
            d.index for d in devices}
        assert got == single.batch_verify(b"m", reqs)
    assert eng.mesh_launches == 2 and eng.mesh_candidates == 6
    host = BN254Scheme().constructor
    replay = [range_reqs[1], dense[1]]
    assert host.batch_verify(b"m", pks, replay) == eng.batch_verify(b"m", replay) == [False, True]
