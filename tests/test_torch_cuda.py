"""Tests of the port that need an NVIDIA GPU: the CUDA kernels have no CPU mode.

Marked `cuda`; each skips, saying why, where torch sees no card. On a
machine with a card and nvcc (JAX need not be installed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports nothing of the JAX package, so it also runs there.
"""

import random

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


LAB_FORMS = ("cios_fullwidth", "separated")


@pytest.mark.parametrize("form", LAB_FORMS)
@pytest.mark.parametrize("p", [bn.P, BLS12_381_P], ids=["bn254", "bls12_381"])
@pytest.mark.parametrize("cols", [1, 31, 255, 257, 4099])
def test_lab_kernels_match_plain_and_b1_at_ragged_widths(card, p, cols, form):
    from handel_tpu_torch.kernels import lab_mont
    from handel_tpu_torch.scripts.fp_kernel_lab import LabField

    F = Field(p, device=card)
    lab = LabField(F)
    counter = getattr(lab_mont, f"lab_{form}")
    rng = random.Random(cols + len(form))
    xs = [rng.randrange(p) for _ in range(cols)]
    ys = [rng.randrange(p) for _ in range(cols)]
    a, b = F.pack(xs, mont=False), F.pack(ys, mont=False)
    for threads in lab_mont.THREADS:
        before = counter.launches
        got = lab.kernel(form, threads)(a, b)
        assert counter.launches == before + 1
        assert torch.equal(got, lab.body(form)(a, b))
        assert torch.equal(got, F.mul(a, b))  # kernel B1
    rinv = pow(F.mont_r, -1, p)
    assert F.unpack(got, mont=False) == [x * y * rinv % p for x, y in zip(xs, ys)]
    # raw 16-bit digits: the plain body's bits
    gen = torch.Generator().manual_seed(cols)
    ra = torch.randint(0, 1 << 16, (F.nlimbs, cols), generator=gen, dtype=torch.int32).to(card)
    rb = torch.randint(0, 1 << 16, (F.nlimbs, cols), generator=gen, dtype=torch.int32).to(card)
    assert torch.equal(lab.kernel(form)(ra, rb), lab.body(form)(ra, rb))
    # row slices of a wider operand take the kernel's row stride
    wide = torch.cat([a, a], dim=1)
    assert torch.equal(lab.kernel(form)(wide[:, cols:], b), got)


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
        with pytest.raises(ValueError, match="threads"):
            k(lab, a, a, threads=1024)
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
