"""Tests of the port that need an NVIDIA GPU: the CUDA kernel has no CPU mode.

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
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("p", [bn.P, BLS12_381_P], ids=["bn254", "bls12_381"])
@pytest.mark.parametrize("cols", [1, 31, 255, 257, 4099])
def test_kernel_matches_plain_at_ragged_widths(card, p, cols):
    from handel_tpu_torch.kernels.fp_mont import mont_mul

    F = Field(p, device=card)
    rng = random.Random(cols)
    xs = [rng.randrange(p) for _ in range(cols)]
    ys = [rng.randrange(p) for _ in range(cols)]
    a, b = F.pack(xs), F.pack(ys)
    before = mont_mul.launches
    got = F.mul(a, b)
    assert mont_mul.launches == before + 1
    assert torch.equal(got, F._mul_plain(a, b))
    assert F.unpack(got) == [x * y % p for x, y in zip(xs, ys)]
    # row slices of a wider operand take the kernel's row stride
    wide = torch.cat([a, a], dim=1)
    assert torch.equal(F.mul(wide[:, cols:], b), got)


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
