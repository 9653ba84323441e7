"""The plain reference: its curve arithmetic against the port's scalar
oracle (a second witness, read only here), and its control."""

from __future__ import annotations

import random

import pytest

from portbench.harness import spec
from portbench.reference import curves, verdicts
from portbench.reference.curves import FixedBase


@pytest.mark.parametrize("name", ["bn254", "bls12-381"])
def test_curve_arithmetic_matches_the_ports_oracle(name):
    if name == "bn254":
        from handel_tpu_torch.models.bn254 import hash_to_g1
        from handel_tpu_torch.ops import bn254_ref as ref
    else:
        from handel_tpu_torch.models.bls12_381 import hash_to_g1
        from handel_tpu_torch.ops import bls12_381_ref as ref
    c = curves.curve(name)
    assert c.g1.gen == ref.G1_GEN and c.g2.gen == ref.G2_GEN
    assert c.g1.on_curve(c.g1.gen) and c.g2.on_curve(c.g2.gen)
    for msg in (b"", b"portbench 1 message 0"):
        assert c.hash_to_g1(msg) == hash_to_g1(msg)
    rng = random.Random(5)
    ks = [rng.randrange(1, 1 << 30) for _ in range(4)]
    t2 = FixedBase(c.g2, c.g2.gen, 30)
    assert c.g2.to_affine([t2.mul(k) for k in ks]) == [ref.g2_mul(ref.G2_GEN, k) for k in ks]
    h = c.hash_to_g1(b"m")
    t1 = FixedBase(c.g1, h, 48)
    ks = [rng.randrange(1, 1 << 48) for _ in range(4)]
    assert c.g1.to_affine([t1.mul(k) for k in ks]) == [ref.g1_mul(h, k) for k in ks]
    assert c.g1.mul(c.g1.gen, c.r) is None and c.g2.mul(c.g2.gen, c.r) is None
    with pytest.raises(ValueError):
        t1.mul(1 << 48)


@pytest.mark.parametrize("seed", [2**33 + 1, 2**33 + 2, 2**33 + 3])
def test_the_control_comes_out_wrong(seed):
    """The control (the hole patch left out) disagrees with the reference
    on the range mix, on every seed."""
    n = 256
    c = curves.curve("bn254")
    mix = spec.load_mix("range")
    pool = spec.generator(mix).generate(c, n, mix["params"], seed)
    args = (c, n, pool.sks, pool.candidate_messages(), pool.words, pool.sigs)
    ref, ctl = verdicts.verdicts(*args), verdicts.control_verdicts(*args)
    wrong = sum(a != b for a, b in zip(ref, ctl))
    # every honest candidate with a hole inside its hull is rejected by it
    assert wrong >= 0.5 * len(ref)


def test_an_empty_signer_set_is_invalid():
    import numpy as np

    c = curves.curve("bn254")
    words = np.zeros((1, 1), np.uint64)
    assert verdicts.verdicts(c, 8, [1] * 8, [b"m"], words, [c.g1.gen]) == [False]
