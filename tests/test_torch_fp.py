"""The port's Field (handel_tpu_torch/ops/fp.py) against the JAX package's.

Same seeded inputs through both packages, exact equality (integer
arithmetic: no tolerance). The JAX side runs eagerly on the CPU: its plain
XLA Field (`use_pallas=False`) and the Pallas kernel's body
`Field._mul_cols` called on jnp arrays, with no `pallas_call`. On the CPU
the port's `mul` is its plain PyTorch version; the CUDA kernel is held
against that same plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py), and its arithmetic on the host in tests/test_torch_fp_host.py.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handel_tpu.ops import bls12_381_ref
from handel_tpu.ops import bn254_ref as jbn
from handel_tpu.ops.fp import Field as JaxField
from handel_tpu.ops.fp import windowed_pow_digits as jax_digits
from handel_tpu_torch.ops.fp import Field, windowed_pow_digits

torch.set_num_threads(1)

PRIMES = {"bn254": jbn.P, "bls12_381": bls12_381_ref.P}
B = 12


@pytest.fixture(scope="module", params=sorted(PRIMES))
def fields(request):
    p = PRIMES[request.param]
    return Field(p, device="cpu"), JaxField(p, use_pallas=False)


def to_jax(t: torch.Tensor):
    return jnp.asarray(t.numpy().astype(np.uint32))


def from_jax(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def values(p: int, k: int, seed: int) -> list[int]:
    """k seeded field elements, led by the edge values 0, 1, p-1, R mod p."""
    rng = random.Random(seed)
    r = (1 << (16 * ((p.bit_length() + 15) // 16))) % p
    edges = [0, 1, p - 1, r, p - 2, (p - 1) // 2]
    return edges + [rng.randrange(p) for _ in range(k - len(edges))]


def test_params_match(fields):
    F, J = fields
    assert F.nlimbs == J.nlimbs and F.mont_r == J.mont_r and F.n0 == J.n0
    assert (F.p_limbs_np == J.p_limbs_np.astype(np.int32)).all()
    assert F.n0_32 * F.p % (1 << 32) == (1 << 32) - 1  # the kernel's -p^-1


def test_pack_unpack_match_jax(fields):
    F, J = fields
    xs = values(F.p, B, 1)
    for mont in (True, False):
        ours = F.pack(xs, mont=mont)
        assert ours.dtype == torch.int32 and ours.shape == (F.nlimbs, B)
        assert ours.is_contiguous()  # the kernel takes unit column stride
        assert (ours.numpy() == np.asarray(J.pack(xs, mont=mont))).all()
        assert (F.pack_batch_np(xs, mont=mont) == J.pack_batch_np(xs, mont=mont)).all()
        assert F.unpack(ours, mont=mont) == xs == J.unpack(to_jax(ours), mont=mont)
    assert torch.equal(F.constant(5, 3), F.pack([5] * 3))


def test_mul_matches_jax_and_pallas_body(fields):
    F, J = fields
    xs = values(F.p, B, 2)
    ys = values(F.p, B, 3)[::-1]
    # every pair of edge values too
    xs += [x for x in xs[:6] for _ in range(6)]
    ys += [y for _ in range(6) for y in ys[-6:]]
    a, b = F.pack(xs), F.pack(ys)
    ours = F.mul(a, b)
    assert torch.equal(ours, from_jax(J.mul(to_jax(a), to_jax(b))))
    assert torch.equal(ours, from_jax(J._mul_cols(to_jax(a), to_jax(b))))
    assert F.unpack(ours) == [x * y % F.p for x, y in zip(xs, ys)]
    assert torch.equal(F.sqr(a), F.mul(a, a))


def test_add_sub_neg_match_jax(fields):
    F, J = fields
    xs, ys = values(F.p, B, 4), values(F.p, B, 5)[::-1]
    a, b = F.pack(xs), F.pack(ys)
    ja, jb = to_jax(a), to_jax(b)
    assert torch.equal(F.add(a, b), from_jax(J.add(ja, jb)))
    assert torch.equal(F.sub(a, b), from_jax(J.sub(ja, jb)))
    assert torch.equal(F.sub(b, a, 7), from_jax(J.sub(jb, ja, 7)))
    assert torch.equal(F.neg(a), from_jax(J.neg(ja)))
    assert F.unpack(F.add(a, b)) == [(x + y) % F.p for x, y in zip(xs, ys)]
    assert F.unpack(F.sub(a, b)) == [(x - y) % F.p for x, y in zip(xs, ys)]
    assert F.unpack(F.neg(a)) == [-x % F.p for x in xs]


def test_carry_machinery_matches_jax(fields):
    """_ks_carry / _borrow_chain / _cond_sub_p on raw limb sums, including
    carry chains that run the full width."""
    F, J = fields
    n = F.nlimbs
    rng = np.random.default_rng(6)
    s = rng.integers(0, 1 << 17, size=(n, 64)).astype(np.int32)
    s[:, 0] = 0xFFFF
    s[0, 0] = 0x10000  # carry through every limb
    r, c = F._ks_carry(torch.from_numpy(s))
    jr, jc = J._ks_carry(jnp.asarray(s.astype(np.uint32)))
    assert torch.equal(r, from_jax(jr)) and (c.numpy() == np.asarray(jc)).all()
    t = rng.integers(-(1 << 16) + 1, 1 << 16, size=(n, 64)).astype(np.int32)
    t[:, 1] = 0
    t[0, 1] = -1  # borrow through every limb
    bi, bt = F._borrow_chain(torch.from_numpy(t))
    jbi, jbt = J._borrow_chain(jnp.asarray(t))
    assert torch.equal(bi, from_jax(jbi)) and (bt.numpy() == np.asarray(jbt)).all()
    xs = values(F.p, B, 7)
    two_p = F.pack_batch_np([x + F.p if x < F.p - 1 else x for x in xs], mont=False)
    r = torch.from_numpy(two_p)  # values in [p, 2p): one subtract each
    assert torch.equal(F._cond_sub_p(r), from_jax(J._cond_sub_p(jnp.asarray(two_p.astype(np.uint32)))))


def test_inv_and_pow_match_jax(fields):
    F, J = fields
    xs = values(F.p, 6, 8)
    a = F.pack(xs)
    ja = to_jax(a)
    inv = F.inv(a)
    assert torch.equal(inv, from_jax(J.inv(ja)))
    assert F.unpack(inv) == [pow(x, F.p - 2, F.p) for x in xs]  # 0 -> 0
    for e in (1, 2, 3, 5, 16, 0x1234567):
        want = [pow(x, e, F.p) for x in xs]
        for window in (1, 4):
            assert F.unpack(F.pow_const(a, e, window=window)) == want
    assert torch.equal(F.pow_const(a, 0x1234567), from_jax(J.pow_const(ja, 0x1234567, window=4)))


def test_mont_conversions_match_jax(fields):
    F, J = fields
    xs = values(F.p, B, 9)
    raw = F.pack(xs, mont=False)
    m = F.to_mont(raw)
    assert torch.equal(m, F.pack(xs))
    assert torch.equal(m, from_jax(J.to_mont(to_jax(raw))))
    assert torch.equal(F.from_mont(m), raw)
    assert torch.equal(F.from_mont(m), from_jax(J.from_mont(to_jax(m))))


def test_select_eq_is_zero(fields):
    F, J = fields
    xs = values(F.p, B, 10)
    a = F.pack(xs)
    b = F.pack(xs[::-1])
    mask = torch.tensor([i % 3 == 0 for i in range(B)])
    sel = F.select(mask, a, b)
    jsel = J.select(jnp.asarray(mask.numpy()), to_jax(a), to_jax(b))
    assert torch.equal(sel, from_jax(jsel))
    assert F.eq(a, a).all() and (F.eq(a, b).numpy() == np.asarray(J.eq(to_jax(a), to_jax(b)))).all()
    assert F.is_zero(a).tolist() == [x == 0 for x in xs]


@pytest.mark.parametrize("window", [1, 2, 3, 4, 5])
def test_windowed_pow_digits_match_jax(window):
    for e in (1, 2, 15, 16, 17, 0xDEADBEEF, jbn.P - 2, jbn.U):
        assert windowed_pow_digits(e, window) == jax_digits(e, window)


def test_plain_mul_is_the_cpu_path_and_raises_elsewhere():
    """CPU tensors take the plain version; the kernel wrapper refuses them."""
    from handel_tpu_torch.kernels.fp_mont import mont_mul

    F = Field(jbn.P, device="cpu")
    a = F.pack(values(F.p, 4, 11))
    before = mont_mul.launches
    assert torch.equal(F.mul(a, a), F._mul_plain(a, a))
    assert mont_mul.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        mont_mul(F, a, a)
    with pytest.raises(ValueError):
        Field(jbn.P, device="meta")
