"""The port's RNS field backend (handel_tpu_torch/ops/rns.py) against the
JAX package's (handel_tpu/ops/rns.py), at 16 limbs (BN254) and 24 limbs
(BLS12-381).

Same seeded numpy inputs through both packages; tolerance: bitwise (every
limb and residue equal). The reference runs eagerly on the CPU, where its
`mul_resident` takes `_mul_resident_core` (no Pallas); the port's side is
its plain PyTorch version. Kernel B2 is held against that same plain
version on the host (tests/test_torch_rns_host.py) and on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handel_tpu.ops import bls12_381_ref
from handel_tpu.ops import bn254_ref as jbn
from handel_tpu.ops.rns import RnsField as JaxRns
from handel_tpu_torch.ops.fp import Field
from handel_tpu_torch.ops.rns import ResidentRns, RnsField

torch.set_num_threads(1)

PRIMES = {"bn254": jbn.P, "bls12_381": bls12_381_ref.P}
B = 24


@pytest.fixture(scope="module", params=sorted(PRIMES))
def fields(request):
    p = PRIMES[request.param]
    return Field(p, backend="rns", device="cpu"), JaxRns(p)


def to_jax(t: torch.Tensor):
    return jnp.asarray(t.numpy())


def same(ours: torch.Tensor, theirs) -> bool:
    t = np.asarray(theirs).astype(np.int64)
    return ours.shape == t.shape and bool((ours.numpy().astype(np.int64) == t).all())


def values(p: int, k: int, seed: int) -> list[int]:
    """k seeded field elements, led by the edge values 0, 1, p-1, p-2."""
    rng = np.random.default_rng(seed)
    edges = [0, 1, p - 1, p - 2]
    words = rng.integers(0, 1 << 63, size=(k - len(edges), 7), dtype=np.uint64)
    return edges + [sum(int(w) << (63 * i) for i, w in enumerate(row)) % p for row in words]


def residues_of(F, vs) -> torch.Tensor:
    """Joint-base residues of Python integers, computed on the host."""
    return torch.tensor([[v % int(m) for v in vs] for m in F._m_all], dtype=torch.int32)


def test_basis_constants_match(fields):
    F, J = fields
    for name in ("mA", "mB", "mr", "M", "MB", "kA", "kB", "k_all", "n8out", "n16out",
                 "mont_r", "mont_r2", "_MBinv_r"):
        assert getattr(F, name) == getattr(J, name), name
    for name in ("_W", "_E", "_E2", "_L8", "_MB8", "_c1", "_c2", "_p_modB", "_MinvB",
                 "_L_mr", "_MB_modA", "_one_res", "_off_res", "_m_all"):
        ours, theirs = getattr(F, name), getattr(J, name)
        assert ours.dtype == np.int32 and ours.shape == theirs.shape, name
        assert (ours == theirs).all(), name
    assert len(F._sub_consts) == len(J._sub_consts)
    assert all((a == b).all() for a, b in zip(F._sub_consts, J._sub_consts))
    assert (F.kA, F.kB, F.k_all) in ((24, 21, 46), (34, 30, 65))


def test_backend_seam():
    """Field(backend=...): "rns" redirects to RnsField, "cios"/None stay
    Field, any other name raises, RnsField refuses another backend name."""
    assert type(Field(jbn.P, backend="rns", device="cpu")) is RnsField
    assert Field(jbn.P, backend="rns", device="cpu").backend == "rns"
    assert type(Field(jbn.P, backend="cios", device="cpu")) is Field
    assert Field(jbn.P, device="cpu").backend == "cios"
    with pytest.raises(ValueError, match="unknown Field backend"):
        Field(jbn.P, backend="mxu", device="cpu")
    with pytest.raises(ValueError, match="'rns' backend"):
        RnsField(jbn.P, backend="cios", device="cpu")
    assert RnsField(jbn.P, device="cpu").backend == "rns"


def test_pack_and_mont_conversions(fields):
    """Packing uses the Montgomery constant M, and to_mont/from_mont on the
    port's RnsField multiply by M^2 and 1 (R^2 is built from M, not R)."""
    F, J = fields
    xs = values(F.p, B, 1)
    packed = F.pack(xs)
    assert same(packed, J.pack(xs))
    plain = F.pack(xs, mont=False)
    assert same(plain, J.pack(xs, mont=False))
    m = F.to_mont(plain)
    assert torch.equal(m, packed)
    assert same(m, J.to_mont(to_jax(plain)))
    assert F.unpack(F.from_mont(m), mont=False) == xs
    assert same(F.from_mont(m), J.from_mont(to_jax(m)))
    assert F.unpack(packed) == xs


def test_to_rns_and_crt_match(fields):
    F, J = fields
    a = F.pack(values(F.p, B, 2), mont=False)
    assert same(F.to_rns(a), J.to_rns(to_jax(a)))
    # the exact CRT of values up to (kA+1) p - 1, the largest it receives
    top = (F.kA + 1) * F.p - 1
    vs = [0, 1, top, top - F.p] + values(F.p, B - 4, 3)
    r = residues_of(F, vs)
    kA, kB = F.kA, F.kB
    got = F.from_rns_base_b(r[kA : kA + kB], r[-1])
    assert got.dtype == torch.int32
    assert same(got, J.from_rns_base_b(to_jax(r[kA : kA + kB]), to_jax(r[-1])))
    w = got.numpy().astype(np.int64)
    assert [sum(int(w[i, j]) << (16 * i) for i in range(F.n16out)) for j in range(len(vs))] == vs


def test_mul_matches(fields):
    F, J = fields
    xs, ys = values(F.p, B, 4), values(F.p, B, 5)[::-1]
    a, b = F.pack(xs), F.pack(ys)
    got = F.mul(a, b)
    assert same(got, J.mul(to_jax(a), to_jax(b)))
    assert F.unpack(got) == [x * y % F.p for x, y in zip(xs, ys)]
    assert same(F.sqr(a), J.mul(to_jax(a), to_jax(a)))
    assert F.mul(a[:, :0], b[:, :0]).shape == (F.nlimbs, 0)


@pytest.mark.parametrize("bound_log", [0, 6, 28])
def test_resident_ops_match(fields, bound_log):
    """mul/add/sub/refresh on residues of values v < 2^bound_log p, and the
    to/from round trips, bit for bit against the reference."""
    F, J = fields
    rng = np.random.default_rng(bound_log)
    lifts = rng.integers(0, 1 << bound_log, size=B) if bound_log else [0] * B
    xs, ys = values(F.p, B, 6), values(F.p, B, 7)
    va = [x + int(t) * F.p for x, t in zip(xs, lifts)]
    vb = [y + int(t) * F.p for y, t in zip(ys, lifts[::-1])]
    ra, rb = residues_of(F, va), residues_of(F, vb)
    ja, jb = to_jax(ra), to_jax(rb)
    prod = F.mul_resident(ra, rb)
    assert prod.dtype == torch.int32 and same(prod, J.mul_resident(ja, jb))
    assert same(F.add_resident(ra, rb), J.add_resident(ja, jb))
    for blog in sorted({bound_log, 24, F.RES_MAX_BLOG}):
        assert same(F.sub_resident(ra, rb, blog), J.sub_resident(ja, jb, blog))
    assert same(F.refresh_resident(ra), J.refresh_resident(ja))
    out = F.from_resident(prod)
    assert same(out, J.from_resident(J.mul_resident(ja, jb)))
    minv = pow(F.M, -1, F.p)
    assert F.unpack(out, mont=False) == [a * b * minv % F.p for a, b in zip(va, vb)]
    # round trip through the residues of canonical limbs
    limbs = F.pack(xs)
    res = F.to_resident(limbs)
    assert same(res, J.to_resident(to_jax(limbs)))
    assert torch.equal(F.from_resident(res), limbs)


def test_resident_adapter_contracts(fields):
    """sub/neg need a blog literal inside the offset table; eq/is_zero
    raise; constant() counts no conversion; select keeps int32."""
    F, _ = fields
    A = F.resident()
    assert isinstance(A, ResidentRns) and F.resident() is A
    assert A.nlimbs == F.k_all and A.limb_dtype == torch.int32 and A.device == F.device
    a, b = A.pack([3, 5]), A.pack([1, 2])
    with pytest.raises(ValueError, match="blog"):
        F.sub_resident(a, b, None)
    with pytest.raises(ValueError, match="offset table"):
        F.sub_resident(a, b, F.RES_MAX_BLOG + 1)
    with pytest.raises(RuntimeError):
        A.eq(a, b)
    with pytest.raises(RuntimeError):
        A.is_zero(a)
    before = F.conversion_counts()["total"]
    one = A.constant(1, 2)
    assert F.conversion_counts()["total"] == before
    assert one.dtype == torch.int32 and one.shape == (F.k_all, 2)
    assert A.unpack(A.mul(a, one)) == [3, 5]
    assert A.unpack(A.neg(a, 0)) == [F.p - 3, F.p - 5]
    sel = A.select(torch.tensor([True, False]), a, b)
    assert sel.dtype == torch.int32 and A.unpack(sel) == [3, 2]
    assert A.unpack(A.inv(a)) == [pow(3, -1, F.p), pow(5, -1, F.p)]


def test_conversion_counters(fields):
    """to/from_resident count one crossing each; resident ops none; the
    per-mul path one of each per call, as the reference counts them."""
    F, J = fields
    for fld in (F, J):
        A = fld.resident()
        fld.reset_conversion_counts()
        a = A.pack([7, 11])
        assert fld.conversion_counts() == {"to_resident": 1, "from_resident": 0, "total": 1}
        A.mul(a, a)
        assert fld.conversion_counts()["total"] == 1
        A.unpack(a)
        assert fld.conversion_counts() == {"to_resident": 1, "from_resident": 1, "total": 2}
        fld.reset_conversion_counts()
        x = fld.pack([7, 11])
        fld.mul(x, x)
        assert fld.conversion_counts() == {"to_resident": 1, "from_resident": 1, "total": 2}
        fld.reset_conversion_counts()


def test_cpu_tensors_launch_no_kernel(fields):
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident

    F, _ = fields
    before = (mont_mul.launches, rns_mul_resident.launches)
    a = F.pack([3, 4])
    F.mul(a, a)
    F.from_resident(F.mul_resident(F.to_resident(a), F.to_resident(a)))
    assert (mont_mul.launches, rns_mul_resident.launches) == before


def test_rns_smoke_on_the_cpu(capsys):
    """The port's counterpart of scripts/rns_smoke.py with --full, on the
    CPU: checks 1, 2, 3, 5 and 6, and the resident pairing against the
    oracle."""
    from handel_tpu_torch.scripts import rns_smoke

    assert rns_smoke.main(["--device", "cpu", "--full"]) == 0
    out = capsys.readouterr().out
    assert "rns_smoke[full]: resident pairing_check accepts valid / rejects forged" in out
    assert out.strip().splitlines()[-1] == "rns_smoke: OK"
