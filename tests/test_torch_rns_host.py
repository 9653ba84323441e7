"""Kernel B2's arithmetic, compiled for the host.

csrc/rns_mont.cuh keeps one warp's work on a tile of columns in `__host__
__device__` functions: each lane's residue-wise steps in the registers of
the two contractions' mma.sync fragments, the Barrett reduction `rns_mod`,
and the int8 plane split and recombination. Here a host C++ compiler builds
that same header behind a small C loop over warp tiles
(`rns_mul_resident_warp_host`, which steps the 32 lanes in turn between the
exchanges and runs each mma.sync as `mma_host` over the same fragment
registers), called through ctypes with the constant table that
kernels/rns_mont.py packs for the card, and the result is held against the
port's plain version (`RnsField._mul_resident_core`) and the reference's
(`handel_tpu.ops.rns.RnsField._mul_resident_core`, run eagerly on the CPU)
bit for bit, at both base sizes (BN254: kA, kB = 24, 21; BLS12-381: 34,
30) and both warp tile widths (8 and 16 columns): seeded random residues,
edge columns (0 and m_i - 1, and whole columns of m_i - 1, the largest sums
the uint32 recombination takes), row slices at odd column offsets, and the
integer identity x y M^-1 mod p through the resident conversions. The
launch around it runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from handel_tpu.ops import bls12_381_ref
from handel_tpu.ops.rns import RnsField as JaxRns
from handel_tpu_torch.kernels.rns_mont import a_row, int8_planes, pack_constants
from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops.fp import Field

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "handel_tpu_torch" / "csrc"
COLS = 2048

SHIM = r"""
#include "rns_mont.cuh"

template <int KA, int KB, int NT>
void warps(const int32_t* a, int64_t lda, const int32_t* b, int64_t ldb, int32_t* out,
           int64_t ldo, int64_t cols, const int32_t* consts) {
  for (int64_t c0 = 0; c0 < cols; c0 += 8 * NT)
    handel::rns_mul_resident_warp_host<KA, KB, NT>(a, lda, b, ldb, out, ldo, c0, cols, consts);
}

extern "C" int host_rns_mul_resident(const int32_t* a, int64_t lda,
                                     const int32_t* b, int64_t ldb,
                                     int32_t* out, int64_t ldo, int64_t cols,
                                     int ka, int kb, const int32_t* consts, int nt) {
  if (ka == 24 && kb == 21 && nt == 1)
    warps<24, 21, 1>(a, lda, b, ldb, out, ldo, cols, consts);
  else if (ka == 24 && kb == 21 && nt == 2)
    warps<24, 21, 2>(a, lda, b, ldb, out, ldo, cols, consts);
  else if (ka == 34 && kb == 30 && nt == 1)
    warps<34, 30, 1>(a, lda, b, ldb, out, ldo, cols, consts);
  else if (ka == 34 && kb == 30 && nt == 2)
    warps<34, 30, 2>(a, lda, b, ldb, out, ldo, cols, consts);
  else
    return 1;
  return 0;
}

// sum_i w_i x_i for k <= 64 through the kernel's path: w's planes (one
// 16-row tile of rows of `stride` bytes, w in row 0) as the warp's A
// fragments, x split by split7 into column 0 of the B fragments (64 deep),
// the emulated mma.sync products recombined; row 0, column 0 of the result
extern "C" uint32_t host_plane_sum(const int8_t* wlo, const int8_t* whi, int stride,
                                   const uint32_t* x, int k) {
  uint32_t xlo[32][2][2] = {}, xhi[32][2][2] = {}, out[32][1][4];
  for (int i = 0; i < k; ++i) {
    // column 0: lanes 0..3 (g = 0), depth row i in lane (i % 16) / 4,
    // register (i % 32) / 16 of step i / 32, byte i % 4
    const int l = (i % 16) / 4, ks = i / 32, h = (i % 32) / 16;
    handel::split7(x[i], i % 4, xlo[l][ks][h], xhi[l][ks][h]);
  }
  handel::contract_host<1, 2>(wlo, whi, stride, xlo, xhi, out);
  return out[0][0][0];
}

extern "C" int host_table_size(int ka, int kb) {
  if (ka == 24 && kb == 21) return handel::RnsLayout<24, 21>::size;
  if (ka == 34 && kb == 30) return handel::RnsLayout<34, 30>::size;
  return -1;
}

extern "C" uint32_t host_rns_mod(uint32_t v, uint32_t m, uint32_t mu) {
  return handel::rns_mod(v, m, mu);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the kernel header cannot be built for the host")
    d = tmp_path_factory.mktemp("rns_mont_host")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "librns_mont_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{CSRC}",
         "-o", str(so), str(d / "shim.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.host_rns_mul_resident.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.host_rns_mul_resident.restype = ctypes.c_int
    lib.host_plane_sum.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.host_plane_sum.restype = ctypes.c_uint32
    lib.host_table_size.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.host_table_size.restype = ctypes.c_int
    lib.host_rns_mod.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
    lib.host_rns_mod.restype = ctypes.c_uint32
    return lib


@pytest.fixture(scope="module", params=["bn254", "bls12_381"])
def field(request):
    p = {"bn254": bn.P, "bls12_381": bls12_381_ref.P}[request.param]
    return Field(p, backend="rns", device="cpu")


def host_mul(lib, F, a, b, cols, nt=1):
    """Kernel B2's warp routine over the first `cols` columns of
    row-strided (k_all, >= cols) int32 tensors, 8 nt columns a warp tile."""
    table = pack_constants(F)
    out = torch.empty((F.k_all, cols), dtype=torch.int32)
    rc = lib.host_rns_mul_resident(
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        out.data_ptr(), out.stride(0), cols, F.kA, F.kB, table.ctypes.data, nt,
    )
    assert rc == 0
    return out


def random_residues(F, cols, rng):
    """(k_all, cols) residues, each row below its modulus, with 0 and
    m_i - 1 in the first columns."""
    m = F._m_all.astype(np.int64)[:, None]
    r = (rng.integers(0, 1 << 40, size=(F.k_all, cols)) % m).astype(np.int32)
    r[:, 0], r[:, 1] = 0, m[:, 0] - 1
    return torch.from_numpy(r)


def test_table_layout_matches_header(host_lib, field):
    assert pack_constants(field).shape == (host_lib.host_table_size(field.kA, field.kB),)
    assert (field.kA, field.kB, field.k_all) in ((24, 21, 46), (34, 30, 65))


def test_kernel_header_matches_plain(host_lib, field):
    F = field
    rng = np.random.default_rng(F.kA)
    cols = COLS + 5
    # operands as row slices of wider arrays: the kernel takes a row stride
    a = torch.zeros((F.k_all, cols + 7), dtype=torch.int32)
    b = torch.zeros((F.k_all, cols + 3), dtype=torch.int32)
    a[:, :cols] = random_residues(F, cols, rng)
    b[:, :cols] = random_residues(F, cols, rng)
    b[:, 1] = 0  # (m_i - 1) * 0 and 0 * 0 in the edge columns
    want = F._mul_resident_core(a[:, :cols], b[:, :cols])
    for nt in (1, 2):
        got = host_mul(host_lib, F, a, b, cols, nt)
        assert torch.equal(got, want), nt
    assert ((got >= 0) & (got < torch.from_numpy(F._m_all)[:, None])).all()


def test_kernel_header_integer_identity(host_lib, field):
    """from_resident(B2(to_resident(x), to_resident(y))) = x y M^-1 mod p."""
    F = field
    rng = np.random.default_rng(7)
    xs = [0, 1, F.p - 1] + [int(v) for v in rng.integers(0, 1 << 62, 61)]
    ys = [F.p - 1, F.p - 1, F.p - 1] + [int(v) * F.p // (1 << 62) for v in rng.integers(0, 1 << 62, 61)]
    ra = F.to_resident(F.pack(xs, mont=False))
    rb = F.to_resident(F.pack(ys, mont=False))
    got = host_mul(host_lib, F, ra, rb, len(xs))
    minv = pow(F.M, -1, F.p)
    assert F.unpack(F.from_resident(got), mont=False) == [
        x * y * minv % F.p for x, y in zip(xs, ys)
    ]


def test_rns_mod_is_exact_over_uint32(host_lib, field):
    """The Barrett reduction is exact for any 32-bit input, at every modulus
    of the field, with the factor the table packs."""
    rng = np.random.default_rng(11)
    vs = np.concatenate([
        rng.integers(0, 1 << 32, 200, dtype=np.uint64),
        np.array([0, 1, (1 << 32) - 1, (1 << 31) - 1, 1 << 31], np.uint64),
    ])
    table = pack_constants(field).view(np.uint32)
    for row, m in enumerate(int(x) for x in field._m_all):
        mu = (1 << 32) // m
        assert (int(table[4 * row]), int(table[4 * row + 1])) == (m, mu)
        extra = [k * m + r for k in (1, 1000, (1 << 32) // m - 1) for r in (0, m - 1)]
        picks = vs if row in (0, field.k_all - 1) else vs[:16]
        for v in [int(x) for x in picks] + extra:
            assert host_lib.host_rns_mod(v, m, mu) == v % m, (v, m)


@settings(max_examples=300, deadline=None)
@given(v=st.integers(0, (1 << 32) - 1), m=st.integers(2, 8191))
def test_rns_mod_property(host_lib, v, m):
    """rns_mod(v, m, floor(2^32 / m)) == v mod m over all of uint32 and every
    modulus width up to 2^13."""
    assert host_lib.host_rns_mod(v, m, (1 << 32) // m) == v % m


@pytest.mark.parametrize("layout", ["contiguous", "row_slice"])
def test_tile_matches_reference(host_lib, field, layout):
    """The warp routine with its emulated int8 mma.sync planes equals the
    reference's _mul_resident_core on ragged widths, led by columns of
    m_i - 1 (the largest contraction sums) and 0; as contiguous arrays and as
    row slices of wider ones at an odd column offset."""
    F = field
    J = JaxRns(F.p)
    rng = np.random.default_rng(F.kA + len(layout))
    m = torch.from_numpy(F._m_all)[:, None]
    for cols in (1, 13, 29):
        a = random_residues(F, cols + 2, rng)[:, :cols].contiguous()
        b = random_residues(F, cols + 2, rng)[:, :cols].contiguous()
        a[:, :1] = m - 1
        b[:, :1] = m - 1
        if cols > 2:
            b[:, 2] = (m - 1)[:, 0]
        ref = J._mul_resident_core(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
        if layout == "row_slice":
            wa = torch.zeros((F.k_all, cols + 9), dtype=torch.int32)
            wb = torch.zeros((F.k_all, cols + 5), dtype=torch.int32)
            wa[:, 3:3 + cols], wb[:, 1:1 + cols] = a, b
            a, b = wa[:, 3:3 + cols], wb[:, 1:1 + cols]
        for nt in (1, 2):
            got = host_mul(host_lib, F, a, b, cols, nt)
            assert (got.numpy() == np.asarray(ref)).all(), (cols, nt)
            assert torch.equal(got, F._mul_resident_core(a, b))


def step7_matrix(F):
    """Step 7's matrix as the table packs it: E2's kA rows, then L_mr."""
    return np.concatenate([F._E2, F._L_mr[None, :]])


def test_constant_planes_recombine_to_the_matrices(field):
    """The table's int8 planes give E (depth k holding base-A row a_row(k))
    and step 7's matrix (E2 with the L_mr row) back as lo + (hi << 7), zero
    in the padding, at the offsets the header's layout gives them."""
    F = field
    table = pack_constants(F)
    kA, kB = F.kA, F.kB
    # RnsLayout: the head (a 4-word record per row, c2, MB^-1 mod m_r),
    # padded to 4 words
    head = 4 * F.k_all + kB + 1
    off = -(-head // 4) * 4
    k3 = -(-kA // 32) * 32
    rows = [a_row(k) for k in range(k3)]
    assert sorted(i for i in rows if i < kA) == list(range(kA))
    E3 = np.zeros((kB + 1, k3), np.int64)
    for k, i in enumerate(rows):
        if i < kA:
            E3[:, k] = F._E[:, i]
    for w in (E3, step7_matrix(F)):
        rows, depth = -(-w.shape[0] // 16) * 16, -(-w.shape[1] // 32) * 32
        stride = depth + 16
        words = rows * stride // 4
        planes = table[off:off + 2 * words]
        assert np.array_equal(planes, int8_planes(w, rows, depth, stride))
        lo, hi = planes.view(np.int8).reshape(2, rows, stride)
        assert (lo >= 0).all() and (lo < 128).all() and (hi >= 0).all() and (hi < 64).all()
        whole = lo.astype(np.int64) + (hi.astype(np.int64) << 7)
        assert (whole[: w.shape[0], : w.shape[1]] == w).all()
        assert not whole[w.shape[0]:].any() and not whole[:, w.shape[1]:].any()
        off += 2 * words
    assert off == len(table)


def test_table_head_folds_the_constants(field):
    """The row records of the table's head: each row's modulus and Barrett
    factor, then c1 and m_i - MB mod m_i (base A) or M^-1 and p M^-1 mod
    m_j (base B and m_r), each a residue class the reference's steps use;
    then c2 and MB^-1 mod m_r."""
    F = field
    t = pack_constants(F).view(np.uint32).astype(np.int64)
    kA, kB, K = F.kA, F.kB, F.k_all
    m = F._m_all.astype(np.int64)
    rec = t[: 4 * K].reshape(K, 4)
    assert (rec[:, 0] == m).all() and (rec[:, 1] == (1 << 32) // m).all()
    assert (rec[:kA, 2] == F._c1).all()
    assert ((rec[:kA, 3] + F._MB_modA) % m[:kA] == 0).all()
    assert ((0 < rec[:kA, 3]) & (rec[:kA, 3] <= m[:kA])).all()
    assert (rec[kA:, 2] == F._MinvB).all()
    assert ((rec[kA:, 3] - F._p_modB.astype(np.int64) * F._MinvB) % m[kA:] == 0).all()
    assert (t[4 * K: 4 * K + kB] == F._c2).all() and t[4 * K + kB] == F._MBinv_r


def plane_sum(host_lib, w, x):
    """sum w x through the kernel's split, emulated mma.sync and
    recombination (host_plane_sum)."""
    k = len(w)
    planes = int8_planes(w[None, :].astype(np.int32), 16, 64, 64).view(np.int8)
    lo, hi = (np.ascontiguousarray(p) for p in planes.reshape(2, 16 * 64))
    x = np.ascontiguousarray(x, np.uint32)
    return host_lib.host_plane_sum(lo.ctypes.data, hi.ctypes.data, 64, x.ctypes.data, k)


_EXTREME = st.one_of(st.integers(0, 8191), st.sampled_from([0, 1, 127, 128, 8063, 8190, 8191]))


@settings(max_examples=200, deadline=None)
@given(k=st.integers(1, 34), data=st.data())
def test_plane_split_and_recombination_equal_the_dot_product(host_lib, k, data):
    """ll + ((lh + hl) << 7) + (hh << 14) over the int8 planes, through the
    emulated mma.sync fragments, equals the plain integer dot product for
    entries below 2^13, up to depth 34 (the largest contraction, BLS12-381's
    step 3), extremes included."""
    w = np.array(data.draw(st.lists(_EXTREME, min_size=k, max_size=k)), np.int64)
    x = np.array(data.draw(st.lists(_EXTREME, min_size=k, max_size=k)), np.uint32)
    assert plane_sum(host_lib, w, x) == int((w * x.astype(np.int64)).sum())


def test_plane_sum_at_the_worst_case(host_lib):
    """Every entry 2^13 - 1 at depth 34: the largest sum, 34 (2^13 - 1)^2,
    above 2^31, still exact in uint32."""
    k = 34
    w = np.full(k, 8191, np.int64)
    x = np.full(k, 8191, np.uint32)
    want = k * 8191 * 8191
    assert want > 1 << 31
    assert plane_sum(host_lib, w, x) == want
