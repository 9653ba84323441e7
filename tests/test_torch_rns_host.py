"""Kernel B2's arithmetic, compiled for the host.

csrc/rns_mont.cuh keeps the per-column resident RNS Montgomery routine of
the kernel in `__host__ __device__` functions. Here a host C++ compiler
builds that same header behind a small C loop over columns, called through
ctypes with the constant table that kernels/rns_mont.py packs for the card,
and the result is held against the port's plain version
(`RnsField._mul_resident_core`) bit for bit, at both base sizes (BN254:
kA, kB = 24, 21; BLS12-381: 34, 30): seeded random residues, edge columns
(0 and m_i - 1), and the integer identity x y M^-1 mod p through the
resident conversions. The launch around it runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from handel_tpu.ops import bls12_381_ref
from handel_tpu_torch.kernels.rns_mont import pack_constants
from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops.fp import Field

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "handel_tpu_torch" / "csrc"
COLS = 2048

SHIM = r"""
#include "rns_mont.cuh"

extern "C" int host_rns_mul_resident(const int32_t* a, int64_t lda,
                                     const int32_t* b, int64_t ldb,
                                     int32_t* out, int64_t ldo, int64_t cols,
                                     int ka, int kb, const int32_t* consts) {
  for (int64_t j = 0; j < cols; ++j) {
    if (ka == 24 && kb == 21)
      handel::rns_mul_resident_column<24, 21>(a, lda, b, ldb, out, ldo, j, consts);
    else if (ka == 34 && kb == 30)
      handel::rns_mul_resident_column<34, 30>(a, lda, b, ldb, out, ldo, j, consts);
    else
      return 1;
  }
  return 0;
}

extern "C" int host_table_size(int ka, int kb) {
  if (ka == 24 && kb == 21) return handel::RnsLayout<24, 21>::size;
  if (ka == 34 && kb == 30) return handel::RnsLayout<34, 30>::size;
  return -1;
}

extern "C" uint32_t host_rns_mod(uint32_t v, uint32_t m, float minv) {
  return handel::rns_mod(v, m, minv);
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
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.host_rns_mul_resident.restype = ctypes.c_int
    lib.host_table_size.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.host_table_size.restype = ctypes.c_int
    lib.host_rns_mod.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float]
    lib.host_rns_mod.restype = ctypes.c_uint32
    return lib


@pytest.fixture(scope="module", params=["bn254", "bls12_381"])
def field(request):
    p = {"bn254": bn.P, "bls12_381": bls12_381_ref.P}[request.param]
    return Field(p, backend="rns", device="cpu")


def host_mul(lib, F, a, b, cols):
    """Kernel B2's column routine over the first `cols` columns of
    row-strided (k_all, >= cols) int32 tensors."""
    table = pack_constants(F)
    out = torch.empty((F.k_all, cols), dtype=torch.int32)
    rc = lib.host_rns_mul_resident(
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        out.data_ptr(), out.stride(0), cols, F.kA, F.kB, table.ctypes.data,
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
    got = host_mul(host_lib, F, a, b, cols)
    assert torch.equal(got, F._mul_resident_core(a[:, :cols], b[:, :cols]))
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
    """The float-estimate reduction is exact for any 32-bit input."""
    rng = np.random.default_rng(11)
    vs = np.concatenate([
        rng.integers(0, 1 << 32, 200, dtype=np.uint64),
        np.array([0, 1, (1 << 32) - 1, (1 << 31) - 1, 1 << 31], np.uint64),
    ])
    for m in (int(field._m_all.min()), int(field._m_all.max()), field.mr):
        minv = float(np.float32(1.0 / m))
        extra = [k * m + r for k in (1, 1000, (1 << 32) // m - 1) for r in (0, m - 1)]
        for v in [int(x) for x in vs] + extra:
            assert host_lib.host_rns_mod(v, m, minv) == v % m, (v, m)
