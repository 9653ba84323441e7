"""Kernels B3a and B3b's arithmetic, compiled for the host.

csrc/lab_mont.cuh keeps the per-column routines of the kernel lab's two
Hopper kernels in `__host__ __device__` functions. Here a host C++ compiler
builds that same header behind a small C loop over columns, called through
ctypes, and both routines are held against the port's plain lab bodies and
Python integers on 4096 seeded canonical columns plus edge columns, and
against the plain bodies on raw 16-bit digits, for 16 and 24 limbs. The
launch around them (grid, block sizes, stream, error check) runs only on
the card: tests/test_torch_cuda.py and chip_smoke.py.
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from handel_tpu.ops import bls12_381_ref
from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops.fp import Field
from handel_tpu_torch.scripts.fp_kernel_lab import LabField

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "handel_tpu_torch" / "csrc"
COLS = 4096
FORMS = {"cios_fullwidth": 0, "separated": 1}

SHIM = r"""
#include "lab_mont.cuh"

template <int N>
static void run(int form, const int32_t* a, int64_t lda, const int32_t* b,
                int64_t ldb, int32_t* out, int64_t ldo, int64_t cols,
                const handel::LabParams& prm) {
  for (int64_t j = 0; j < cols; ++j) {
    if (form == 0)
      handel::lab_mont_column<N, 0>(a, lda, b, ldb, out, ldo, j, prm);
    else
      handel::lab_mont_column<N, 1>(a, lda, b, ldb, out, ldo, j, prm);
  }
}

extern "C" void host_lab_mont_mul(int form, const int32_t* a, int64_t lda,
                                  const int32_t* b, int64_t ldb, int32_t* out,
                                  int64_t ldo, int64_t cols, int nlimbs16,
                                  const uint32_t* p, const uint32_t* pprime,
                                  uint32_t n0) {
  handel::LabParams prm = {};
  for (int k = 0; k < nlimbs16; ++k) {
    prm.p[k] = p[k];
    prm.pprime[k] = pprime[k];
  }
  prm.n0 = n0;
  if (nlimbs16 == 16)
    run<16>(form, a, lda, b, ldb, out, ldo, cols, prm);
  else
    run<24>(form, a, lda, b, ldb, out, ldo, cols, prm);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the kernel header cannot be built for the host")
    d = tmp_path_factory.mktemp("lab_mont_host")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "liblab_mont_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{CSRC}",
         "-o", str(so), str(d / "shim.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.host_lab_mont_mul.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
    ]
    lib.host_lab_mont_mul.restype = None
    return lib


def host_mul(lib, lab, form, a, b, cols):
    """One formulation over the first `cols` columns of row-strided
    (n, >= cols) int32 tensors, through the kernel header."""
    out = torch.empty((lab.n, cols), dtype=torch.int32)
    p = (ctypes.c_uint32 * lab.n)(*lab.p_limbs)
    pprime = (ctypes.c_uint32 * lab.n)(*lab.pprime_limbs)
    lib.host_lab_mont_mul(
        FORMS[form], a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        out.data_ptr(), out.stride(0), cols, lab.n, p, pprime, lab.n0,
    )
    return out


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("p", [bn.P, bls12_381_ref.P], ids=["bn254", "bls12_381"])
def test_lab_header_matches_plain_and_integers(host_lib, p, form):
    F = Field(p, device="cpu")
    lab = LabField(F)
    rng = random.Random(p % 1000 + len(form))
    edges = [0, 1, p - 1, F.mont_r, p - 2]
    xs = [x for x in edges for _ in edges] + [rng.randrange(p) for _ in range(COLS)]
    ys = [y for _ in edges for y in edges] + [rng.randrange(p) for _ in range(COLS)]
    cols = len(xs)
    # operands as row slices of wider arrays: the kernel takes a row stride
    a = torch.zeros((F.nlimbs, cols + 7), dtype=torch.int32)
    a[:, :cols] = F.pack(xs, mont=False)
    b = torch.zeros((F.nlimbs, cols + 3), dtype=torch.int32)
    b[:, :cols] = F.pack(ys, mont=False)
    got = host_mul(host_lib, lab, form, a, b, cols)
    plain = lab.body(form)(a[:, :cols], b[:, :cols])
    assert torch.equal(got, plain)
    assert torch.equal(got, F._mul_plain(a[:, :cols], b[:, :cols]))
    rinv = pow(F.mont_r, -1, p)
    assert F.unpack(got, mont=False) == [x * y * rinv % p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("p", [bn.P, bls12_381_ref.P], ids=["bn254", "bls12_381"])
def test_lab_header_matches_plain_on_raw_digits(host_lib, p, form):
    """Raw 16-bit digits (values up to R - 1), as the lab races them: the
    quotient truncated mod R, the same bits as the plain body."""
    F = Field(p, device="cpu")
    lab = LabField(F)
    rng = np.random.default_rng(len(form))
    a = torch.from_numpy(rng.integers(0, 1 << 16, (F.nlimbs, COLS)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 1 << 16, (F.nlimbs, COLS)).astype(np.int32))
    a[:, 0] = b[:, 1] = 0xFFFF  # R - 1
    got = host_mul(host_lib, lab, form, a, b, COLS)
    assert torch.equal(got, lab.body(form)(a, b))
    assert bool(((got >= 0) & (got < 1 << 16)).all())
