"""The CUDA kernel's arithmetic, compiled for the host.

csrc/fp_mont.cuh keeps the per-column Montgomery routine of the kernel in
`__host__ __device__` functions. Here a host C++ compiler builds that same
header behind a small C loop over columns, called through ctypes, and the
result is held against the port's plain PyTorch version (and Python
integers) on 4096 seeded columns plus edge columns, for 16 and 24 limbs.
The launch around it (grid, stream, error check) runs only on the card:
tests/test_torch_cuda.py and chip_smoke.py.
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

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "handel_tpu_torch" / "csrc"
COLS = 4096

SHIM = r"""
#include "fp_mont.cuh"

extern "C" void host_mont_mul(const int32_t* a, int64_t lda, const int32_t* b,
                              int64_t ldb, int32_t* out, int64_t ldo,
                              int64_t cols, int nlimbs16,
                              const uint32_t* p_words, uint32_t n0) {
  handel::MontParams prm = {};
  for (int k = 0; k < nlimbs16 / 2; ++k) prm.p[k] = p_words[k];
  prm.n0 = n0;
  for (int64_t j = 0; j < cols; ++j) {
    if (nlimbs16 == 16)
      handel::mont_mul_column<16>(a, lda, b, ldb, out, ldo, j, prm);
    else
      handel::mont_mul_column<24>(a, lda, b, ldb, out, ldo, j, prm);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the kernel header cannot be built for the host")
    d = tmp_path_factory.mktemp("fp_mont_host")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "libfp_mont_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{CSRC}",
         "-o", str(so), str(d / "shim.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.host_mont_mul.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_uint32,
    ]
    lib.host_mont_mul.restype = None
    return lib


def host_mul(lib, F, a, b, cols):
    """out = mont_mul(a, b) over the first `cols` columns of row-strided
    (nlimbs, >= cols) int32 tensors, through the kernel's header."""
    out = torch.empty((F.nlimbs, cols), dtype=torch.int32)
    p_words = (ctypes.c_uint32 * len(F.p_words))(*F.p_words)
    lib.host_mont_mul(
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        out.data_ptr(), out.stride(0), cols, F.nlimbs, p_words, F.n0_32,
    )
    return out


@pytest.mark.parametrize("p", [bn.P, bls12_381_ref.P], ids=["bn254", "bls12_381"])
def test_kernel_header_matches_plain(host_lib, p):
    F = Field(p, device="cpu")
    rng = random.Random(p % 1000)
    r = F.mont_r
    edges = [0, 1, p - 1, r, p - 2]
    xs = [x for x in edges for _ in edges] + [rng.randrange(p) for _ in range(COLS)]
    ys = [y for _ in edges for y in edges] + [rng.randrange(p) for _ in range(COLS)]
    cols = len(xs)
    # operands as row slices of wider arrays: the kernel takes a row stride
    a = torch.zeros((F.nlimbs, cols + 7), dtype=torch.int32)
    a[:, :cols] = F.pack(xs, mont=False)
    b = torch.zeros((F.nlimbs, cols + 3), dtype=torch.int32)
    b[:, :cols] = F.pack(ys, mont=False)
    got = host_mul(host_lib, F, a, b, cols)
    assert torch.equal(got, F._mul_plain(a[:, :cols], b[:, :cols]))
    rinv = pow(r, -1, p)
    want = [x * y * rinv % p for x, y in zip(xs, ys)]
    assert F.unpack(got, mont=False) == want
    assert np.all((got.numpy() >= 0) & (got.numpy() < 1 << 16))
