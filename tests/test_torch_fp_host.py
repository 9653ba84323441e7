"""Kernel B1's arithmetic, compiled for the host.

csrc/fp_mont.cuh keeps the arithmetic of the kernel in `__host__ __device__`
functions: each column shared by TPI lanes, lazy carries between lanes,
carry lookahead at the end, with the PTX carry chains' uint64 twins. Here a
host C++ compiler builds that same header behind a small C loop over
columns (`mont_mul_column_lanes`, which steps the TPI lanes one after
another at each shuffle and ballot), called through ctypes, and the result
is held against the port's plain PyTorch version, the reference's kernel
body `Field._mul_cols` run eagerly on the CPU, and Python integers, for
16 and 24 limbs, with 4 lanes a column (the kernel's) and 1. The launch
around it (grid, stream, error check) runs only on the card:
tests/test_torch_cuda.py and chip_smoke.py.
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handel_tpu.ops import bls12_381_ref
from handel_tpu.ops.fp import Field as JaxField
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
                              const uint32_t* p_words, uint32_t n0, int tpi) {
  handel::MontParams prm = {};
  for (int k = 0; k < nlimbs16 / 2; ++k) prm.p[k] = p_words[k];
  prm.n0 = n0;
  for (int64_t j = 0; j < cols; ++j) {
    if (nlimbs16 == 16 && tpi == 4)
      handel::mont_mul_column_lanes<16, 4>(a, lda, b, ldb, out, ldo, j, prm);
    else if (nlimbs16 == 24 && tpi == 4)
      handel::mont_mul_column_lanes<24, 4>(a, lda, b, ldb, out, ldo, j, prm);
    else if (nlimbs16 == 16 && tpi == 2)
      handel::mont_mul_column_lanes<16, 2>(a, lda, b, ldb, out, ldo, j, prm);
    else if (nlimbs16 == 24 && tpi == 2)
      handel::mont_mul_column_lanes<24, 2>(a, lda, b, ldb, out, ldo, j, prm);
    else if (nlimbs16 == 16)
      handel::mont_mul_column<16>(a, lda, b, ldb, out, ldo, j, prm);
    else
      handel::mont_mul_column<24>(a, lda, b, ldb, out, ldo, j, prm);
  }
}

extern "C" uint32_t host_carry_in(uint32_t g, uint32_t p) {
  return handel::lane_carry_in(g, p);
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
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int,
    ]
    lib.host_mont_mul.restype = None
    lib.host_carry_in.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.host_carry_in.restype = ctypes.c_uint32
    return lib


def host_mul(lib, F, a, b, cols, tpi=4):
    """out = mont_mul(a, b) over the first `cols` columns of row-strided
    (nlimbs, >= cols) int32 tensors, through the kernel's header with `tpi`
    lanes a column."""
    out = torch.empty((F.nlimbs, cols), dtype=torch.int32)
    p_words = (ctypes.c_uint32 * len(F.p_words))(*F.p_words)
    lib.host_mont_mul(
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        out.data_ptr(), out.stride(0), cols, F.nlimbs, p_words, F.n0_32, tpi,
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


def edge_operands(F, k, seed):
    """Every pair of 0, 1, p - 1, R mod p, p - 2 and R^2 mod p, then k
    seeded random pairs."""
    p = F.p
    rng = random.Random(seed)
    edges = [0, 1, p - 1, F.mont_r, p - 2, F.mont_r * F.mont_r % p]
    xs = [x for x in edges for _ in edges] + [rng.randrange(p) for _ in range(k)]
    ys = [y for _ in edges for y in edges] + [rng.randrange(p) for _ in range(k)]
    return xs, ys


@pytest.mark.parametrize("tpi", [4, 2, 1])
@pytest.mark.parametrize("p", [bn.P, bls12_381_ref.P], ids=["bn254", "bls12_381"])
def test_lane_emulation_matches_reference(host_lib, p, tpi):
    """The lanes' arithmetic equals the reference's kernel body _mul_cols
    (run eagerly on the CPU, as tests/test_torch_fp.py runs it) on the edge pairs and seeded values."""
    F = Field(p, device="cpu")
    J = JaxField(p, use_pallas=False)
    xs, ys = edge_operands(F, 500, tpi)
    a, b = F.pack(xs, mont=False), F.pack(ys, mont=False)
    got = host_mul(host_lib, F, a, b, len(xs), tpi)
    ref = J._mul_cols(jnp.asarray(a.numpy().astype(np.uint32)),
                               jnp.asarray(b.numpy().astype(np.uint32)))
    assert (got.numpy() == np.asarray(ref).astype(np.int32)).all()
    rinv = pow(F.mont_r, -1, p)
    assert F.unpack(got, mont=False) == [x * y * rinv % p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("p", [bn.P, bls12_381_ref.P], ids=["bn254", "bls12_381"])
def test_lane_carries_cross_every_lane(host_lib, p):
    """Values whose words are all 2^32 - 1 below the top make the final
    carries ripple through every lane: products with results just below p
    and just above a lane boundary."""
    F = Field(p, device="cpu")
    rinv = pow(F.mont_r, -1, p)
    n = F.nlimbs // 2
    # targets: the result itself is a run of all-ones words, or p - 1
    targets = [(1 << (32 * k)) - 1 for k in range(1, n)] + [p - 1, p - 2, 1 << 32]
    targets = [t % p for t in targets]
    # x * y * R^-1 = t with y = R^2 (mont form of R): x = t
    xs = targets
    ys = [F.mont_r * F.mont_r % p] * len(xs)
    a, b = F.pack(xs, mont=False), F.pack(ys, mont=False)
    for tpi in (4, 2, 1):
        got = host_mul(host_lib, F, a, b, len(xs), tpi)
        assert F.unpack(got, mont=False) == [x * y * rinv % p for x, y in zip(xs, ys)]
        assert torch.equal(got, F._mul_plain(a, b))


def test_carry_lookahead_is_a_ripple_adder(host_lib):
    """lane_carry_in(g, p) gives, for every generate/propagate pattern over
    four lanes, the carries a lane-by-lane ripple gives."""
    for g in range(16):
        for pr in range(16):
            if g & pr:
                continue  # a lane that generates cannot also propagate
            c, want = 0, 0
            for lane in range(5):
                want |= c << lane
                if lane < 4:
                    c = 1 if (g >> lane) & 1 else (c if (pr >> lane) & 1 else 0)
            assert host_lib.host_carry_in(g, pr) & 0x1F == want, (g, pr)
