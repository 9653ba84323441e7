"""Kernels B3a and B3b's arithmetic, compiled for the host.

csrc/lab_mont.cuh keeps the arithmetic of the kernel lab's two Hopper
kernels in `__host__ __device__` functions, each card intrinsic (__dp4a,
__byte_perm, __funnelshift_r) with its host twin, and B3b's warp (its lanes
stepped one after another between the exchanges, each tensor-core mma.sync
by `mma_u8_host` on the same fragment registers) in
`lab_separated_warp_host`. Here a host C++ compiler builds that same header
behind a small C loop over the kernels' blocks and warps, called through
ctypes, and both formulations are held against the port's plain lab bodies
and Python integers on 4096 seeded canonical columns plus edge columns, and
against the plain bodies on raw 16-bit digits, for 16 and 24 limbs, at
every instance (warps per block); B3b's fragment table is held against the
constants p and p' it encodes. The launch around them (grid, stream, shared
memory, error check) runs only on the card: tests/test_torch_cuda.py and
chip_smoke.py.
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
from handel_tpu_torch.kernels.lab_mont import DEFAULT_WARPS, WARPS, separated_fragments, tile_live
from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops.fp import Field
from handel_tpu_torch.scripts.fp_kernel_lab import LabField

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "handel_tpu_torch" / "csrc"
COLS = 4096
FORMS = {"cios_fullwidth": 0, "separated": 1}

SHIM = r"""
#include "lab_mont.cuh"

// the kernels' grid: block blk, warp w covers columns (blk warps + w) 32 ..
template <int N>
static void run(int form, const int32_t* a, int64_t lda, const int32_t* b,
                int64_t ldb, int32_t* out, int64_t ldo, int64_t cols,
                const handel::LabParams& prm, const uint32_t* frags, int warps) {
  const int64_t blocks = (cols + 32 * warps - 1) / (32 * warps);
  for (int64_t blk = 0; blk < blocks; ++blk)
    for (int w = 0; w < warps; ++w) {
      const int64_t col0 = (blk * warps + w) * 32;
      if (col0 >= cols) continue;
      if (form == 1) {
        handel::lab_separated_warp_host<N>(a, lda, b, ldb, out, ldo, col0, cols, frags, prm);
        continue;
      }
      for (int64_t j = col0; j < col0 + 32 && j < cols; ++j) {
        uint32_t x[N], y[N], r[N];
        handel::lab_load_column<N>(a, lda, j, x);
        handel::lab_load_column<N>(b, ldb, j, y);
        handel::lab_cios_fullwidth<N>(x, y, prm, r);
        handel::lab_store_column<N>(out, ldo, j, r);
      }
    }
}

extern "C" void host_lab_mont_mul(int form, const int32_t* a, int64_t lda,
                                  const int32_t* b, int64_t ldb, int32_t* out,
                                  int64_t ldo, int64_t cols, int nlimbs16,
                                  const uint32_t* p, uint32_t n0,
                                  const uint32_t* frags, int warps) {
  const handel::LabParams prm = handel::lab_params(nlimbs16, p, n0);
  if (nlimbs16 == 16)
    run<16>(form, a, lda, b, ldb, out, ldo, cols, prm, frags, warps);
  else
    run<24>(form, a, lda, b, ldb, out, ldo, cols, prm, frags, warps);
}

// B3b's fragment tiles for a field of nlimbs16 digits
extern "C" int host_lab_tiles(int nlimbs16) {
  return handel::sep_tile_index(nlimbs16, 3, 0, 0);
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
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.host_lab_mont_mul.restype = None
    lib.host_lab_tiles.argtypes = [ctypes.c_int]
    lib.host_lab_tiles.restype = ctypes.c_int
    return lib


def host_mul(lib, lab, form, a, b, cols, warps=DEFAULT_WARPS):
    """One formulation over the first `cols` columns of row-strided
    (n, >= cols) int32 tensors, through the kernel header, on the grid of
    the instance with `warps` warps a block."""
    out = torch.empty((lab.n, cols), dtype=torch.int32)
    p = (ctypes.c_uint32 * lab.n)(*lab.p_limbs)
    frags = np.ascontiguousarray(separated_fragments(lab.n, lab.p_limbs, lab.pprime_limbs))
    lib.host_lab_mont_mul(
        FORMS[form], a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        out.data_ptr(), out.stride(0), cols, lab.n, p, lab.n0,
        frags.ctypes.data, warps,
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


@pytest.mark.parametrize("warps", WARPS)
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("p", [bn.P, bls12_381_ref.P], ids=["bn254", "bls12_381"])
def test_lab_header_instances_match_plain(host_lib, p, form, warps):
    """Every instance's grid at widths ragged around its block and warp
    tile, on canonical columns (against the plain body and integers) and on
    raw 16-bit digits (against the plain body)."""
    F = Field(p, device="cpu")
    lab = LabField(F)
    rng = np.random.default_rng(warps + 10 * len(form))
    cols = 32 * warps * 2 + 31
    xs = [int(v) for v in rng.integers(0, 1 << 62, cols)]
    xs = [(x * x + 7) % p for x in xs]
    ys = xs[::-1]
    a, b = F.pack(xs, mont=False), F.pack(ys, mont=False)
    for width in (1, 7, 33, 32 * warps - 1, 32 * warps + 1, cols):
        got = host_mul(host_lib, lab, form, a, b, width, warps)
        assert torch.equal(got, lab.body(form)(a[:, :width], b[:, :width])), width
    rinv = pow(F.mont_r, -1, p)
    assert F.unpack(got, mont=False) == [x * y * rinv % p for x, y in zip(xs, ys)]
    ra = torch.from_numpy(rng.integers(0, 1 << 16, (F.nlimbs, cols)).astype(np.int32))
    rb = torch.from_numpy(rng.integers(0, 1 << 16, (F.nlimbs, cols)).astype(np.int32))
    ra[:, 3] = rb[:, 3] = 0xFFFF
    assert torch.equal(host_mul(host_lib, lab, form, ra, rb, cols, warps), lab.body(form)(ra, rb))


@pytest.mark.parametrize("p", [bn.P, bls12_381_ref.P], ids=["bn254", "bls12_381"])
def test_fragment_table_reproduces_the_constants(host_lib, p):
    """B3b's fragment table, read back through the mma.sync A-fragment
    layout, is the Toeplitz byte matrix of p' (rows: byte positions below
    2n) and of p (below 4n): against the bytes of x it gives x p' mod R and
    x p; its size is the header's tile count."""
    F = Field(p, device="cpu")
    lab = LabField(F)
    n = lab.n
    table = separated_fragments(n, lab.p_limbs, lab.pprime_limbs).view(np.uint32)
    assert table.size == 128 * host_lib.host_lab_tiles(n)
    mats = [np.zeros((2 * n, 64), np.int64), np.zeros((4 * n, 64), np.int64)]
    seen = [np.zeros_like(m, dtype=bool) for m in mats]
    tile = 0
    for prod, mat in enumerate(mats):
        for mt in range(mat.shape[0] // 16):
            for ks in range((2 * n + 31) // 32):
                if not tile_live(n, mt, ks):
                    continue
                words = table[128 * tile: 128 * (tile + 1)].reshape(32, 4)
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for r in range(4):
                        pos = 16 * mt + 2 * g + (r & 1)
                        for j in range(4):
                            k = 32 * ks + 16 * (r >> 1) + 4 * t + j
                            mat[pos, k] = (int(words[lane, r]) >> (8 * j)) & 0xFF
                            seen[prod][pos, k] = True
                tile += 1
    assert tile * 128 == table.size
    R = 1 << (16 * n)
    rng = random.Random(n)
    for x in [1, R - 1] + [rng.randrange(R) for _ in range(8)]:
        xb = [(x >> (8 * k)) & 0xFF for k in range(2 * n)] + [0] * (64 - 2 * n)
        for mat, c, mod in ((mats[0], lab.pprime, R), (mats[1], p, None)):
            sums = [sum(int(mat[pos, k]) * xb[k] for k in range(64)) for pos in range(mat.shape[0])]
            v = sum(s << (8 * pos) for pos, s in enumerate(sums))
            assert (v % mod == x * c % mod) if mod else v == x * c
    # every nonzero entry of the full Toeplitz matrices lies in a stored tile
    for prod, c in ((0, lab.pprime), (1, p)):
        cb = [(c >> (8 * k)) & 0xFF for k in range(2 * n)]
        for pos in range(mats[prod].shape[0]):
            for k in range(2 * n):
                if 0 <= pos - k < 2 * n and cb[pos - k]:
                    assert seen[prod][pos, k] and mats[prod][pos, k] == cb[pos - k]
