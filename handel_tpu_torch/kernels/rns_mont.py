"""ctypes binding of kernel B2, the resident RNS Montgomery multiply
(csrc/rns_mont.cu).

`rns_mul_resident` is the one wrapper: it checks its operands, allocates the
output with torch.empty, launches on torch.cuda.current_stream() and raises
if the launch was refused. `rns_mul_resident.launches` counts launches, and
only launches; `rns_mul_resident.widths` counts the launches by column
count, and `reset()` zeroes both. The library is built and loaded at the
first launch, never at import. `pack_constants` builds the field's constant
table in the order of `handel::RnsLayout` (csrc/rns_mont.cuh), with the int8
planes of the two extension matrices the tensor-core products read.

Columns per tile: a warp of the kernel owns tiles of 8 or 16 columns (one
or two mma n-tiles), so a block of 4 warps covers 32 or 64 at a time
(`TILES`); `tile_for(cols)` is the width rule, and `rns_mul_resident.tile`,
when set, forces one instance (for timing each).
"""

from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch

# base sizes (kA, kB) the kernel is instantiated for: BN254 and BLS12-381
SUPPORTED_BASES = ((24, 21), (34, 30))
# columns a block of 4 warps covers at a time (8 or 16 a warp) the kernel
# is instantiated for, and the width rule's crossover, from device times on
# the H100 (PERF.md, PR 4: 32 is faster at 13,824 columns and below, 64 at
# 2^20): one 8-column n-tile a warp keeps narrow calls spread over every
# SM, two share each warp's constants and fragments on wide ones
TILES = (32, 64)
WIDE_TILE_FROM = 27648


def tile_for(cols: int) -> int:
    """Columns per block for a call of `cols` columns."""
    return 32 if cols < WIDE_TILE_FROM else 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def int8_planes(w: np.ndarray, rows: int, depth: int, stride: int) -> np.ndarray:
    """The low-7-bit and high int8 planes of a matrix of entries < 2^13,
    each zero-padded to `rows` rows of `depth` entries and laid out
    row-major with rows of `stride` bytes (zeros past `depth`), viewed as
    int32 words (little-endian bytes), low plane first."""
    out = []
    for plane in (w & 0x7F, w >> 7):
        padded = np.zeros((rows, stride), np.int8)
        padded[: w.shape[0], : w.shape[1]] = plane
        out.append(padded.reshape(-1).view(np.int32))
    return np.concatenate(out)


def a_row(k: int) -> int:
    """The base-A row at depth k of step 3's contraction (rns_mont.cuh
    `a_row`): lane t of the B fragment holds rows t, t + 4, t + 8, ..."""
    ks, h, t, q = k // 32, (k % 32) // 16, (k % 16) // 4, k % 4
    return 4 * (8 * ks + 4 * h + q) + t


def pack_constants(field) -> np.ndarray:
    """The int32 constant table of an RnsField, laid out as RnsLayout<kA, kB>:
    one 4-word record per row (base-A row i: m_i, floor(2^32 / m_i), c1_i,
    m_i - (MB mod m_i); row kA + j: m_j, floor(2^32 / m_j), M^-1 mod m_j,
    p M^-1 mod m_j), then c2 and MB^-1 mod m_r; zeros to a whole 16 bytes;
    then the int8 planes of step 3's matrix E (kB + 1 rows padded to a
    multiple of 16; depth k holding base-A row a_row(k), kA rows padded to
    a multiple of 32) and of step 7's (E2's kA rows and L_mr as row kA,
    padded to a multiple of 16; kB deep padded to a multiple of 32), each
    row 16 bytes past its depth. Factors of 2^31 and above are stored as
    their int32 bits."""
    kA, kB, K = field.kA, field.kB, field.k_all
    m = field._m_all.astype(np.int64)
    rec = np.zeros((K, 4), np.int64)
    rec[:, 0], rec[:, 1] = m, (1 << 32) // m
    rec[:kA, 2], rec[:kA, 3] = field._c1, m[:kA] - field._MB_modA
    rec[kA:, 2] = field._MinvB
    rec[kA:, 3] = field._p_modB.astype(np.int64) * field._MinvB % m[kA:]
    head = np.concatenate([rec.reshape(-1), field._c2, [field._MBinv_r]]).astype(np.int64)
    head = np.concatenate([head.astype(np.uint32).view(np.int32), np.zeros(-len(head) % 4, np.int32)])
    k3, k7 = _round_up(kA, 32), _round_up(kB, 32)
    E3 = np.zeros((kB + 1, k3), np.int64)
    for k in range(k3):
        if a_row(k) < kA:
            E3[:, k] = field._E[:, a_row(k)]
    E7 = np.concatenate([field._E2, field._L_mr[None, :]])
    parts = [
        head,
        int8_planes(E3, _round_up(kB + 1, 16), k3, k3 + 16),
        int8_planes(E7, _round_up(kA + 1, 16), k7, k7 + 16),
    ]
    return np.ascontiguousarray(np.concatenate(parts))


class RnsMulResidentKernel:
    """out = joint residues of a * b * M^-1 on (k_all, B) int32 residue
    planes on the card (RnsField._mul_resident_core's function).

    `field` is an RnsField: it supplies kA, kB, k_all and its device constant
    table. Operands must be CUDA int32 tensors of shape (k_all, B) on one
    device, with unit column stride (row slices of a wider array are fine),
    each residue below its modulus."""

    def __init__(self):
        self.launches = 0
        self.widths: Counter[int] = Counter()
        self.tile: int | None = None
        self._fn = None

    def reset(self) -> None:
        """Zero the launch count and the width histogram."""
        self.launches = 0
        self.widths.clear()

    def _entry(self):
        if self._fn is None:
            from handel_tpu_torch.kernels.build import load_library

            fn = load_library("rns_mont").handel_rns_mul_resident
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,  # a, lda
                ctypes.c_void_p, ctypes.c_int64,  # b, ldb
                ctypes.c_void_p, ctypes.c_int64,  # out, ldo
                ctypes.c_int64,  # cols
                ctypes.c_int, ctypes.c_int,  # kA, kB
                ctypes.c_void_p,  # constant table
                ctypes.c_int,  # columns per tile
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    @staticmethod
    def _check(name, x, k, dev):
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise ValueError(f"rns_mul_resident: {name} must be a CUDA tensor")
        if x.device != dev:
            raise ValueError(f"rns_mul_resident: {name} on {x.device}, expected {dev}")
        if x.dtype != torch.int32:
            raise ValueError(f"rns_mul_resident: {name} dtype {x.dtype}, expected int32")
        if x.dim() != 2 or x.shape[0] != k:
            raise ValueError(
                f"rns_mul_resident: {name} shape {tuple(x.shape)}, expected ({k}, B)"
            )
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(f"rns_mul_resident: {name} needs unit column stride")

    def __call__(self, field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if (field.kA, field.kB) not in SUPPORTED_BASES:
            raise ValueError(
                f"rns_mul_resident: no instance for bases (kA, kB) = "
                f"{(field.kA, field.kB)}; built for {SUPPORTED_BASES}"
            )
        k = field.k_all
        dev = a.device if isinstance(a, torch.Tensor) else None
        self._check("a", a, k, dev)
        self._check("b", b, k, dev)
        if a.shape != b.shape:
            raise ValueError(
                f"rns_mul_resident: shapes differ {tuple(a.shape)} vs {tuple(b.shape)}"
            )
        if field.device != dev:
            raise ValueError(f"rns_mul_resident: field on {field.device}, operands on {dev}")
        cols = a.shape[1]
        out = torch.empty((k, cols), dtype=torch.int32, device=dev)
        if cols == 0:
            return out
        tile = self.tile if self.tile is not None else tile_for(cols)
        if tile not in TILES:
            raise ValueError(f"rns_mul_resident: tile {tile}; built for {TILES}")
        fn = self._entry()
        table = field.kernel_table()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = fn(
                a.data_ptr(), a.stride(0),
                b.data_ptr(), b.stride(0),
                out.data_ptr(), out.stride(0),
                cols, field.kA, field.kB, table.data_ptr(), tile, stream,
            )
        if rc != 0:
            raise RuntimeError(f"rns_mul_resident launch failed: cudaError {rc}")
        self.launches += 1
        self.widths[cols] += 1
        return out


rns_mul_resident = RnsMulResidentKernel()
