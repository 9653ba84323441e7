"""ctypes binding of kernels B3a and B3b, the kernel lab's Montgomery
formulations (csrc/lab_mont.cu).

`lab_cios_fullwidth` (B3a) and `lab_separated` (B3b) are the two wrappers.
Each checks its operands, allocates the output with torch.empty, launches on
torch.cuda.current_stream() and raises if the launch was refused; its
`launches` counts launches, and only launches. Under CUDA graph capture a
call records its launch into the graph and counts once there; replays of
the graph do not count (ops/fp.py `ChainTally` counts those). The library
is built and loaded at the first launch, never at import.

B3b multiplies by its two constants, p' and p, on the tensor cores; their
Toeplitz byte matrices, cut into the lanes' mma.sync A fragments, are the
field's fragment table (`separated_fragments`, laid out as csrc/lab_mont.cuh
`SepLayout` reads it). A LabField made on a card (scripts/fp_kernel_lab.py)
holds the table there as `frags`, built before any call, so that no first
call lands inside a graph capture.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# warps per block the kernels are instantiated for (the lab's instance race;
# a warp covers 32 columns)
WARPS = (1, 2, 4)
DEFAULT_WARPS = 1
SUPPORTED_LIMBS = (16, 24)


def tile_live(n: int, mt: int, ks: int) -> bool:
    """Whether row tile mt, depth step ks of a constant product of n 16-bit
    digits has a nonzero entry (lab_mont.cuh `sep_tile_live`)."""
    k_hi = min(32 * ks + 31, 2 * n - 1)
    return 32 * ks < 2 * n and 16 * mt + 15 >= 32 * ks and 16 * mt - k_hi < 2 * n


def _const_bytes(limbs) -> list[int]:
    return [(d >> s) & 0xFF for d in limbs for s in (0, 8)]


def separated_fragments(n: int, p_limbs, pprime_limbs) -> np.ndarray:
    """B3b's fragment table for a field of n 16-bit digits: for product 1
    (tl p' mod R: 2n byte positions, 2n/16 row tiles) then product 2 (m p:
    4n positions), every live (row tile mt, depth step ks) in order, 32
    lanes of 4 int32 words; lane l (g = l // 4, t = l % 4) word r holds the
    entries of row position 16 mt + 2 g + (r & 1) at depths
    32 ks + 16 (r >> 1) + 4 t .. + 3 (one byte each, depth order), the entry
    at (pos, k) being byte pos - k of the constant where 0 <= pos - k < 2n
    and k < 2n, else 0."""
    ks_n = (2 * n + 31) // 32
    tiles = []
    for consts, mts in ((pprime_limbs, 2 * n // 16), (p_limbs, 4 * n // 16)):
        cb = _const_bytes(consts)
        for mt in range(mts):
            for ks in range(ks_n):
                if not tile_live(n, mt, ks):
                    continue
                tile = np.zeros((32, 4), np.uint32)
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for r in range(4):
                        pos = 16 * mt + 2 * g + (r & 1)
                        k0 = 32 * ks + 16 * (r >> 1) + 4 * t
                        word = 0
                        for j in range(4):
                            k = k0 + j
                            if k < 2 * n and 0 <= pos - k < 2 * n:
                                word |= cb[pos - k] << (8 * j)
                        tile[lane, r] = word
                tiles.append(tile)
    return np.ascontiguousarray(np.concatenate(tiles).reshape(-1).view(np.int32))


class LabMontKernel:
    """One lab formulation on (nlimbs, B) int32 digit tensors on the card.

    `lab` is a LabField (scripts/fp_kernel_lab.py) on the operands' card:
    it supplies nlimbs, p's 16-bit digits, n0 and (B3b) the fragment table
    `frags`. Operands must be CUDA int32 tensors of shape (nlimbs, B) on one
    device, with unit column stride (row slices of a wider array are fine),
    each digit < 2^16."""

    def __init__(self, name: str, form: int):
        self.name = name
        self.form = form
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            from handel_tpu_torch.kernels.build import load_library

            fn = load_library("lab_mont").handel_lab_mont_mul
            fn.argtypes = [
                ctypes.c_int,  # form
                ctypes.c_void_p, ctypes.c_int64,  # a, lda
                ctypes.c_void_p, ctypes.c_int64,  # b, ldb
                ctypes.c_void_p, ctypes.c_int64,  # out, ldo
                ctypes.c_int64, ctypes.c_int,  # cols, nlimbs16
                ctypes.c_void_p, ctypes.c_uint32,  # p digits, n0
                ctypes.c_void_p, ctypes.c_int,  # fragment table, warps
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _check(self, what, x, n, dev):
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise ValueError(f"{self.name}: {what} must be a CUDA tensor")
        if x.device != dev:
            raise ValueError(f"{self.name}: {what} on {x.device}, expected {dev}")
        if x.dtype != torch.int32:
            raise ValueError(f"{self.name}: {what} dtype {x.dtype}, expected int32")
        if x.dim() != 2 or x.shape[0] != n:
            raise ValueError(
                f"{self.name}: {what} shape {tuple(x.shape)}, expected ({n}, B)"
            )
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(f"{self.name}: {what} needs unit column stride")

    def __call__(self, lab, a: torch.Tensor, b: torch.Tensor,
                 warps: int = DEFAULT_WARPS) -> torch.Tensor:
        n = lab.n
        if n not in SUPPORTED_LIMBS:
            raise ValueError(f"{self.name}: no instance for {n} limbs; built for {SUPPORTED_LIMBS}")
        if warps not in WARPS:
            raise ValueError(f"{self.name}: warps={warps}, built for {WARPS}")
        dev = a.device if isinstance(a, torch.Tensor) else None
        self._check("a", a, n, dev)
        self._check("b", b, n, dev)
        if a.shape != b.shape:
            raise ValueError(
                f"{self.name}: shapes differ {tuple(a.shape)} vs {tuple(b.shape)}"
            )
        if lab.F.device != dev:
            raise ValueError(f"{self.name}: field on {lab.F.device}, operands on {dev}")
        cols = a.shape[1]
        out = torch.empty((n, cols), dtype=torch.int32, device=dev)
        if cols == 0:
            return out
        fn = self._entry()
        frags = lab.frags.data_ptr() if self.form == 1 else None
        p = (ctypes.c_uint32 * n)(*lab.p_limbs)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = fn(
                self.form,
                a.data_ptr(), a.stride(0),
                b.data_ptr(), b.stride(0),
                out.data_ptr(), out.stride(0),
                cols, n, p, lab.n0, frags, warps, stream,
            )
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {rc}")
        self.launches += 1
        return out


lab_cios_fullwidth = LabMontKernel("lab_cios_fullwidth", 0)
lab_separated = LabMontKernel("lab_separated", 1)
