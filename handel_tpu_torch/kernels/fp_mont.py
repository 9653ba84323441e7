"""ctypes binding of the Montgomery-multiply kernel (csrc/fp_mont.cu).

`mont_mul` is the one wrapper: it checks its operands, allocates the output
with torch.empty, launches on torch.cuda.current_stream() and raises if the
launch was refused. `mont_mul.launches` counts launches, and only launches:
a run can read it to show that its path went through the kernel;
`mont_mul.widths` counts the launches by column count, and `reset()` zeroes
both. The library is built and loaded at the first launch, never at import.

Lanes per column: the kernel shares each column among TPI = 2 or 4 lanes
of a warp for narrow calls, and runs one lane a column for wide ones
(csrc/fp_mont.cu). `lanes_for(cols)` is the width rule that picks the
instance; `mont_mul.tpi`, when set, forces one (for timing each).
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

# lanes per column the kernel is instantiated for
TPI_CHOICES = (1, 2, 4)
# the width rule, from device times on the H100 (PERF.md, PR 4): 4 lanes a
# column below 4,608 columns, 2 below 27,648, one lane from there on (where
# the one-lane routine reads at the byte-bound end as the parent did)
FOUR_LANES_BELOW = 4608
ONE_LANE_FROM = 27648


def lanes_for(cols: int) -> int:
    """Lanes per column for a call of `cols` columns."""
    if cols < FOUR_LANES_BELOW:
        return 4
    return 2 if cols < ONE_LANE_FROM else 1


class MontMulKernel:
    """out = a * b * R^-1 mod p on (nlimbs, B) int32 limb tensors on the card.

    `field` supplies nlimbs, the modulus as 32-bit words (`p_words`) and
    n0 = -p^-1 mod 2^32 (`n0_32`); see handel_tpu_torch/ops/fp.py Field.
    Operands must be CUDA int32 tensors of shape (nlimbs, B) on one device,
    with unit column stride (row slices of a wider array are fine)."""

    def __init__(self):
        self.launches = 0
        self.widths: Counter[int] = Counter()
        self.tpi: int | None = None
        self._fn = None

    def reset(self) -> None:
        """Zero the launch count and the width histogram."""
        self.launches = 0
        self.widths.clear()

    def _entry(self):
        if self._fn is None:
            from handel_tpu_torch.kernels.build import load_library

            fn = load_library("fp_mont").handel_mont_mul
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,  # a, lda
                ctypes.c_void_p, ctypes.c_int64,  # b, ldb
                ctypes.c_void_p, ctypes.c_int64,  # out, ldo
                ctypes.c_int64, ctypes.c_int,  # cols, nlimbs16
                ctypes.c_void_p, ctypes.c_uint32,  # p_words, n0
                ctypes.c_int,  # lanes per column
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    @staticmethod
    def _check(name, x, n, dev):
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise ValueError(f"mont_mul: {name} must be a CUDA tensor")
        if x.device != dev:
            raise ValueError(f"mont_mul: {name} on {x.device}, expected {dev}")
        if x.dtype != torch.int32:
            raise ValueError(f"mont_mul: {name} dtype {x.dtype}, expected int32")
        if x.dim() != 2 or x.shape[0] != n:
            raise ValueError(
                f"mont_mul: {name} shape {tuple(x.shape)}, expected ({n}, B)"
            )
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(f"mont_mul: {name} needs unit column stride")

    def __call__(self, field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        n = field.nlimbs
        dev = a.device if isinstance(a, torch.Tensor) else None
        self._check("a", a, n, dev)
        self._check("b", b, n, dev)
        if a.shape != b.shape:
            raise ValueError(
                f"mont_mul: shapes differ {tuple(a.shape)} vs {tuple(b.shape)}"
            )
        cols = a.shape[1]
        out = torch.empty((n, cols), dtype=torch.int32, device=dev)
        if cols == 0:
            return out
        tpi = self.tpi if self.tpi is not None else lanes_for(cols)
        if tpi not in TPI_CHOICES:
            raise ValueError(f"mont_mul: {tpi} lanes per column; built for {TPI_CHOICES}")
        fn = self._entry()
        p_words = (ctypes.c_uint32 * len(field.p_words))(*field.p_words)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = fn(
                a.data_ptr(), a.stride(0),
                b.data_ptr(), b.stride(0),
                out.data_ptr(), out.stride(0),
                cols, n, p_words, field.n0_32, tpi, stream,
            )
        if rc != 0:
            raise RuntimeError(f"mont_mul launch failed: cudaError {rc}")
        self.launches += 1
        self.widths[cols] += 1
        return out


mont_mul = MontMulKernel()
