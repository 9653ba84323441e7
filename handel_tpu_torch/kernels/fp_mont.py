"""ctypes binding of the Montgomery-multiply kernel (csrc/fp_mont.cu).

`mont_mul` is the one wrapper: it checks its operands, allocates the output
with torch.empty, launches on torch.cuda.current_stream() and raises if the
launch was refused. `mont_mul.launches` counts launches, and only launches:
a run can read it to show that its path went through the kernel;
`mont_mul.widths` counts the launches by column count and `mont_mul.rows`
by limb count (16 for BN254, 24 for BLS12-381), and `reset()` zeroes all
three. `with mont_mul.tally() as widths:` counts, by width, only the
launches that the calling thread makes inside the block, so a window on
one thread reads exactly its own launches while other threads launch too
(a registry staging beside a service's dispatches). The library is built
and loaded at the first launch, never at import.

Lanes per column: the kernel shares each column among TPI = 2 or 4 lanes
of a warp for narrow calls, and runs one lane a column for wide ones
(csrc/fp_mont.cu). `lanes_for(cols)` is the width rule that picks the
instance; `mont_mul.tpi`, when set, forces one (for timing each).
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter
from contextlib import contextmanager

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
        # launches by row count (limbs): which curve family's field ran
        self.rows: Counter[int] = Counter()
        self.tpi: int | None = None
        self._fn = None
        # open `tally()` windows: thread id -> that thread's width counter
        self._tallies: dict[int, Counter[int]] = {}
        # launches come from several threads (a service's worker thread
        # verifies while the event loop combines): the library load and
        # each count happen under the lock
        self._lock = threading.Lock()

    def reset(self) -> None:
        """Zero the launch count and the width and row histograms."""
        with self._lock:
            self.launches = 0
            self.widths.clear()
            self.rows.clear()

    def _count(self, cols: int, rows: int) -> None:
        with self._lock:
            self.launches += 1
            self.widths[cols] += 1
            self.rows[rows] += 1
            tally = self._tallies.get(threading.get_ident())
            if tally is not None:
                tally[cols] += 1

    @contextmanager
    def tally(self):
        """Yield a Counter of this thread's launches by width inside the
        block. Windows do not nest on one thread."""
        me = threading.get_ident()
        widths: Counter[int] = Counter()
        with self._lock:
            if me in self._tallies:
                raise RuntimeError("mont_mul.tally() windows do not nest")
            self._tallies[me] = widths
        try:
            yield widths
        finally:
            with self._lock:
                del self._tallies[me]

    def _entry(self):
        with self._lock:
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
        self._count(cols, n)
        return out


mont_mul = MontMulKernel()
