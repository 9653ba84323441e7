"""ctypes binding of kernels B3a and B3b, the kernel lab's Montgomery
formulations (csrc/lab_mont.cu).

`lab_cios_fullwidth` (B3a) and `lab_separated` (B3b) are the two wrappers.
Each checks its operands, allocates the output with torch.empty, launches on
torch.cuda.current_stream() and raises if the launch was refused; its
`launches` counts launches, and only launches. Under CUDA graph capture a
call records its launch into the graph and counts once there; replays of
the graph do not count (ops/fp.py `ChainTally` counts those). The library
is built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes

import torch

# the block sizes the kernels are instantiated for (the lab's tile race)
THREADS = (64, 128, 256, 512)
DEFAULT_THREADS = 256
SUPPORTED_LIMBS = (16, 24)


class LabMontKernel:
    """One lab formulation on (nlimbs, B) int32 digit tensors on the card.

    `lab` is a LabField (scripts/fp_kernel_lab.py): it supplies nlimbs and
    the constants p, p' and n0 as 16-bit digit lists. Operands must be CUDA
    int32 tensors of shape (nlimbs, B) on one device, with unit column
    stride (row slices of a wider array are fine), each digit < 2^16."""

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
                ctypes.c_void_p, ctypes.c_void_p,  # p digits, p' digits
                ctypes.c_uint32, ctypes.c_int,  # n0, threads
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
                 threads: int = DEFAULT_THREADS) -> torch.Tensor:
        n = lab.n
        if n not in SUPPORTED_LIMBS:
            raise ValueError(f"{self.name}: no instance for {n} limbs; built for {SUPPORTED_LIMBS}")
        if threads not in THREADS:
            raise ValueError(f"{self.name}: threads={threads}, built for {THREADS}")
        dev = a.device if isinstance(a, torch.Tensor) else None
        self._check("a", a, n, dev)
        self._check("b", b, n, dev)
        if a.shape != b.shape:
            raise ValueError(
                f"{self.name}: shapes differ {tuple(a.shape)} vs {tuple(b.shape)}"
            )
        cols = a.shape[1]
        out = torch.empty((n, cols), dtype=torch.int32, device=dev)
        if cols == 0:
            return out
        fn = self._entry()
        p = (ctypes.c_uint32 * n)(*lab.p_limbs)
        pprime = (ctypes.c_uint32 * n)(*lab.pprime_limbs)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = fn(
                self.form,
                a.data_ptr(), a.stride(0),
                b.data_ptr(), b.stride(0),
                out.data_ptr(), out.stride(0),
                cols, n, p, pprime, lab.n0, threads, stream,
            )
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {rc}")
        self.launches += 1
        return out


lab_cios_fullwidth = LabMontKernel("lab_cios_fullwidth", 0)
lab_separated = LabMontKernel("lab_separated", 1)
