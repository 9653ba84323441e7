"""ctypes binding of kernel B2, the resident RNS Montgomery multiply
(csrc/rns_mont.cu).

`rns_mul_resident` is the one wrapper: it checks its operands, allocates the
output with torch.empty, launches on torch.cuda.current_stream() and raises
if the launch was refused. `rns_mul_resident.launches` counts launches, and
only launches. The library is built and loaded at the first launch, never
at import. `pack_constants` builds the field's constant table in the order
of `handel::RnsLayout` (csrc/rns_mont.cuh).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# base sizes (kA, kB) the kernel is instantiated for: BN254 and BLS12-381
SUPPORTED_BASES = ((24, 21), (34, 30))


def pack_constants(field) -> np.ndarray:
    """The int32 constant table of an RnsField, laid out as RnsLayout<kA, kB>:
    moduli, their float32 reciprocals (as bits), c1, E, p mod m_j, M^-1 mod
    m_j, c2, L_mr, E2, MB mod m_i, MB^-1 mod m_r."""
    m = field._m_all.astype(np.int32)
    minv = (1.0 / m.astype(np.float64)).astype(np.float32).view(np.int32)
    parts = [
        m, minv, field._c1, field._E.reshape(-1), field._p_modB, field._MinvB,
        field._c2, field._L_mr, field._E2.reshape(-1), field._MB_modA,
        np.array([field._MBinv_r]),
    ]
    return np.ascontiguousarray(np.concatenate([np.asarray(p, np.int32) for p in parts]))


class RnsMulResidentKernel:
    """out = joint residues of a * b * M^-1 on (k_all, B) int32 residue
    planes on the card (RnsField._mul_resident_core's function).

    `field` is an RnsField: it supplies kA, kB, k_all and its device constant
    table. Operands must be CUDA int32 tensors of shape (k_all, B) on one
    device, with unit column stride (row slices of a wider array are fine),
    each residue below its modulus."""

    def __init__(self):
        self.launches = 0
        self._fn = None

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
        fn = self._entry()
        table = field.kernel_table()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = fn(
                a.data_ptr(), a.stride(0),
                b.data_ptr(), b.stride(0),
                out.data_ptr(), out.stride(0),
                cols, field.kA, field.kB, table.data_ptr(), stream,
            )
        if rc != 0:
            raise RuntimeError(f"rns_mul_resident launch failed: cudaError {rc}")
        self.launches += 1
        return out


rns_mul_resident = RnsMulResidentKernel()
