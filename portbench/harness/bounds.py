"""The card's peaks and kernel B1's least time a call: a frozen copy of
`chip_smoke.py` (lines 568-572 and `mont_mul_bound_ms`, lines 731-741) at
commit 3760aa89b03e87d3430f6fe2b66b6553ac17ffbc, kept here so that no
change to the program moves the yardstick.

H100 SXM data-sheet rates: HBM3 3.35 TB/s; int32 64 lanes per SM per clock
(half the 128 FP32 lanes behind the 67 TFLOP/s FP32 figure) x 132 SMs x
1.98 GHz = 16.7 T int32 operations/s.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def mont_mul_bound_ms(nlimbs: int, cols: int) -> float:
    """Least time for `cols` Montgomery products of `nlimbs` 16-bit limbs:
    the bytes (a and b read once, out written once, int32 limbs) over HBM
    bandwidth against the 32x32->64-bit multiply-adds of word-serial CIOS
    (2 N^2 + N per column for N = nlimbs/2 words, two int32 multiply-adds
    each) over the int32 rate, whichever is larger."""
    words = nlimbs // 2
    t_bytes = 3 * nlimbs * 4 * cols / HBM_BYTES_PER_S
    t_ops = 2 * (2 * words * words + words) * cols / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3
