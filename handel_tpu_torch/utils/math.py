"""Integer helpers used by the partitioner and level logic — a copy of
handel_tpu/utils/math.py.

Reference: utils.go:8-38 (log2 ceil, pow2, isSet).
"""


def log2_ceil(n: int) -> int:
    """Ceiling of log2(n): the number of binomial-tree levels for n nodes.

    log2_ceil(1) == 0, log2_ceil(2) == 1, log2_ceil(5) == 3.
    """
    if n <= 1:
        return 0
    return (n - 1).bit_length()


def pow2(k: int) -> int:
    return 1 << k


def is_set(x: int, bit: int) -> bool:
    return (x >> bit) & 1 == 1
