"""Fixed-length bitset — the part of handel_tpu/core/bitset.py that the
port's verify engine and scheme interfaces use.

Reference: bitset.go:12-207. The backing store is a little-endian array of
uint64 words, the layout the launch packer hands to the device
(models/bn254_torch.py `_pack_requests`). The set algebra, the wire format
and the all-ones form arrive with the protocol core in a later slice.
"""

from __future__ import annotations

import numpy as np


class BitSet:
    """Fixed-length mutable bitset over little-endian uint64 words."""

    __slots__ = ("_n", "_words", "_card")

    def __init__(self, length: int, _words: np.ndarray | None = None):
        if length < 0:
            raise ValueError("bitset length must be >= 0")
        self._n = length
        nwords = (length + 63) // 64
        if _words is not None:
            if _words.shape != (nwords,) or _words.dtype != np.uint64:
                raise ValueError(f"expected {nwords} uint64 words")
            self._words = _words
        else:
            self._words = np.zeros(nwords, dtype=np.uint64)
        self._card: int | None = None  # popcount cache, reset by mutators

    def __len__(self) -> int:
        return self._n

    def set(self, idx: int, value: bool = True) -> None:
        if not 0 <= idx < self._n:
            raise IndexError(f"bit {idx} out of range [0,{self._n})")
        w, b = divmod(idx, 64)
        if value:
            self._words[w] |= np.uint64(1 << b)
        else:
            self._words[w] &= np.uint64(~(1 << b) & 0xFFFFFFFFFFFFFFFF)
        self._card = None

    def get(self, idx: int) -> bool:
        if not 0 <= idx < self._n:
            raise IndexError(f"bit {idx} out of range [0,{self._n})")
        w, b = divmod(idx, 64)
        return bool((int(self._words[w]) >> b) & 1)

    def cardinality(self) -> int:
        if self._card is None:
            self._card = int(np.bitwise_count(self._words).sum())
        return self._card

    def clone(self) -> "BitSet":
        return BitSet(self._n, self._words.copy())

    def indices(self) -> list[int]:
        """All set-bit indices, ascending."""
        if self._n == 0:
            return []
        bits = np.unpackbits(self._words.view(np.uint8), bitorder="little")[: self._n]
        return np.nonzero(bits)[0].tolist()

    def words(self) -> np.ndarray:
        """The packed little-endian uint64 words backing this bitset: a view,
        read-only to callers, which the launch packer stacks into a (C, W)
        matrix."""
        return self._words

    def __repr__(self) -> str:
        return f"BitSet({self._n}, set={self.cardinality()})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BitSet)
            and self._n == other._n
            and bool(np.all(self._words == other._words))
        )
