"""Fixed-length bitset with the wire format of handel_tpu/core/bitset.py.

Reference: bitset.go:12-207 (the `BitSet` interface and its uint16-length
wire format, bitset.go:150-177). The backing store is a little-endian array
of uint64 words, the layout the launch packer hands to the device
(models/bn254_torch.py `_pack_requests`).

Wire format, byte for byte the JAX package's: a bit length below 0xFFFF is
the legacy dense form (uint16 length, then the bits as little-endian
bytes). The length value 0xFFFF is an escape to an extended header (mode
byte, uint32 bit length) with two payloads: dense bytes, or a varint-delta
list of set indices, whichever is smaller. Decoding caps the declared
length, so a hostile header cannot allocate gigabytes.
"""

from __future__ import annotations

import struct

import numpy as np

# extended-header caps: enough for >1M-identity registries while bounding a
# hostile header's allocation to 512 KiB of words (memory-bomb defense)
MAX_WIRE_BITS = 1 << 22
_ESCAPE = 0xFFFF
_MODE_DENSE = 0
_MODE_SPARSE = 1
_WORD_ALL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _varint(value: int) -> bytes:
    """Unsigned LEB128."""
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    """(value, next position); ValueError on truncation/oversize."""
    value = shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("bitset varint truncated")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift > 28:  # 5 bytes bound any index < MAX_WIRE_BITS
            raise ValueError("bitset varint overlong")


class BitSet:
    """Fixed-length mutable bitset.

    Unlike the reference's interface/impl split (bitset.go:12-54 vs 56-148) there
    is a single concrete class; it is cheap, NumPy-backed, and already in the
    layout device code wants.
    """

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
        # popcount cache: the store's scoring and merges read the
        # cardinality many times between mutations. Mutators invalidate.
        self._card: int | None = None

    # -- basic ops ---------------------------------------------------------

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

    # -- set algebra (reference bitset.go:93-148) --------------------------

    def _check_same(self, other: "BitSet") -> None:
        if self._n != len(other):
            raise ValueError(f"bitset length mismatch: {self._n} vs {len(other)}")

    def or_(self, other: "BitSet") -> "BitSet":
        self._check_same(other)
        return BitSet(self._n, np.bitwise_or(self._words, other._words))

    def and_(self, other: "BitSet") -> "BitSet":
        self._check_same(other)
        return BitSet(self._n, np.bitwise_and(self._words, other._words))

    def xor(self, other: "BitSet") -> "BitSet":
        self._check_same(other)
        return BitSet(self._n, np.bitwise_xor(self._words, other._words))

    def is_superset(self, other: "BitSet") -> bool:
        self._check_same(other)
        return bool(
            np.all(np.bitwise_and(self._words, other._words) == other._words)
        )

    def intersection_cardinality(self, other: "BitSet") -> int:
        self._check_same(other)
        return int(
            np.bitwise_count(np.bitwise_and(self._words, other._words)).sum()
        )

    def all(self) -> bool:
        return self.cardinality() == self._n

    def none(self) -> bool:
        return not self._words.any()

    def any(self) -> bool:
        return bool(self._words.any())

    def next_set(self, start: int = 0) -> int | None:
        """Index of the first set bit >= start, or None (bitset.go:131-139)."""
        for i in range(start, self._n):
            if self.get(i):
                return i
        return None

    def indices(self) -> list[int]:
        """All set-bit indices, ascending."""
        if self._n == 0:
            return []
        bits = np.unpackbits(
            self._words.view(np.uint8), bitorder="little"
        )[: self._n]
        return np.nonzero(bits)[0].tolist()

    # -- device views ------------------------------------------------------

    def words(self) -> np.ndarray:
        """The packed little-endian uint64 word array backing this bitset.

        A VIEW, not a copy — callers must treat it as read-only. This is the
        zero-copy handoff the vectorized launch packer consumes: a batch of
        bitsets stacks to a (C, W) uint64 matrix and one `np.unpackbits`
        yields every candidate's dense mask without per-bit Python
        (models/bn254_torch.py `_pack_requests`). Also the cheap identity for
        dedup keys: `words().tobytes()` hashes the exact bit content."""
        return self._words

    def mask_bool(self, length: int | None = None) -> np.ndarray:
        """Dense bool mask (optionally zero-padded to `length`) for device kernels."""
        n = self._n if length is None else length
        bits = np.unpackbits(self._words.view(np.uint8), bitorder="little")
        out = np.zeros(n, dtype=bool)
        m = min(self._n, n)
        out[:m] = bits[:m]
        return out

    # -- bulk word-level mutation (the store's merges) ---------------------

    def set_range(self, lo: int, hi: int) -> None:
        """Set bits [lo, hi) true with word fills, not a per-bit loop."""
        if lo < 0 or hi > self._n or lo > hi:
            raise IndexError(f"range [{lo},{hi}) out of [0,{self._n})")
        if lo == hi:
            return
        self._card = None
        w0, b0 = divmod(lo, 64)
        w1, b1 = divmod(hi - 1, 64)
        if w0 == w1:
            self._words[w0] |= np.uint64(
                ((1 << (hi - lo)) - 1) << b0 & 0xFFFFFFFFFFFFFFFF
            )
            return
        self._words[w0] |= np.uint64((~((1 << b0) - 1)) & 0xFFFFFFFFFFFFFFFF)
        self._words[w0 + 1 : w1] = _WORD_ALL
        self._words[w1] |= np.uint64(((1 << (b1 + 1)) - 1) & 0xFFFFFFFFFFFFFFFF)

    def or_embed(self, other, offset: int) -> None:
        """self |= other << offset — the store's cross-level merge primitive.

        One arbitrary-precision-int shift-or instead of a Python loop over
        set indices: `combined()`/`full_signature()` run on every verified
        contribution, and a per-index embed of a wide level costs O(N)
        Python per event.
        """
        olen = len(other)
        if offset < 0 or offset + olen > self._n:
            raise IndexError(
                f"embed [{offset},{offset + olen}) out of [0,{self._n})"
            )
        if isinstance(other, AllOnesBitSet):
            self.set_range(offset, offset + olen)
            return
        if olen == 0:
            return
        ov = int.from_bytes(other._words.tobytes(), "little")
        if not ov:
            return
        sv = int.from_bytes(self._words.tobytes(), "little") | (ov << offset)
        self._words = np.frombuffer(
            sv.to_bytes(self._words.size * 8, "little"), dtype=np.uint64
        ).copy()
        self._card = None

    # -- wire format (reference bitset.go:150-177 + 0xFFFF escape) ---------

    def marshal(self) -> bytes:
        """Smallest of: legacy dense (uint16 length || LE-bit bytes, n <
        0xFFFF), extended dense, extended sparse (varint-delta indices)."""
        if self._n > MAX_WIRE_BITS:
            raise ValueError("bitset too large for wire format")
        nbytes = (self._n + 7) // 8
        dense_total = (2 if self._n < _ESCAPE else 7) + nbytes
        card = self.cardinality()
        sparse = None
        # only pay the O(population) index walk when sparse can win: every
        # index costs >= 1 payload byte after the 7+ byte extended header
        if card + 8 < dense_total:
            payload = bytearray(_varint(card))
            prev = -1
            for i in self.indices():
                payload += _varint(i - prev - 1)  # gap to the previous bit
                prev = i
            if 7 + len(payload) < dense_total:
                sparse = bytes(payload)
        if sparse is not None:
            return (
                struct.pack(">HBI", _ESCAPE, _MODE_SPARSE, self._n) + sparse
            )
        payload = self._words.view(np.uint8).tobytes()[:nbytes]
        if self._n < _ESCAPE:
            return struct.pack(">H", self._n) + payload
        return struct.pack(">HBI", _ESCAPE, _MODE_DENSE, self._n) + payload

    @classmethod
    def unmarshal(cls, data: bytes) -> tuple["BitSet", int]:
        """Parse a marshaled bitset; returns (bitset, bytes consumed)."""
        if len(data) < 2:
            raise ValueError("bitset wire data too short")
        (n,) = struct.unpack(">H", data[:2])
        if n == _ESCAPE:
            return cls._unmarshal_extended(data)
        nbytes = (n + 7) // 8
        if len(data) < 2 + nbytes:
            raise ValueError("bitset wire data truncated")
        bs = cls(n)
        bs._fill_dense(data[2 : 2 + nbytes])
        return bs, 2 + nbytes

    @classmethod
    def _unmarshal_extended(cls, data: bytes) -> tuple["BitSet", int]:
        if len(data) < 7:
            raise ValueError("extended bitset header truncated")
        _, mode, n = struct.unpack(">HBI", data[:7])
        if n > MAX_WIRE_BITS:
            raise ValueError(f"bitset length {n} beyond wire cap")
        if mode == _MODE_DENSE:
            nbytes = (n + 7) // 8
            if len(data) < 7 + nbytes:
                raise ValueError("bitset wire data truncated")
            bs = cls(n)
            bs._fill_dense(data[7 : 7 + nbytes])
            return bs, 7 + nbytes
        if mode == _MODE_SPARSE:
            card, pos = _read_varint(data, 7)
            if card > n:
                raise ValueError("sparse bitset population beyond length")
            bs = cls(n)
            idx = -1
            for _ in range(card):
                gap, pos = _read_varint(data, pos)
                idx += gap + 1
                if idx >= n:
                    raise ValueError("sparse bitset index beyond length")
                bs._words[idx >> 6] |= np.uint64(1 << (idx & 63))
            return bs, pos
        raise ValueError(f"unknown bitset wire mode {mode}")

    def _fill_dense(self, raw_bytes: bytes) -> None:
        raw = np.frombuffer(raw_bytes, dtype=np.uint8)
        padded = np.zeros(self._words.size * 8, dtype=np.uint8)
        padded[: len(raw)] = raw
        self._words = padded.view(np.uint64).copy()
        self._card = None
        # zero any bits beyond n that a malicious peer may have set
        extra = self._words.size * 64 - self._n
        if extra and self._words.size:
            keep = (
                np.uint64((1 << (64 - extra)) - 1) if extra < 64 else np.uint64(0)
            )
            self._words[-1] &= keep

    def __repr__(self) -> str:
        return f"BitSet({self._n}, set={self.cardinality()})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BitSet)
            and self._n == other._n
            and bool(np.all(self._words == other._words))
        )


class AllOnesBitSet:
    """Immutable all-set bitset in O(1) memory (a single roaring-style run).

    A complete level's bitset is by definition the full [0, n) run; this
    form stands for one without N/8 dense bytes. It supports the read
    surface the store, partitioner and evaluator use on a complete best:
    length, cardinality, membership, indices, superset algebra, and a dense
    materialization for the wire. `BitSet.or_embed` embeds it as a run.
    """

    __slots__ = ("_n",)

    def __init__(self, length: int):
        if length < 0:
            raise ValueError("bitset length must be >= 0")
        self._n = length

    def __len__(self) -> int:
        return self._n

    def cardinality(self) -> int:
        return self._n

    def get(self, idx: int) -> bool:
        if not 0 <= idx < self._n:
            raise IndexError(f"bit {idx} out of range [0,{self._n})")
        return True

    def all(self) -> bool:
        return True

    def none(self) -> bool:
        return self._n == 0

    def any(self) -> bool:
        return self._n > 0

    def next_set(self, start: int = 0) -> int | None:
        return start if start < self._n else None

    def indices(self) -> range:
        return range(self._n)

    def clone(self) -> "AllOnesBitSet":
        return self  # immutable

    def is_superset(self, other) -> bool:
        if self._n != len(other):
            raise ValueError(
                f"bitset length mismatch: {self._n} vs {len(other)}"
            )
        return True

    def intersection_cardinality(self, other) -> int:
        if self._n != len(other):
            raise ValueError(
                f"bitset length mismatch: {self._n} vs {len(other)}"
            )
        return other.cardinality()

    def to_dense(self) -> BitSet:
        bs = BitSet(self._n)
        bs.set_range(0, self._n)
        return bs

    def marshal(self) -> bytes:
        return self.to_dense().marshal()

    def __repr__(self) -> str:
        return f"AllOnesBitSet({self._n})"
