"""Binomial-tree (San Fermin) candidate-set partitioner — a copy of
handel_tpu/core/partitioner.py.

Reference: partitioner.go:13-296 — `Partitioner` interface, the
common-prefix-length binary search (`rangeLevel`, partitioner.go:133-178 and
`rangeLevelInverse`, :185-211), level-local indexing (:107-119), and signature
combination across levels (`Combine` :224-261, `CombineFull` :263-278).

The algorithm is pure index arithmetic and stays on the host; `combine*` hand
the point additions to `Signature.combine`, or to one batched combiner call
(the store's device combine, core/processing.py `CombineShim`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.crypto import MultiSignature
from handel_tpu_torch.core.identity import Identity, Registry
from handel_tpu_torch.utils.math import is_set, log2_ceil, pow2


class EmptyLevelError(Exception):
    """A level whose candidate range is empty (non-power-of-two N)."""


class InvalidLevelError(Exception):
    """Requested level outside [0, bitsize+1]."""


@dataclass
class IncomingSig:
    """A parsed signature attributed to a protocol level (processing.go:16-25).

    `mapped_index` is the origin's index inside the level's bitset; only
    meaningful when `is_ind` (an individual signature).
    """

    origin: int
    level: int
    ms: MultiSignature | None
    is_ind: bool = False
    mapped_index: int = 0
    verify_tries: int = 0  # verifier-error retry count (processing requeue)
    # trace stamps (core/trace.py clock): packet arrival and (re)enqueue
    # into the pending queue — the span boundaries of recv/queue/verify
    recv_ts: float = 0.0
    enqueue_ts: float = 0.0
    # sender flow-link id (Packet.span_id): rides through queue/verify/merge
    # span args so the causal chain survives the pending-queue reorder
    span_id: int = 0

    @property
    def individual(self) -> bool:
        return self.is_ind


class BinomialPartitioner:
    """Partition the ID space by common-prefix length with our own ID.

    Mirrors binomialPartitioner (partitioner.go:52-222): level ranges are found
    by a binary search over the bits of `id` from the most significant bit down,
    flipping the half-choice at bit (level-1) to select the *other* subtree.
    """

    def __init__(self, id: int, registry: Registry, logger=None):
        self.id = int(id)
        self.reg = registry
        self.size = registry.size()
        self.bitsize = log2_ceil(self.size)
        self.logger = logger
        # ranges are pure functions of (id, size, level): memoized, because
        # every combine() walks them per level per verified contribution
        self._range_cache: dict[int, tuple[int, int]] = {}
        self._range_inv_cache: dict[int, tuple[int, int]] = {}

    def max_level(self) -> int:
        return self.bitsize

    def range_level(self, level: int) -> tuple[int, int]:
        """[min, max) of the candidate set at `level` as seen from self.id.

        partitioner.go:133-178. Raises EmptyLevelError when the subtree falls
        entirely beyond `size` (non-power-of-two registries).
        """
        cached = self._range_cache.get(level)
        if cached is not None:
            return cached
        if level < 0 or level > self.bitsize + 1:
            raise InvalidLevelError(f"level {level} out of range")
        lo, hi = 0, pow2(self.bitsize)
        inverse_idx = level - 1
        idx = self.bitsize - 1
        while idx >= inverse_idx and idx >= 0 and lo < hi:
            middle = (lo + hi) // 2
            if is_set(self.id, idx):
                # invert the half at the common-prefix bit to get the
                # *candidate* set rather than our own subtree
                if idx == inverse_idx:
                    hi = middle
                else:
                    lo = middle
            else:
                if idx == inverse_idx:
                    lo = middle
                else:
                    hi = middle
            idx -= 1
        if lo >= self.size:
            raise EmptyLevelError(f"level {level} empty for id {self.id}")
        out = (lo, min(hi, self.size))
        self._range_cache[level] = out
        return out

    def range_level_inverse(self, level: int) -> tuple[int, int]:
        """[min, max) of *our own* subtree at `level` (partitioner.go:185-211).

        This is the ID range whose contributions a signature *sent to* `level`
        must cover — peers at that level expect everything below `level` from
        our side of the tree.
        """
        cached = self._range_inv_cache.get(level)
        if cached is not None:
            return cached
        if level < 0 or level > self.bitsize + 1:
            raise InvalidLevelError(f"level {level} out of range")
        lo, hi = 0, pow2(self.bitsize)
        max_idx = level - 1
        idx = self.bitsize - 1
        while idx >= max_idx and idx >= 0 and lo < hi:
            middle = (lo + hi) // 2
            if is_set(self.id, idx):
                lo = middle
            else:
                hi = middle
            idx -= 1
        out = (lo, min(hi, self.size))
        self._range_inv_cache[level] = out
        return out

    def size_of(self, level: int) -> int:
        """Number of peers at `level`; 0 for empty levels (partitioner.go:213-222)."""
        try:
            lo, hi = self.range_level(level)
        except EmptyLevelError:
            return 0
        return hi - lo

    def levels(self) -> list[int]:
        """Non-empty level ids, ascending, excluding level 0 (partitioner.go:95-105)."""
        out = []
        for lvl in range(1, self.max_level() + 1):
            try:
                self.range_level(lvl)
            except EmptyLevelError:
                continue
            out.append(lvl)
        return out

    def identities_at(self, level: int) -> Sequence[Identity]:
        """Candidate identities at `level` as an O(1) range view (level
        ranges are contiguous by construction, so no copy is needed)."""
        lo, hi = self.range_level(level)
        ids = self.reg.identity_range(lo, hi)
        if not ids and hi > lo:
            raise ValueError("registry can't find ids in range")
        return ids

    def index_at_level(self, global_id: int, level: int) -> int:
        """Map a global node id to its index inside `level`'s bitset
        (partitioner.go:107-119). Raises ValueError for out-of-range ids —
        'either a bug either an attack' (partitioner.go:115)."""
        lo, hi = self.range_level(level)
        if global_id < lo or global_id >= hi:
            raise ValueError(
                f"id {global_id} outside level {level} range [{lo},{hi})"
            )
        return global_id - lo

    # -- combination (partitioner.go:224-296) ------------------------------

    def combine(
        self,
        sigs: Sequence[IncomingSig],
        level: int,
        new_bitset: Callable[[int], BitSet] = BitSet,
        combiner: Callable[[list], object] | None = None,
    ) -> MultiSignature | None:
        """Merge per-level best sigs into one sig sized for sending to `level`.

        The bitset covers range_level_inverse(level) — the ID span peers at
        `level` expect from us; each per-level sig lands at its range offset.
        """
        if not sigs:
            return None
        for s in sigs:
            if s.level > level:
                return None
        try:
            gmin, gmax = self.range_level_inverse(level)
        except InvalidLevelError:
            return None

        def offset_of(s: IncomingSig) -> int:
            lo, _ = self.range_level(s.level)
            return lo - gmin

        return self._combine_into(
            sigs, new_bitset(gmax - gmin), offset_of, combiner
        )

    def combine_full(
        self,
        sigs: Sequence[IncomingSig],
        new_bitset: Callable[[int], BitSet] = BitSet,
        combiner: Callable[[list], object] | None = None,
    ) -> MultiSignature | None:
        """Merge per-level best sigs into a registry-sized multisignature."""
        if not sigs:
            return None

        def offset_of(s: IncomingSig) -> int:
            lo, _ = self.range_level(s.level)
            return lo

        return self._combine_into(sigs, new_bitset(self.size), offset_of, combiner)

    def _combine_into(
        self, sigs, bitset: BitSet, offset_of, combiner=None
    ) -> MultiSignature:
        parts = []
        for s in sigs:
            off = offset_of(s)
            bs = s.ms.bitset
            # word-level shift-or (and a run fill for an AllOnesBitSet):
            # combined()/full_signature() run per verified contribution
            bitset.or_embed(bs, off)
            parts.append(s.ms.signature)
        if not parts:
            final_sig = None
        elif len(parts) == 1 or combiner is None:
            final_sig = parts[0]
            for sig in parts[1:]:
                final_sig = final_sig.combine(sig)
        else:
            # batched: one combiner call (device combine_batch launch)
            # instead of one host point add per level (point addition is
            # commutative; same group element as the serial fold)
            final_sig = combiner(parts)
        return MultiSignature(bitset, final_sig)
