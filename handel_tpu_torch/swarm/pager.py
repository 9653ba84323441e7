"""Registry paging: device pubkey residency in level-sized chunks — a copy
of handel_tpu/swarm/pager.py.

A 1M-identity registry is ~64 MB of G2 points (BN254
uncompressed) — too big to re-stage per launch, and wasteful to pin whole
when a verify batch only ever touches the chunks its bitsets cover (one
Handel level is one contiguous ID range, so touched chunks cluster). The
pager wraps a device engine and tracks an LRU set of resident chunks of
2^chunk_bits identities each: before a launch it derives the touched chunk
set from the request bitsets' set *words* (O(set words), not O(bits)),
commits the missing ones, and evicts over budget.

With the host schemes used at swarm scale there is no physical transfer —
`commit` is accounting plus an optional `on_commit(chunk_lo, chunk_hi)`
hook, where a device scheme would plug its pubkey staging (no scheme of
either package does yet), and the hit/commit/evict counters are the
same either way. That keeps the paging POLICY (what is resident when) a
tested, measured artifact now, independent of the staging mechanism.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

_WORD_BITS = 64


class RegistryPager:
    """LRU residency tracker over identity chunks of 2^chunk_bits."""

    def __init__(self, chunk_bits: int = 12, budget_chunks: int = 64,
                 on_commit=None):
        if chunk_bits < 6:
            raise ValueError("chunk_bits must be >= 6 (one bitset word)")
        self.chunk_bits = chunk_bits
        self.budget = max(1, budget_chunks)
        self.on_commit = on_commit
        self._resident: OrderedDict[int, None] = OrderedDict()
        # telemetry plane
        self.pages_committed = 0
        self.page_hits = 0
        self.page_evictions = 0

    def touched_chunks(self, bitset) -> set[int]:
        """Chunk ids covered by a bitset's set bits, via its word array."""
        words = np.flatnonzero(bitset.words())
        shift = self.chunk_bits - 6  # 64 bits per word
        return set((words >> shift).tolist())

    def ensure(self, chunks) -> None:
        for c in sorted(chunks):
            if c in self._resident:
                self.page_hits += 1
                self._resident.move_to_end(c)
                continue
            self.pages_committed += 1
            if self.on_commit is not None:
                lo = c << self.chunk_bits
                self.on_commit(lo, lo + (1 << self.chunk_bits))
            self._resident[c] = None
            while len(self._resident) > self.budget:
                self._resident.popitem(last=False)
                self.page_evictions += 1

    def resident_chunks(self) -> int:
        return len(self._resident)

    def values(self) -> dict[str, float]:
        return {
            "pagesCommitted": float(self.pages_committed),
            "pageHits": float(self.page_hits),
            "pageEvictions": float(self.page_evictions),
            "pagesResident": float(len(self._resident)),
        }

    def gauge_keys(self) -> set[str]:
        return {"pagesResident"}


class PagedDevice:
    """Device-contract wrapper running the pager before every launch.

    Wraps anything with `dispatch_multi`/`fetch`/`batch_size` (HostDevice,
    BN254Device): items are (msg, pubkeys, bitset, sig); the union of the
    batch's touched chunks is ensured resident, then the launch proceeds on
    the wrapped engine unchanged.
    """

    def __init__(self, engine, pager: RegistryPager):
        self.engine = engine
        self.pager = pager
        self.batch_size = engine.batch_size

    def dispatch_multi(self, items):
        touched: set[int] = set()
        for _, _, bs, _ in items:
            touched |= self.pager.touched_chunks(bs)
        self.pager.ensure(touched)
        return self.engine.dispatch_multi(items)

    def fetch(self, handle):
        return self.engine.fetch(handle)
