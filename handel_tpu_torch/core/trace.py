"""The trace clock and log-bucket latency histograms — the part of
handel_tpu/core/trace.py that the processing pipeline and Handel read.

`LogHistogram` has fixed log-spaced buckets (the same boundaries everywhere,
so per-node histograms merge by summing counts): the per-launch verify
latency of a round, the queue wait and the level completion times are read
from it, and its sparse wire form carries them to the sim's monitor. The
reference's span flight recorder is not ported yet (ROADMAP).
"""

from __future__ import annotations

import math
import time
from typing import Mapping

#: epoch-seconds trace clock shared by every process on a host; packets
#: carry it as their send stamp (core/net.py)
trace_now = time.time


class LogHistogram:
    """Fixed log-bucket histogram with mergeable, node-independent buckets.

    Bucket i covers [BASE * GROWTH^i, BASE * GROWTH^(i+1)); GROWTH = 2^0.25
    gives <= 19% relative quantile error, and 120 buckets span 1 us to
    ~18 min.
    """

    BASE = 1e-6
    GROWTH = 2.0 ** 0.25
    NBUCKETS = 120
    _LOG2_GROWTH = 0.25  # log2(GROWTH)

    __slots__ = ("counts", "count", "sum", "lo", "hi")

    def __init__(self):
        self.counts = [0] * self.NBUCKETS
        self.count = 0
        self.sum = 0.0
        self.lo = math.inf
        self.hi = -math.inf

    def add(self, v: float) -> None:
        self.counts[self._index(v)] += 1
        self.count += 1
        self.sum += v
        if v < self.lo:
            self.lo = v
        if v > self.hi:
            self.hi = v

    @classmethod
    def _index(cls, v: float) -> int:
        if v <= cls.BASE:
            return 0
        i = int(math.log2(v / cls.BASE) / cls._LOG2_GROWTH)
        return min(i, cls.NBUCKETS - 1)

    @classmethod
    def bucket_bounds(cls, i: int) -> tuple[float, float]:
        lo = cls.BASE * cls.GROWTH**i
        return lo, lo * cls.GROWTH

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile at the geometric midpoint of its bucket,
        clamped to the observed [lo, hi] for sub-bucket fidelity."""
        if self.count == 0:
            return float("nan")
        target = max(1, math.ceil(q * self.count))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                blo, bhi = self.bucket_bounds(i)
                mid = math.sqrt(blo * bhi)
                return min(max(mid, self.lo), self.hi)
        return self.hi  # unreachable while count is consistent

    # -- wire form (sim/monitor.py sink payloads) ---------------------------

    def to_sparse(self) -> dict:
        return {
            "b": {str(i): c for i, c in enumerate(self.counts) if c},
            "sum": self.sum,
            "lo": self.lo if self.count else 0.0,
            "hi": self.hi if self.count else 0.0,
        }

    def merge_sparse(self, payload: Mapping) -> None:
        """Merge one sink datagram's partial histogram. Bucket counts add;
        lo/hi merge idempotently (every chunk of a split histogram repeats
        them); `sum` adds (a chunked send carries it on one chunk only)."""
        added = 0
        for k, c in dict(payload.get("b", {})).items():
            i = int(k)
            if 0 <= i < self.NBUCKETS:
                c = int(c)
                self.counts[i] += c
                added += c
        self.count += added
        self.sum += float(payload.get("sum", 0.0))
        if added:
            self.lo = min(self.lo, float(payload.get("lo", math.inf)))
            self.hi = max(self.hi, float(payload.get("hi", -math.inf)))

    def merge(self, other: "LogHistogram") -> None:
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.lo = min(self.lo, other.lo)
        self.hi = max(self.hi, other.hi)
