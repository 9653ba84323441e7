"""Span flight recorder + log-bucket latency histograms — a copy of
handel_tpu/core/trace.py.

- `FlightRecorder`: a bounded in-memory ring of span events following every
  contribution through `recv -> queue -> verify -> merge` (plus the shared
  verifier's dispatch/device stages), exported as Chrome `trace_event` JSON
  loadable in `chrome://tracing` / Perfetto. Disabled, a span call is one
  attribute check, so the hooks stay in the hot path permanently.

- `LogHistogram`: fixed log-spaced buckets (identical boundaries everywhere,
  so per-node histograms merge by summing counts) feeding the
  `_p50/_p90/_p99` CSV columns (sim/monitor.py).

The trace clock is `time.time()` (epoch seconds): processes on one host
share it, so cross-node spans line up in one timeline — `Packet.sent_ts`
(core/net.py) carries it across the wire for network-transit spans.

Causal links: packets also carry an 8-byte span id, and the recorder emits
Chrome flow events (`ph: "s"/"t"/"f"`, shared `id`) binding a sender's `send`
span to the receiver's `recv -> queue -> verify -> merge` chain. Each export
carries its process's `clock_offset` (estimated over the sync barrier
handshake, sim/sync.py); `merge_traces` applies it.
"""

from __future__ import annotations

import json
import math
import time
from typing import Iterable, Mapping

#: epoch-seconds trace clock shared by every process on a host
trace_now = time.time

#: Chrome-trace thread id for process-scoped (non-node) actors like the
#: shared batch-verifier service
SERVICE_TID = -1


class FlightRecorder:
    """Bounded ring of trace events; ~zero cost when disabled.

    Events are stored as tuples and only materialized into Chrome
    `trace_event` dicts at export, so recording is an index store. When the
    ring wraps, the oldest events are overwritten (`dropped` counts them) —
    a run that outlives the ring keeps its most recent window, which is the
    one a stall diagnosis needs.
    """

    __slots__ = (
        "enabled",
        "capacity",
        "pid",
        "dropped",
        "clock_offset",
        "_buf",
        "_pos",
        "_count",
        "_pushed",
        "_t0",
        "_names",
    )

    def __init__(self, capacity: int = 1 << 16, enabled: bool = True, pid: int = 0):
        self.enabled = enabled
        self.capacity = max(1, capacity)
        self.pid = pid
        self.dropped = 0
        # seconds to ADD to this process's timestamps to land on the sync
        # master's clock (sim/sync.py offset estimation); applied at merge
        self.clock_offset = 0.0
        self._buf: list = [None] * self.capacity
        self._pos = 0
        self._count = 0
        self._pushed = 0  # lifetime events (span-emit rate denominator)
        self._t0 = trace_now()
        self._names: dict[int, str] = {}  # tid -> thread name metadata

    # -- recording (the hot path) -------------------------------------------

    def span(
        self,
        name: str,
        start: float,
        end: float,
        tid: int = 0,
        cat: str = "",
        args: dict | None = None,
    ) -> None:
        """Complete event ("X"): [start, end] in trace-clock seconds."""
        if not self.enabled:
            return
        self._push((name, "X", start, end - start, tid, cat, args, 0))

    def instant(
        self,
        name: str,
        ts: float | None = None,
        tid: int = 0,
        cat: str = "",
        args: dict | None = None,
    ) -> None:
        if not self.enabled:
            return
        self._push((
            name, "i", ts if ts is not None else trace_now(), 0.0, tid, cat,
            args, 0,
        ))

    def flow(
        self,
        name: str,
        fid: int,
        ph: str,
        ts: float,
        tid: int = 0,
        cat: str = "flow",
    ) -> None:
        """Flow event (`ph` in "s"/"t"/"f") carrying the causal link id
        `fid` — the packet span id (core/net.py). A flow start on the
        sender's `send` span and a step/finish on the receiver's pipeline
        spans draw one contribution's cross-process arrow in Perfetto, and
        the critical-path analyzer (sim/trace_cli.py) walks the same ids."""
        if not self.enabled:
            return
        self._push((name, ph, ts, 0.0, tid, cat, None, fid))

    def _push(self, ev: tuple) -> None:
        self._pushed += 1
        if self._count >= self.capacity:
            self.dropped += 1
        else:
            self._count += 1
        self._buf[self._pos] = ev
        self._pos = (self._pos + 1) % self.capacity

    # -- metadata / export --------------------------------------------------

    def name_thread(self, tid: int, name: str) -> None:
        self._names[tid] = name

    def events(self) -> list[tuple]:
        """Recorded events, oldest first."""
        if self._count < self.capacity:
            return [e for e in self._buf[: self._count]]
        return self._buf[self._pos :] + self._buf[: self._pos]

    def export(self) -> dict:
        """Chrome `trace_event` JSON-object format (ts/dur in microseconds)."""
        out = []
        for tid, name in sorted(self._names.items()):
            out.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": self.pid,
                    "tid": tid,
                    "args": {"name": name},
                }
            )
        for name, ph, ts, dur, tid, cat, args, fid in self.events():
            ev = {
                "name": name,
                "ph": ph,
                "ts": ts * 1e6,
                "pid": self.pid,
                "tid": tid,
            }
            if ph == "X":
                ev["dur"] = max(0.0, dur) * 1e6
            elif ph in ("s", "t", "f"):
                ev["id"] = fid
                if ph != "s":
                    # bind to the enclosing slice, not the next one
                    ev["bp"] = "e"
            if cat:
                ev["cat"] = cat
            if args:
                ev["args"] = args
            out.append(ev)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            # per-process clock alignment, applied by merge_traces
            "clockOffset": self.clock_offset,
        }

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.export(), f)
        return path

    def values(self) -> dict[str, float]:
        """Reporter-plane counters (core/report.py shape): ring occupancy,
        silent-truncation count, and the live span-emit rate — the
        `/metrics` + `sim watch` surface that makes a wrapped ring visible
        while the run is still going."""
        dt = trace_now() - self._t0
        return {
            "traceEvents": float(self._count),
            "traceDropped": float(self.dropped),
            "traceSpanRate": self._pushed / dt if dt > 0 else 0.0,
        }

    def gauge_keys(self) -> set[str]:
        """Explicit gauge declaration (core/metrics.py is_gauge_key)."""
        return {"traceSpanRate"}


class LogHistogram:
    """Fixed log-bucket histogram with mergeable, node-independent buckets.

    Bucket i covers [BASE * GROWTH^i, BASE * GROWTH^(i+1)); GROWTH = 2^0.25
    gives <= 19% relative quantile error, and 120 buckets span 1 us to
    ~18 min — the whole latency range a run can produce. Because boundaries
    are fixed (not data-dependent), per-node histograms serialize as sparse
    {bucket: count} maps through the UDP sink and merge master-side by
    summing counts (sim/monitor.py), which exact-sample designs cannot do
    in bounded space.
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

    @classmethod
    def from_sparse(cls, payload: Mapping) -> "LogHistogram":
        """Rebuild from one COMPLETE sparse wire form (all buckets + the
        sum present). The roll-up plane ships absolute sparse maps, so
        `from_sparse(h.to_sparse())` round-trips exactly."""
        h = cls()
        h.merge_sparse(payload)
        return h

    def copy(self) -> "LogHistogram":
        h = type(self)()
        h.merge(self)
        return h


def merge_traces(exports: Iterable[Mapping]) -> dict:
    """Combine per-process Chrome trace exports into one timeline.

    Each export's estimated `clockOffset` (seconds, sim/sync.py handshake)
    is applied here — shifting every event onto the sync master's clock —
    so multi-host timelines align within the handshake's RTT bound instead
    of drifting by whatever NTP left behind."""
    events: list = []
    for ex in exports:
        off_us = float(ex.get("clockOffset", 0.0) or 0.0) * 1e6
        for e in ex.get("traceEvents", []):
            if off_us and e.get("ph") != "M":
                e = {**e, "ts": e.get("ts", 0.0) + off_us}
            events.append(e)
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}
