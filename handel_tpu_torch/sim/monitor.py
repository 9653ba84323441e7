"""Metrics plane: UDP JSON sink, measures, stats aggregation, CSV output —
a copy of handel_tpu/sim/monitor.py without its fleet route
(`Monitor(fleet=)`, the `{"rollup": ...}` datagrams it feeds and
`Sink.record_rollup`), which nothing in either package calls: a rollup
datagram here is dropped like any other datagram without a `name`.

Reference: simul/monitor/ — nodes `ConnectSink` and push JSON measures
(monitor.go:41-156, measure.go:33-229); the master aggregates per-key
min/max/avg/sum/dev columns (stats.go:23-480) into the CSV schema the plots
consume (simul/plots/csv/*.csv headers, e.g. `sigen_wall_avg`).

Measure kinds mirrored here: `TimeMeasure` (wall + user/system CPU via
resource.getrusage, measure.go:54-143 + rtime.go:17-26), `CounterIO`
(delta of a Values() map), and single values. The device plane's
launch-time counters flow through the same pipe.

Observability additions: `HistogramIO` ships fixed-log-bucket
histograms (core/trace.py LogHistogram) through the same UDP pipe as sparse
{bucket: count} maps; the master merges them by summing counts and emits
`_p50/_p90/_p99/_n` CSV columns next to the classic stats. Large payloads
are chunked below the UDP-safe datagram size instead of risking an
oversized-send OSError silently swallowing the whole measure.
"""

from __future__ import annotations

import asyncio
import json
import math
import resource
import time
import warnings
from typing import Iterator, Mapping, Sequence

from handel_tpu_torch.core.trace import LogHistogram

# conservative single-datagram budget: 1500 MTU minus IP/UDP headers with
# margin — loopback allows much more, but the multi-host master does not
MAX_DATAGRAM = 1400


# -- node side: the sink client ---------------------------------------------


class Sink:
    """Fire-and-forget UDP JSON metric emitter (monitor.go ConnectSink)."""

    def __init__(self, addr: str):
        host, _, port = addr.rpartition(":")
        self.addr = (host or "127.0.0.1", int(port))
        import socket

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def record(self, name: str, values: Mapping[str, float]) -> None:
        vals = {k: float(v) for k, v in values.items()}
        for payload in _chunk_values(name, vals):
            self._send(payload)

    def record_histograms(
        self, name: str, hists: Mapping[str, LogHistogram]
    ) -> None:
        """Ship each histogram as sparse bucket maps, chunked per datagram;
        the master merges chunks by summing bucket counts (LogHistogram
        .merge_sparse), so a split histogram reassembles exactly."""
        for key, h in hists.items():
            if h.count == 0:
                continue  # nothing measured: the master emits NaN columns
            for payload in _chunk_hist(name, key, h):
                self._send(payload)

    def _send(self, payload: dict) -> None:
        try:
            self._sock.sendto(json.dumps(payload).encode(), self.addr)
        except OSError:
            pass

    def close(self) -> None:
        self._sock.close()


def _chunk_values(name: str, vals: dict[str, float]) -> Iterator[dict]:
    """Split a values map into payloads whose JSON stays <= MAX_DATAGRAM.

    One oversized sendto raises OSError and (fire-and-forget) loses EVERY
    key of the measure; chunking loses none. Sizes are computed on the
    JSON-encoded items themselves, so the estimate is exact up to the two
    enclosing braces."""
    base = len(json.dumps({"name": name, "values": {}}).encode())
    out: dict[str, float] = {}
    size = base
    for k, v in vals.items():
        item = len(json.dumps({k: v}).encode())  # includes braces ≈ separator slack
        if out and size + item > MAX_DATAGRAM:
            yield {"name": name, "values": out}
            out, size = {}, base
        out[k] = v
        size += item
    if out or not vals:
        yield {"name": name, "values": out}


def _chunk_hist(name: str, key: str, h: LogHistogram) -> Iterator[dict]:
    """Split one histogram's sparse buckets across datagrams. Every chunk
    repeats lo/hi (idempotent min/max merge); `sum` rides the first chunk
    only, so the master-side total adds up exactly once."""
    sparse = h.to_sparse()
    items = list(sparse["b"].items())
    base = len(
        json.dumps(
            {"name": name, "hists": {key: {"b": {}, "lo": sparse["lo"],
                                           "hi": sparse["hi"], "sum": sparse["sum"]}}}
        ).encode()
    )
    first = True
    out: dict[str, int] = {}
    size = base
    for bk, bc in items:
        item = len(json.dumps({bk: bc}).encode())
        if out and size + item > MAX_DATAGRAM:
            yield _hist_payload(name, key, out, sparse, include_sum=first)
            first = False
            out, size = {}, base
        out[bk] = bc
        size += item
    if out:
        yield _hist_payload(name, key, out, sparse, include_sum=first)


def _hist_payload(name, key, buckets, sparse, include_sum):
    body = {"b": buckets, "lo": sparse["lo"], "hi": sparse["hi"]}
    if include_sum:
        body["sum"] = sparse["sum"]
    return {"name": name, "hists": {key: body}}


class TimeMeasure:
    """Wall + user/system CPU interval measure (measure.go:54-143)."""

    def __init__(self, sink: Sink, name: str):
        self.sink = sink
        self.name = name
        self._wall = time.perf_counter()
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self._user, self._sys = ru.ru_utime, ru.ru_stime

    def record(self) -> None:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.sink.record(
            self.name,
            {
                "wall": time.perf_counter() - self._wall,
                "user": ru.ru_utime - self._user,
                "system": ru.ru_stime - self._sys,
            },
        )


class CounterIO:
    """Delta-of-Values() measure (measure.go CounterMeasure): snapshot a
    reporter's counters at construction, record the difference.

    Gauge keys are point-in-time ratios or levels (hit rates, launch
    occupancy, cache sizes, breaker state): `now - base` is meaningless for
    a ratio whenever the construction-time snapshot is nonzero, so those
    are recorded as-is. Reporters declare their gauge keys EXPLICITLY via a
    `gauge_keys()` method (core/store.py VerifiedAggCache, core/handel.py,
    parallel/batch_verifier.py, ...) or the caller passes `gauges=`; the
    name-suffix heuristic is kept only as a fallback, so a new
    gauge without a magic suffix can't be silently averaged as a counter."""

    GAUGE_SUFFIXES = ("Rate", "Occupancy", "Size", "State")

    def __init__(self, sink: Sink, name: str, reporter, gauges=None):
        self.sink = sink
        self.name = name
        self.reporter = reporter
        if gauges is not None:
            self._gauges = set(gauges)
        else:
            gk = getattr(reporter, "gauge_keys", None)
            self._gauges = set(gk()) if callable(gk) else set()
        self._base = dict(reporter.values())

    def _is_gauge(self, key: str) -> bool:
        return key in self._gauges or key.endswith(self.GAUGE_SUFFIXES)

    def record(self) -> None:
        now = self.reporter.values()
        self.sink.record(
            self.name,
            {
                k: (v if self._is_gauge(k) else v - self._base.get(k, 0.0))
                for k, v in now.items()
            },
        )


class HistogramIO:
    """Ships a reporter's `histograms()` map (key -> LogHistogram) through
    the sink at record time. Histograms are cumulative over the run, so no
    construction-time base is needed — record once at run end, like the
    reference records its measures at the END barrier."""

    def __init__(self, sink: Sink, name: str, reporter):
        self.sink = sink
        self.name = name
        self.reporter = reporter

    def record(self) -> None:
        self.sink.record_histograms(self.name, self.reporter.histograms())


# -- master side: the sink server + stats ------------------------------------


class _SinkProto(asyncio.DatagramProtocol):
    def __init__(self, mon: "Monitor"):
        self.mon = mon

    def connection_made(self, transport):
        self.mon._transport = transport

    def datagram_received(self, data: bytes, addr) -> None:
        try:
            msg = json.loads(data.decode())
        except ValueError:
            return
        try:
            name = str(msg["name"])
            values = msg.get("values", {})
            hists = msg.get("hists", {})
        except (ValueError, KeyError, AttributeError, TypeError):
            return
        try:
            for k, v in values.items():
                self.mon.stats.update(f"{name}_{k}", float(v))
            for k, payload in hists.items():
                self.mon.stats.update_hist(f"{name}_{k}", payload)
        except (ValueError, TypeError, AttributeError):
            return  # malformed measure: drop, never kill the endpoint


class Monitor:
    """UDP sink aggregating every node's measures (monitor.go:41-156)."""

    def __init__(
        self,
        port: int,
        data_filter: "DataFilter | None" = None,
        expected_keys: Sequence[str] = (),
    ):
        self.port = port
        self.stats = Stats(data_filter=data_filter, expected=expected_keys)
        self._transport = None

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        await loop.create_datagram_endpoint(
            lambda: _SinkProto(self), local_addr=("0.0.0.0", self.port)
        )

    def stop(self) -> None:
        if self._transport:
            self._transport.close()


class DataFilter:
    """Percentile outlier filter applied per key before aggregation
    (stats.go DataFilter): for each configured key, keep only samples at or
    below that key's given percentile. Keys not configured pass through."""

    def __init__(self, percentiles: Mapping[str, float] | None = None):
        self.percentiles = dict(percentiles or {})

    def apply(self, key: str, values: list[float]) -> list[float]:
        pct = self.percentiles.get(key)
        if pct is None or not values:
            return values
        ordered = sorted(values)
        # nearest-rank: the ceil(n*pct/100)-th smallest value is the cut
        rank = max(1, math.ceil(len(ordered) * pct / 100.0))
        cut = ordered[min(len(ordered), rank) - 1]
        return [v for v in values if v <= cut]


HIST_STATS = ("p50", "p90", "p99", "n")


class Stats:
    """Per-key streaming min/max/avg/sum/dev (stats.go:23-480), plus merged
    log-bucket histograms (`_p50/_p90/_p99/_n` columns) and a stable schema:
    a declared key with zero samples still emits its columns — as NaN, with
    a warning — so CSVs from degraded runs line up with healthy ones."""

    def __init__(
        self,
        extra: Mapping[str, float] | None = None,
        data_filter: DataFilter | None = None,
        expected: Sequence[str] = (),
    ):
        self._keys: dict[str, list[float]] = {}
        self._hists: dict[str, LogHistogram] = {}
        self._expected: set[str] = set(expected)
        self._gauges: set[str] = set()
        self.extra = dict(extra or {})
        self.filter = data_filter or DataFilter()

    def update(self, key: str, value: float) -> None:
        self._keys.setdefault(key, []).append(value)

    def update_hist(self, key: str, payload: Mapping) -> None:
        """Merge one sparse-histogram datagram (LogHistogram.merge_sparse)."""
        self._hists.setdefault(key, LogHistogram()).merge_sparse(payload)

    def declare(self, *keys: str, gauge: bool = False) -> None:
        """Pin keys into the schema: zero samples -> NaN columns + warning
        instead of silently narrowing the CSV (plots keyed on the column
        would otherwise drop the whole run). `gauge=True` additionally
        declares them point-in-time, so consumers never fall back to the
        name-suffix heuristic."""
        self._expected.update(keys)
        if gauge:
            self._gauges.update(keys)

    def is_gauge(self, key: str) -> bool:
        """Explicit declaration first, suffix heuristic as fallback."""
        return key in self._gauges or key.endswith(CounterIO.GAUGE_SUFFIXES)

    def gauge_keys(self) -> set[str]:
        return set(self._gauges)

    def _stat_keys(self) -> list[str]:
        return sorted(set(self._keys) | self._expected)

    def columns(self) -> list[str]:
        cols = sorted(self.extra)
        for key in self._stat_keys():
            cols += [f"{key}_{s}" for s in ("min", "max", "avg", "sum", "dev")]
        for key in sorted(self._hists):
            cols += [f"{key}_{s}" for s in HIST_STATS]
        return cols

    def row(self) -> list[float]:
        out = [self.extra[k] for k in sorted(self.extra)]
        for key in self._stat_keys():
            vs = self.filter.apply(key, self._keys.get(key, []))
            if not vs:
                warnings.warn(
                    f"stats key {key!r} has no samples this run; "
                    f"emitting NaN columns to keep the CSV schema stable",
                    RuntimeWarning,
                    stacklevel=2,
                )
                out += [float("nan")] * 5
                continue
            n = len(vs)
            avg = sum(vs) / n
            dev = math.sqrt(sum((v - avg) ** 2 for v in vs) / n)
            out += [min(vs), max(vs), avg, sum(vs), dev]
        for key in sorted(self._hists):
            h = self._hists[key]
            out += [h.quantile(0.5), h.quantile(0.9), h.quantile(0.99),
                    float(h.count)]
        return out

    def write_csv(self, path: str, append: bool = False) -> None:
        import csv as _csv

        mode = "a" if append else "w"
        with open(path, mode, newline="") as f:
            w = _csv.writer(f)
            if not append:
                w.writerow(self.columns())
            w.writerow([f"{v:.6g}" for v in self.row()])


class Rollup:
    """Hierarchical per-process metric rollup for the vnode swarm
    (swarm/): 65,536 identities cannot each push a CounterIO
    measure — the UDP sink and the CSV would drown — so each process folds
    its vnodes' `values()` maps into ONE record: counters summed, gauges
    averaged + maxed (the Stats.is_gauge classification), and a bounded
    top-k of the SLOWEST vnodes by an externally supplied figure (time to
    threshold), which is the per-vnode detail worth keeping at scale."""

    def __init__(self, top_k: int = 16):
        self.top_k = top_k
        self._n = 0
        self._counters: dict[str, float] = {}
        self._gauge_sum: dict[str, float] = {}
        self._gauge_max: dict[str, float] = {}
        self._gauge_n: dict[str, int] = {}
        self._heap: list[tuple[float, int]] = []  # min-heap of (slow, id)
        self._unfinished = 0

    def add(
        self,
        vnode_id: int,
        values: Mapping[str, float],
        gauge_keys: set[str] = frozenset(),
        slow_value: float | None = None,
    ) -> None:
        import heapq

        self._n += 1
        for k, v in values.items():
            if k in gauge_keys or k.endswith(CounterIO.GAUGE_SUFFIXES):
                self._gauge_sum[k] = self._gauge_sum.get(k, 0.0) + v
                self._gauge_n[k] = self._gauge_n.get(k, 0) + 1
                if v > self._gauge_max.get(k, -math.inf):
                    self._gauge_max[k] = v
            else:
                self._counters[k] = self._counters.get(k, 0.0) + v
        if slow_value is None:
            self._unfinished += 1
        elif len(self._heap) < self.top_k:
            heapq.heappush(self._heap, (slow_value, vnode_id))
        elif slow_value > self._heap[0][0]:
            heapq.heapreplace(self._heap, (slow_value, vnode_id))

    def record(self) -> dict:
        return {
            "vnodes": self._n,
            "unfinished": self._unfinished,
            "counters": dict(sorted(self._counters.items())),
            "gauges": {
                k: {
                    "mean": self._gauge_sum[k] / self._gauge_n[k],
                    "max": self._gauge_max[k],
                }
                for k in sorted(self._gauge_sum)
            },
            "slowest": [
                {"id": vid, "slow_s": s}
                for s, vid in sorted(self._heap, reverse=True)
            ],
        }
