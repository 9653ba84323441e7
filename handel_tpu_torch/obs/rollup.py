"""Hierarchical telemetry roll-ups — O(hosts) fleet observability, a copy of
handel_tpu/obs/rollup.py.

A master that keeps one reporter row, one labeled metric family, and one
raw span ring per *identity* of a fleet of many hosts melts long before
the hosts' memory does. This module collapses the per-identity surfaces
at the host and ships bounded digests:

``HostRollup`` folds a process's N reporter surfaces (swarm vnodes,
sessions, device lanes, federation regions) into one digest whose size
depends on the *key union*, never on N:

- counters are summed,
- gauges carry ``(sum, max, n)`` — NOT a pre-computed mean — so a
  second-level merge recombines exactly (mean of means is not the mean),
- ``LogHistogram``s merge through the existing sparse wire form,
- a *local* ``DetectorBank`` picks the top-K anomalous series so the
  master sees K rows, not every series,
- the trace ring is digested to per-stage totals plus the slowest causal
  chain (``sim.trace_cli.critical_path`` when the ring holds one) — raw
  span rings never leave the host.

The digest travels as a changed-keys-only delta (absolute values, never
increments, so redelivery is idempotent) chunked under the monitor
``Sink``'s 1400 B UDP budget.

``FleetRollup`` on the master ingests host digests. The merge is
order-invariant and two-level == flat (property-tested in
tests/test_rollup.py and tests/test_torch_rollup.py): counters add, gauge triples add/max, histograms
merge sparse, trace stages add with the slowest host's chain kept. It
exposes ``handel_fleet_*`` families with ``host`` labels, a ``/fleet``
JSON payload, and feeds the *same* ``AlertPlane`` the single-host
harnesses tick — merged counters become the (good, bad) burn sources,
hosts-up the page-on-loss series — preserving the
exactly-one-incident-per-outage contract with attribution that names the
offending host(s).
"""

from __future__ import annotations

import json
import time
from typing import Callable, Iterable, Mapping

from handel_tpu_torch.core.metrics import is_gauge_key
from handel_tpu_torch.core.trace import LogHistogram

from .detect import DetectorBank, EwmaDetector
from .slo import BurnRule

# Mirrors sim/monitor.py MAX_DATAGRAM (asserted equal in tests);
# obs/ stays importable without the sim package.
MAX_DATAGRAM = 1400

_SECTIONS = ("counters", "gauges", "hists")


def _json_len(obj) -> int:
    return len(json.dumps(obj).encode())


def trace_digest(events: list[dict], *, chain_tail: int = 8) -> dict:
    """Digest a traceEvents list to per-stage totals + the slowest chain.

    Bounded by the stage-name union, not the ring length. The causal
    chain comes from ``critical_path`` when the ring holds a threshold
    instant; otherwise the tail falls back to the slowest raw spans.
    """
    spans = [e for e in events if e.get("ph") == "X"]
    if not spans:
        return {}
    stages: dict[str, list] = {}
    t0 = None
    t1 = None
    for e in spans:
        st = stages.setdefault(e.get("name", "?"), [0.0, 0])
        dur = float(e.get("dur", 0.0))
        st[0] += dur / 1e3  # us -> ms
        st[1] += 1
        ts = float(e.get("ts", 0.0))
        t0 = ts if t0 is None else min(t0, ts)
        t1 = ts + dur if t1 is None else max(t1, ts + dur)
    out = {
        "wall_ms": (t1 - t0) / 1e3,
        "spans": len(spans),
        "stages_ms": {k: v[0] for k, v in sorted(stages.items())},
        "stage_ct": {k: v[1] for k, v in sorted(stages.items())},
    }
    try:
        from handel_tpu_torch.sim.trace_cli import critical_path

        cp = critical_path(events)
    except Exception:
        cp = None
    if cp:
        out["chain_tail"] = (cp.get("chain") or [])[-chain_tail:]
        out["chain_wall_ms"] = cp.get("wall_ms")
    else:
        slow = sorted(spans, key=lambda e: -float(e.get("dur", 0.0)))
        out["chain_tail"] = [
            {"stage": e.get("name", "?"),
             "ms": round(float(e.get("dur", 0.0)) / 1e3, 3)}
            for e in slow[:chain_tail]
        ]
    return out


def merge_trace_digests(parts: Iterable[tuple[str, dict]]) -> dict:
    """Order-invariant merge: stage totals add, the slowest host's chain
    wins (max wall is order-free)."""
    stages: dict[str, float] = {}
    stage_ct: dict[str, int] = {}
    spans = 0
    wall = 0.0
    chain: list = []
    slowest_host = ""
    for host, t in sorted(parts):
        if not t:
            continue
        spans += int(t.get("spans", 0))
        for k, v in t.get("stages_ms", {}).items():
            stages[k] = stages.get(k, 0.0) + v
        for k, v in t.get("stage_ct", {}).items():
            stage_ct[k] = stage_ct.get(k, 0) + int(v)
        w = float(t.get("wall_ms", 0.0))
        if w > wall:
            wall = w
            chain = t.get("chain_tail", [])
            slowest_host = host
    if not spans:
        return {}
    return {
        "wall_ms": wall,
        "spans": spans,
        "stages_ms": dict(sorted(stages.items())),
        "stage_ct": dict(sorted(stage_ct.items())),
        "chain_tail": chain,
        "slowest_host": slowest_host,
    }


class HostRollup:
    """Fold one process's reporter surfaces into a bounded digest.

    Sources are attached once; every ``digest()`` samples them fresh so
    the digest is a pure function of current state (delta encoding and
    redelivery idempotence fall out of that). ``fold`` sources cover the
    N-vnode case: a callable yielding ``(values, gauge_keys)`` per vnode
    keeps this object O(key-union) while walking O(N) surfaces.
    """

    def __init__(self, host: str, *, top_k: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        self.host = host
        self.top_k = top_k
        self.bank = DetectorBank(clock=clock)
        self.trace_source: Callable[[], list] | None = None
        self.seq = 0
        self.emits = 0
        self.bytes_sent = 0
        self.surfaces = 0
        self._reporters: list[tuple[str, object, frozenset | None]] = []
        self._folds: list[tuple[str, Callable[[], Iterable]]] = []
        self._last: dict = {}
        self.sample_errors = 0

    # -- source attachment ----------------------------------------------------

    def attach_reporter(self, plane: str, reporter,
                        gauges: Iterable[str] | None = None) -> None:
        """A live values()/gauge_keys()/histograms() surface, sampled at
        every digest."""
        g = frozenset(gauges) if gauges is not None else None
        self._reporters.append((plane, reporter, g))

    def attach_fold(self, plane: str,
                    fn: Callable[[], Iterable]) -> None:
        """``fn()`` yields ``(values, gauge_keys)`` pairs — one per vnode
        or session — folded into the shared key union."""
        self._folds.append((plane, fn))

    def watch(self, name: str, source: Callable[[], float | None],
              detector=None, **kw) -> None:
        """Attach a series to the local DetectorBank (top-K selection)."""
        self.bank.attach(name, source, detector or EwmaDetector(), **kw)

    def set_trace(self, trace_source: Callable[[], list]) -> None:
        self.trace_source = trace_source

    def tick(self, now: float | None = None):
        """Advance the local detectors (call on the harness cadence)."""
        return self.bank.tick(now)

    # -- digest ----------------------------------------------------------------

    @staticmethod
    def _fold_values(counters, gauges, plane, values, declared) -> None:
        for k, v in values.items():
            key = f"{plane}.{k}"
            if is_gauge_key(k, declared):
                g = gauges.get(key)
                if g is None:
                    gauges[key] = [float(v), float(v), 1]
                else:
                    g[0] += float(v)
                    g[1] = max(g[1], float(v))
                    g[2] += 1
            else:
                counters[key] = counters.get(key, 0.0) + float(v)

    def digest(self) -> dict:
        counters: dict[str, float] = {}
        gauges: dict[str, list] = {}
        hists: dict[str, LogHistogram] = {}
        surfaces = 0
        for plane, rep, declared in self._reporters:
            try:
                g = declared
                if g is None and hasattr(rep, "gauge_keys"):
                    g = frozenset(rep.gauge_keys())
                if hasattr(rep, "values"):
                    self._fold_values(counters, gauges, plane, rep.values(),
                                      g)
                    surfaces += 1
                if hasattr(rep, "histograms"):
                    for k, h in rep.histograms().items():
                        if not h.count:
                            continue
                        hists.setdefault(f"{plane}.{k}",
                                         LogHistogram()).merge(h)
            except Exception:
                # a dying surface (killed region, torn-down cluster) must
                # not take the whole host digest with it
                self.sample_errors += 1
        for plane, fn in self._folds:
            try:
                for item in fn():
                    values, gkeys = item
                    self._fold_values(counters, gauges, plane, values, gkeys)
                    surfaces += 1
            except Exception:
                self.sample_errors += 1
        self.surfaces = surfaces
        out = {
            "host": self.host,
            "seq": self.seq,
            "surfaces": surfaces,
            "counters": counters,
            "gauges": {k: {"s": g[0], "m": g[1], "n": g[2]}
                       for k, g in gauges.items()},
            "hists": {k: h.to_sparse() for k, h in hists.items()},
            "anoms": self.bank.top_anomalous(self.top_k),
        }
        if self.trace_source is not None:
            try:
                events = self.trace_source()
                out["trace"] = trace_digest(events) if events else {}
            except Exception:
                out["trace"] = {}
        return out

    def series_count(self) -> int:
        d = self.digest()
        return sum(len(d[s]) for s in _SECTIONS)

    # -- delta + wire ----------------------------------------------------------

    def delta(self) -> dict:
        """Changed-keys-only delta vs the last emission. Values are
        ABSOLUTE (never increments): re-applying any delta or chunk is a
        no-op, which is what makes UDP redelivery safe."""
        d = self.digest()
        full = not self._last
        self.seq += 1
        d["seq"] = self.seq
        out: dict = {"host": self.host, "seq": self.seq}
        if full:
            out["full"] = True
        for sec in _SECTIONS:
            prev = self._last.get(sec, {})
            cur = d[sec]
            changed = {k: v for k, v in cur.items()
                       if full or prev.get(k) != v}
            if changed:
                out[sec] = changed
            removed = sorted(set(prev) - set(cur))
            if removed:
                out.setdefault("removed", {})[sec] = removed
        for sec in ("anoms", "trace", "surfaces"):
            cur = d.get(sec)
            if cur is not None and (full or self._last.get(sec) != cur):
                out[sec] = cur
        self._last = d
        return out

    def emit(self, send: Callable[[dict], None] | None = None) -> int:
        """Delta -> chunks under the UDP budget -> ``send`` each.
        Returns bytes that went on the wire (counted even without a
        sender, so harnesses can measure the budget they'd spend)."""
        n = 0
        for payload in chunk_delta(self.delta()):
            n += _json_len(payload)
            if send is not None:
                send(payload)
        self.emits += 1
        self.bytes_sent += n
        return n

    # -- reporter surface (so a host rollup registers like anything else) ------

    def values(self) -> dict[str, float]:
        return {
            "rollupEmitsCt": float(self.emits),
            "rollupBytesCt": float(self.bytes_sent),
            "rollupSampleErrorsCt": float(self.sample_errors),
            "rollupSeq": float(self.seq),
            "rollupSurfaces": float(self.surfaces),
        }

    def gauge_keys(self) -> set[str]:
        return {"rollupSeq", "rollupSurfaces"}


def chunk_delta(delta: dict, budget: int = MAX_DATAGRAM) -> list[dict]:
    """Split a delta into ``{"rollup": {...}}`` payloads whose JSON stays
    under ``budget``. Every chunk repeats host/seq (and the full-replace
    flag) so chunks apply independently and in any order within a seq;
    histogram bucket maps split across chunks with lo/hi/sum repeated.
    A single oversized item still ships alone — truncation is never
    silent, the budget is a packing target. An empty delta yields one
    heartbeat chunk so liveness tracking keeps working."""
    head = {"host": delta["host"], "seq": delta["seq"]}
    if delta.get("full"):
        head["full"] = True
    base = _json_len({"rollup": head})
    chunks: list[dict] = []
    cur: dict = {}
    size = base

    def flush() -> None:
        nonlocal cur, size
        if cur:
            chunks.append({"rollup": {**head, **cur}})
        cur = {}
        size = base

    def put(section: str, key: str, value) -> None:
        nonlocal size
        item = _json_len({key: value}) + len(section) + 6
        if cur and size + item > budget:
            flush()
        cur.setdefault(section, {})[key] = value
        size += item

    for sec in ("surfaces", "anoms", "trace", "removed"):
        if sec in delta:
            item = _json_len({sec: delta[sec]}) + 4
            if cur and size + item > budget:
                flush()
            cur[sec] = delta[sec]
            size += item
    for sec in ("counters", "gauges"):
        for k in sorted(delta.get(sec, {})):
            put(sec, k, delta[sec][k])
    for k in sorted(delta.get("hists", {})):
        sparse = delta["hists"][k]
        meta = {"lo": sparse.get("lo", 0.0), "hi": sparse.get("hi", 0.0),
                "sum": sparse.get("sum", 0.0)}
        meta_cost = _json_len({k: {**meta, "b": {}}}) + 12
        buckets: dict = {}
        bsize = 0
        items = sorted(sparse.get("b", {}).items(), key=lambda kv: int(kv[0]))
        for bk, bv in items:
            cost = _json_len({bk: bv}) + 1
            if buckets and size + meta_cost + bsize + cost > budget:
                put("hists", k, {**meta, "b": buckets})
                flush()
                buckets = {}
                bsize = 0
            buckets[bk] = bv
            bsize += cost
        put("hists", k, {**meta, "b": buckets})
    flush()
    if not chunks:
        chunks.append({"rollup": dict(head)})
    return chunks


class _HostState:
    __slots__ = ("seq", "counters", "gauges", "hists", "anoms", "trace",
                 "surfaces", "last_seen", "lost")

    def __init__(self):
        self.seq = -1
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, dict] = {}
        self.hists: dict[str, dict] = {}
        self.anoms: list = []
        self.trace: dict = {}
        self.surfaces = 0
        self.last_seen = 0.0
        self.lost = False

    def reset(self):
        self.counters.clear()
        self.gauges.clear()
        self.hists.clear()
        self.anoms = []
        self.trace = {}


class FleetRollup:
    """Master-side merge of host digests + the alert-plane feed.

    ``ingest`` applies delta chunks (absolute values; stale seqs dropped,
    redelivery idempotent). ``merged()`` recombines across hosts in
    sorted-host order so the result is independent of arrival order and
    equal to a flat single-level fold of the same surfaces.
    """

    def __init__(self, *, top_k: int = 8, stale_after_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.top_k = top_k
        self.stale_after_s = stale_after_s
        self.clock = clock
        self._hosts: dict[str, _HostState] = {}
        self.ingests = 0
        self.ingest_bytes = 0
        self.stale_drops = 0
        self.merges = 0
        self.last_merge_ms = 0.0

    # -- ingest ----------------------------------------------------------------

    def ingest(self, payload: Mapping, now: float | None = None) -> bool:
        """Apply one delta chunk. Returns False when dropped as stale."""
        r = payload.get("rollup", payload)
        host = r.get("host")
        seq = int(r.get("seq", 0))
        if not host:
            return False
        st = self._hosts.setdefault(host, _HostState())
        if seq < st.seq:
            self.stale_drops += 1
            return False
        if seq > st.seq:
            if r.get("full"):
                st.reset()
            st.seq = seq
        st.last_seen = self.clock() if now is None else now
        st.lost = False
        self.ingests += 1
        self.ingest_bytes += _json_len(dict(r))
        st.counters.update(r.get("counters", {}))
        st.gauges.update(r.get("gauges", {}))
        for k, sparse in r.get("hists", {}).items():
            h = st.hists.setdefault(k, {"b": {}, "lo": 0.0, "hi": 0.0,
                                        "sum": 0.0})
            # bucket counts are monotone within a host, so replace-by-key
            # over the chunked absolute map reassembles the exact state
            # and re-applying any chunk is a no-op
            h["b"].update(sparse.get("b", {}))
            h["lo"] = sparse.get("lo", h["lo"])
            h["hi"] = sparse.get("hi", h["hi"])
            h["sum"] = sparse.get("sum", h["sum"])
        for sec, keys in r.get("removed", {}).items():
            store = getattr(st, sec, None)
            if isinstance(store, dict):
                for k in keys:
                    store.pop(k, None)
        if "anoms" in r:
            st.anoms = r["anoms"]
        if "trace" in r:
            st.trace = r["trace"]
        if "surfaces" in r:
            st.surfaces = int(r["surfaces"])
        return True

    def ingest_digest(self, digest: Mapping,
                      now: float | None = None) -> bool:
        """File-based path: apply a full digest as a full-replace delta."""
        return self.ingest({**dict(digest), "full": True}, now=now)

    # -- liveness --------------------------------------------------------------

    def mark_lost(self, host: str) -> None:
        self._hosts.setdefault(host, _HostState()).lost = True

    def lost_hosts(self, now: float | None = None) -> list[str]:
        t = self.clock() if now is None else now
        out = []
        for host, st in self._hosts.items():
            stale = (self.stale_after_s > 0
                     and t - st.last_seen > self.stale_after_s)
            if st.lost or stale:
                out.append(host)
        return sorted(out)

    def hosts_up(self, now: float | None = None) -> int:
        return len(self._hosts) - len(self.lost_hosts(now))

    # -- merge -----------------------------------------------------------------

    def merged(self) -> dict:
        t0 = time.perf_counter()
        counters: dict[str, float] = {}
        gauges: dict[str, list] = {}
        hists: dict[str, LogHistogram] = {}
        anoms: list = []
        traces: list = []
        surfaces = 0
        for host in sorted(self._hosts):
            st = self._hosts[host]
            surfaces += st.surfaces
            for k, v in st.counters.items():
                counters[k] = counters.get(k, 0.0) + v
            for k, g in st.gauges.items():
                cur = gauges.get(k)
                if cur is None:
                    gauges[k] = [g["s"], g["m"], g["n"]]
                else:
                    cur[0] += g["s"]
                    cur[1] = max(cur[1], g["m"])
                    cur[2] += g["n"]
            for k, sparse in st.hists.items():
                hists.setdefault(k, LogHistogram()).merge_sparse(sparse)
            anoms.extend({**a, "host": host} for a in st.anoms)
            if st.trace:
                traces.append((host, st.trace))
        anoms.sort(key=lambda a: -abs(a.get("z", 0.0)))
        out = {
            "hosts": len(self._hosts),
            "surfaces": surfaces,
            "counters": dict(sorted(counters.items())),
            "gauges": {k: {"s": g[0], "m": g[1], "n": g[2]}
                       for k, g in sorted(gauges.items())},
            "hists": hists,
            "anoms": anoms[:self.top_k],
            "trace": merge_trace_digests(traces),
        }
        out["series"] = sum(len(out[s]) for s in _SECTIONS)
        self.merges += 1
        self.last_merge_ms = (time.perf_counter() - t0) * 1e3
        return out

    def merged_counters(self) -> dict[str, float]:
        """Cheap counter-only merge for burn/series sources."""
        counters: dict[str, float] = {}
        for host in sorted(self._hosts):
            for k, v in self._hosts[host].counters.items():
                counters[k] = counters.get(k, 0.0) + v
        return counters

    def series_count(self) -> int:
        return self.merged()["series"]

    # -- alert-plane feed ------------------------------------------------------

    def burn_source(self, good_key: str,
                    bad_key: str) -> Callable[[], tuple[float, float]]:
        """Cumulative (good, bad) counts for a BurnRule, merged fleet-wide."""
        def src() -> tuple[float, float]:
            c = self.merged_counters()
            return c.get(good_key, 0.0), c.get(bad_key, 0.0)
        return src

    def series_source(self, key: str) -> Callable[[], float | None]:
        """A merged counter (sum) or gauge (mean) as a detector series."""
        def src() -> float | None:
            c = self.merged_counters()
            if key in c:
                return c[key]
            for host in sorted(self._hosts):
                g = self._hosts[host].gauges.get(key)
                if g is not None:
                    s = n = 0.0
                    for h2 in sorted(self._hosts):
                        g2 = self._hosts[h2].gauges.get(key)
                        if g2 is not None:
                            s += g2["s"]
                            n += g2["n"]
                    return s / n if n else None
            return None
        return src

    def attach_alerts(self, plane, *,
                      burn_rules: Iterable[tuple[BurnRule, str, str]] = (),
                      series: Iterable[tuple[str, str]] = (),
                      z_threshold: float = 6.0, ewma_alpha: float = 0.3,
                      min_consecutive: int = 1) -> None:
        """Feed the SAME AlertPlane the single-host harnesses tick.

        Burn rules read merged fleet counters; a hosts-up series pages on
        host loss and holds the incident open while any host stays lost,
        so one outage maps to exactly one incident — and the attribution
        snapshot names the offending host(s) via the lost_hosts context.
        """
        for rule, good_key, bad_key in burn_rules:
            plane.evaluator.add_rule(rule, self.burn_source(good_key,
                                                            bad_key))
        plane.detectors.attach(
            "fleet-hosts-up", lambda: float(self.hosts_up()),
            EwmaDetector(alpha=ewma_alpha, z_threshold=z_threshold,
                         warmup=2),
            min_consecutive=min_consecutive, opens_incident=True,
            direction="down", hold_while=lambda: bool(self.lost_hosts()),
        )
        for name, key in series:
            plane.detectors.attach(
                name, self.series_source(key),
                EwmaDetector(alpha=ewma_alpha, z_threshold=z_threshold),
                min_consecutive=min_consecutive,
            )
        plane.add_context("lost_hosts", self.lost_hosts)
        plane.add_context("fleet", lambda: {
            "hosts": len(self._hosts), "hosts_up": self.hosts_up(),
            "series": self.series_count(),
        })

    # -- metrics + /fleet ------------------------------------------------------

    def values(self) -> dict[str, float]:
        up = self.hosts_up()
        return {
            "hostsTotal": float(len(self._hosts)),
            "hostsUp": float(up),
            "hostsDown": float(len(self._hosts) - up),
            "seriesTotal": float(self.series_count()),
            "ingestsCt": float(self.ingests),
            "ingestBytesCt": float(self.ingest_bytes),
            "staleDropsCt": float(self.stale_drops),
            "mergesCt": float(self.merges),
            "lastMergeMs": self.last_merge_ms,
        }

    def gauge_keys(self) -> set[str]:
        return {"hostsTotal", "hostsUp", "hostsDown", "seriesTotal",
                "lastMergeMs"}

    def labeled_values(self) -> dict[str, dict[str, float]]:
        lost = set(self.lost_hosts())
        out: dict[str, dict[str, float]] = {}
        for host in sorted(self._hosts):
            st = self._hosts[host]
            row: dict[str, float] = {
                "hostUp": 0.0 if host in lost else 1.0,
                "digestSeq": float(st.seq),
                "seriesCt": float(len(st.counters) + len(st.gauges)
                                  + len(st.hists)),
                "topZ": max((abs(a.get("z", 0.0)) for a in st.anoms),
                            default=0.0),
            }
            row.update(st.counters)
            for k, g in st.gauges.items():
                row[k] = g["s"] / g["n"] if g["n"] else 0.0
            out[host] = row
        return out

    def labeled_gauge_keys(self) -> set[str]:
        out = {"hostUp", "digestSeq", "seriesCt", "topZ"}
        for st in self._hosts.values():
            out.update(st.gauges)
        return out

    def histograms(self) -> dict[str, LogHistogram]:
        return self.merged()["hists"]

    def fleet_payload(self) -> dict:
        """The /fleet JSON endpoint body."""
        m = self.merged()
        return {
            "hosts": {h: {"up": h not in set(self.lost_hosts()),
                          "seq": st.seq,
                          "surfaces": st.surfaces,
                          "series": len(st.counters) + len(st.gauges)
                          + len(st.hists),
                          "top_anomalous": st.anoms}
                      for h, st in sorted(self._hosts.items())},
            "hosts_up": self.hosts_up(),
            "lost_hosts": self.lost_hosts(),
            "series_total": m["series"],
            "surfaces": m["surfaces"],
            "top_anomalous": m["anoms"],
            "trace": m["trace"],
            "ingests": self.ingests,
            "ingest_bytes": self.ingest_bytes,
            "last_merge_ms": round(self.last_merge_ms, 3),
        }

    def register_metrics(self, registry) -> None:
        """handel_fleet_* families (host-labeled rows + merged
        histograms) and the /fleet endpoint on an existing registry."""
        registry.register_values("fleet", self)
        registry.register_labeled_values("fleet", self, label="host")
        registry.register_histograms("fleet", self)
        registry.set_fleet_source(self.fleet_payload)
