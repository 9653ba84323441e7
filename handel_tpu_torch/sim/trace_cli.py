"""Trace-analysis CLI: reconstruct the aggregation wave from trace dumps — a
copy of handel_tpu/sim/trace_cli.py.

`python -m handel_tpu_torch.sim trace <run-trace-dir | trace.json ...>` loads
the per-process Chrome `trace_event` dumps a traced run leaves behind
(sim/node.py --trace-dir, or FlightRecorder.dump from an in-process
cluster) and answers the questions the CSV cannot:

- the aggregation wave: per level, when the first / median / last node
  completed it (the completion-time curve, observed per run);
- slowest-span attribution: which pipeline stage (recv, queue, verify,
  merge, dispatch_pack, device_verify, net_transit) the wall time went to;
- per-contribution chains: recv -> queue -> verify -> merge span coverage,
  surfacing where a contribution stalled;
- the CRITICAL PATH to threshold (`--critical-path`): walk the
  threshold-reaching merge backwards through verify/queue/recv/net_transit
  and across processes via the packet span ids (flow links) to a
  contributor's first send, with per-stage (net/queue/verify/merge/device)
  attribution — the causal answer to "why did this run take X ms".

Options: `--merged out.json` writes the combined timeline (open in
chrome://tracing or Perfetto); `--top N` bounds the attribution table;
`--report out.json` writes the machine-readable `trace_report.json`. Both
packages' CLIs give the same report for the same files. `--plot out.png`
draws the wave via sim/plots.py (needs `matplotlib`).
"""

from __future__ import annotations

import argparse
import glob
import heapq
import json
import math
import os
import sys
from array import array
from collections import OrderedDict

from handel_tpu_torch.core.trace import merge_traces

#: pipeline spans that make up a contribution's recv -> merge chain
CHAIN_SPANS = ("recv", "queue", "verify", "merge")

#: chain span name -> critical-path attribution stage
STAGE_OF = {
    "net_transit": "net",
    "recv": "recv",
    "queue": "queue",
    "verify": "verify",
    "merge": "merge",
    "send": "send",
}


def resolve_trace_files(paths: list[str]) -> list[str]:
    """Expand directories into their trace dumps (node trace_*.json and
    swarm swarm_trace_*.json both count)."""
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, "trace_*.json"))))
            files.extend(
                sorted(glob.glob(os.path.join(p, "swarm_trace_*.json")))
            )
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"no trace_*.json under {paths}")
    return files


def load_exports(paths: list[str]) -> list[dict]:
    """Load the raw per-process exports (clockOffset intact). Holds every
    file at once — fine for small runs and the merge/plot paths; the
    analysis pipeline itself streams (`stream_report`), because a 65k-node
    swarm's dumps do not fit an analyst laptop's memory all at once."""
    exports = []
    for f in resolve_trace_files(paths):
        with open(f) as fh:
            exports.append(json.load(fh))
    return exports


def load_traces(paths: list[str]) -> list[dict]:
    """Load trace events from files and/or directories of trace_*.json."""
    return merge_traces(load_exports(paths))["traceEvents"]


def _t0(events: list[dict]) -> float:
    tss = [e["ts"] for e in events if e.get("ph") in ("X", "i")]
    return min(tss) if tss else 0.0


def level_timeline(events: list[dict]) -> dict[int, tuple[float, float, float]]:
    """Per protocol level: (first, median, last) completion time in seconds
    relative to the earliest event — the aggregation wave."""
    t0 = _t0(events)
    by_level: dict[int, list[float]] = {}
    for e in events:
        if e.get("ph") == "i" and e.get("name") == "level_complete":
            lvl = int(e.get("args", {}).get("level", -1))
            by_level.setdefault(lvl, []).append((e["ts"] - t0) / 1e6)
    out = {}
    for lvl, tss in sorted(by_level.items()):
        tss.sort()
        out[lvl] = (tss[0], tss[len(tss) // 2], tss[-1])
    return out


def span_table(events: list[dict]) -> list[dict]:
    """Aggregate complete ("X") spans by name: count/total/mean/max (ms),
    sorted by total descending — the slowest-span attribution table."""
    agg: dict[str, list[float]] = {}
    for e in events:
        if e.get("ph") == "X":
            agg.setdefault(e["name"], []).append(e.get("dur", 0.0) / 1e3)
    rows = []
    for name, durs in agg.items():
        rows.append(
            {
                "name": name,
                "count": len(durs),
                "total_ms": sum(durs),
                "mean_ms": sum(durs) / len(durs),
                "max_ms": max(durs),
            }
        )
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def contribution_chains(events: list[dict]) -> dict[tuple, dict]:
    """Group pipeline spans into per-contribution chains keyed by
    (pid, tid, origin, level, rts, ind) — `rts` is the arrival stamp that
    separates re-deliveries of the same aggregate, `ind` splits a packet's
    multisig from its piggybacked individual sig (they share one recv).
    Coverage is the UNION of the chain's span intervals over the
    recv-start -> merge-end wall — the fraction of a contribution's life
    the trace can attribute to a pipeline stage."""
    recvs: dict[tuple, dict] = {}
    chains: dict[tuple, list[dict]] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("name") not in CHAIN_SPANS:
            continue
        a = e.get("args", {})
        if "origin" not in a or "level" not in a or "rts" not in a:
            continue
        pkt_key = (e.get("pid", 0), e.get("tid", 0), a["origin"], a["level"],
                   a["rts"])
        if e["name"] == "recv":
            recvs[pkt_key] = e
        else:
            chains.setdefault(pkt_key + (bool(a.get("ind")),), []).append(e)
    out = {}
    for key, evs in chains.items():
        recv = recvs.get(key[:-1])
        if recv is None:
            continue
        evs = evs + [recv]
        names = {e["name"] for e in evs}
        if "merge" not in names:
            continue  # incomplete chain (e.g. never verified)
        start = recv["ts"]
        end = max(e["ts"] + e.get("dur", 0.0) for e in evs if e["name"] == "merge")
        wall = end - start
        ivs = sorted(
            (max(e["ts"], start), min(e["ts"] + e.get("dur", 0.0), end))
            for e in evs
        )
        covered, cur_lo, cur_hi = 0.0, None, None
        for lo, hi in ivs:
            if hi <= lo:
                continue
            if cur_hi is None or lo > cur_hi:
                if cur_hi is not None:
                    covered += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        if cur_hi is not None:
            covered += cur_hi - cur_lo
        out[key] = {
            "wall_ms": wall / 1e3,
            "coverage": covered / wall if wall > 0 else 1.0,
            "stages": {
                n: sum(e.get("dur", 0.0) for e in evs if e["name"] == n) / 1e3
                for n in sorted(names)
            },
        }
    return out


def _interval_union(ivs: list[tuple[float, float]]) -> float:
    """Total length of the union of [lo, hi) intervals (µs in, µs out)."""
    covered, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(ivs):
        if hi <= lo:
            continue
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                covered += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        covered += cur_hi - cur_lo
    return covered


class _TraceIndex:
    """The span indexes the critical-path walk needs — built over one
    process's export (streamed path) or the whole merged run
    (`critical_path`)."""

    def __init__(self, events: list[dict] = ()):
        self.merges: dict[tuple, list[dict]] = {}
        self.pipeline: dict[tuple, dict[str, list[dict]]] = {}
        self.transits: dict[tuple, list[dict]] = {}
        self.sends: dict[int, dict] = {}
        self.device_ivs: dict[int, list[tuple[float, float]]] = {}
        if events:
            self.add_events(events)

    def add_events(self, events: list[dict]) -> None:
        for e in events:
            if e.get("ph") != "X":
                continue
            name, a = e.get("name"), e.get("args", {})
            pt = (e.get("pid", 0), e.get("tid", 0))
            if name == "merge":
                self.merges.setdefault(pt, []).append(e)
            if name in ("merge", "verify", "queue", "recv") and "rts" in a:
                key = pt + (a.get("origin"), a.get("level"), a["rts"])
                self.pipeline.setdefault(key, {}).setdefault(
                    name, []
                ).append(e)
            elif name == "net_transit":
                self.transits.setdefault(
                    pt + (a.get("origin"), a.get("level")), []
                ).append(e)
            elif name == "send" and a.get("span"):
                self.sends[a["span"]] = e
            elif name == "device_verify":
                self.device_ivs.setdefault(e.get("pid", 0), []).append(
                    (e["ts"], e["ts"] + e.get("dur", 0.0))
                )
        for evs in self.merges.values():
            evs.sort(key=lambda e: e["ts"] + e.get("dur", 0.0))

    def enclosing_merge(self, pt: tuple, ts: float) -> dict | None:
        """The merge containing ts on (pid, tid), else the latest one
        ending at/before ts (a periodic resend of an earlier merge)."""
        best = None
        for m in self.merges.get(pt, ()):
            lo, hi = m["ts"], m["ts"] + m.get("dur", 0.0)
            if lo <= ts <= hi:
                return m
            if hi <= ts:
                best = m  # sorted by end: the last such wins
        return best

    @staticmethod
    def pick(evs: list[dict] | None, span: int) -> dict | None:
        """Prefer the event whose span arg matches; else the longest."""
        if not evs:
            return None
        same = [e for e in evs if e.get("args", {}).get("span") == span]
        pool = same or evs
        return max(pool, key=lambda e: e.get("dur", 0.0))


def _walk_chain(anchor: dict, index_of, send_of) -> list[dict]:
    """The backwards walk shared by `critical_path` and `stream_report`:
    `index_of(pid)` resolves a process's _TraceIndex (the streamed path
    loads it lazily), `send_of(span)` resolves a packet span id to the
    sender's send event wherever that process's dump lives."""
    chain: list[dict] = []
    visited: set[tuple] = set()
    idx = index_of(anchor.get("pid", 0))
    cur = None
    if idx is not None:
        cur = idx.enclosing_merge(
            (anchor.get("pid", 0), anchor.get("tid", 0)), anchor["ts"]
        )
    while cur is not None:
        pt = (cur.get("pid", 0), cur.get("tid", 0))
        mkey = pt + (cur["ts"],)  # value identity: stable across reloads
        if mkey in visited:
            break
        visited.add(mkey)
        a = cur.get("args", {})
        key = pt + (a.get("origin"), a.get("level"), a.get("rts"))
        span = a.get("span", 0)
        hop = [cur]
        stages = idx.pipeline.get(key, {})
        for name in ("verify", "queue", "recv"):
            m = _TraceIndex.pick(stages.get(name), span)
            if m is not None:
                hop.append(m)
        nt = _TraceIndex.pick(
            idx.transits.get(pt + (a.get("origin"), a.get("level"))), span
        )
        if nt is not None:
            hop.append(nt)
        chain.extend(hop)
        send = send_of(span) if span else None
        if send is None:
            break
        chain.append(send)
        idx = index_of(send.get("pid", 0))
        cur = None
        if idx is not None:
            cur = idx.enclosing_merge(
                (send.get("pid", 0), send.get("tid", 0)), send["ts"]
            )
    return chain


def _chain_to_report(chain: list[dict], anchor: dict, device_ivs_of) -> dict:
    """Fold a walked chain into the critical-path report dict;
    `device_ivs_of(pid)` yields that process's device_verify intervals for
    the verify -> device re-attribution."""
    chain = list(reversed(chain))  # origin-first: send ... -> final merge
    start = min(e["ts"] for e in chain) if chain else anchor["ts"]
    wall = anchor["ts"] - start
    ivs = [
        (e["ts"], min(e["ts"] + e.get("dur", 0.0), anchor["ts"]))
        for e in chain
    ]
    stages_us: dict[str, float] = {}
    for e in chain:
        stage = STAGE_OF.get(e["name"], e["name"])
        lo, hi = e["ts"], min(e["ts"] + e.get("dur", 0.0), anchor["ts"])
        dur = max(0.0, hi - lo)
        if e["name"] == "verify":
            # chip wall inside the verify window attributes to `device`
            on_dev = _interval_union([
                (max(lo, dlo), min(hi, dhi))
                for dlo, dhi in device_ivs_of(e.get("pid", 0))
                if dhi > lo and dlo < hi
            ])
            stages_us["device"] = stages_us.get("device", 0.0) + on_dev
            dur -= on_dev
        stages_us[stage] = stages_us.get(stage, 0.0) + dur
    # region-pair attribution (scenario engine, network/geo.py): every
    # cross-node hop pairs the sender's span region tag with the first
    # downstream span recorded by a DIFFERENT node — "eu-west->ap-east"
    # strings naming where the critical path's WAN time went
    region_hops: list[str] = []
    for i, e in enumerate(chain):
        if e["name"] != "send":
            continue
        src = e.get("args", {}).get("region")
        here = (e.get("pid", 0), e.get("tid", 0))
        dst = None
        for nxt in chain[i + 1:]:
            r = nxt.get("args", {}).get("region")
            if r and (nxt.get("pid", 0), nxt.get("tid", 0)) != here:
                dst = r
                break
        if src and dst:
            region_hops.append(f"{src}->{dst}")
    return {
        "anchor": {
            "pid": anchor.get("pid", 0),
            "tid": anchor.get("tid", 0),
            "args": anchor.get("args", {}),
        },
        "threshold_ts": anchor["ts"],
        "start_ts": start,
        "wall_ms": wall / 1e3,
        "coverage": _interval_union(ivs) / wall if wall > 0 else 1.0,
        "hops": sum(1 for e in chain if e["name"] == "send"),
        "stages_ms": {k: v / 1e3 for k, v in sorted(stages_us.items())},
        "region_hops": region_hops,
        "chain": [
            {
                "name": e["name"],
                "pid": e.get("pid", 0),
                "tid": e.get("tid", 0),
                "t_ms": (e["ts"] - start) / 1e3,
                "dur_ms": e.get("dur", 0.0) / 1e3,
                "origin": e.get("args", {}).get("origin"),
                "level": e.get("args", {}).get("level"),
                "span": e.get("args", {}).get("span"),
                "region": e.get("args", {}).get("region"),
            }
            for e in chain
        ],
    }


def critical_path(events: list[dict]) -> dict | None:
    """Walk the threshold-reaching aggregate backwards to a contributor's
    first send — the slowest CAUSAL chain, not a heuristic stitching.

    Anchor: the fleet's earliest `threshold_reached` instant. From the
    merge span enclosing it, the local pipeline is matched by
    (pid, tid, origin, level, rts); the cross-process hop resolves the
    merge's packet span id to the SENDER's `send` span, then recurses into
    the merge that produced that send (fast-path sends happen inside the
    producing merge's interval, core/handel.py _check_completed_level).
    The walk ends at a send with no producing merge — the contribution's
    origin. Returns None when the trace holds no threshold instant.

    Verify time overlapping the shared service's `device_verify` launches
    (same process) is re-attributed to the `device` stage, so host-queue
    wait and chip wall are separated in the stage breakdown.
    """
    thresholds = [
        e for e in events
        if e.get("ph") == "i" and e.get("name") == "threshold_reached"
    ]
    if not thresholds:
        return None
    anchor = min(thresholds, key=lambda e: e["ts"])
    idx = _TraceIndex(events)
    chain = _walk_chain(anchor, lambda pid: idx, idx.sends.get)
    return _chain_to_report(
        chain, anchor, lambda pid: idx.device_ivs.get(pid, ())
    )


def flow_linkage(events: list[dict]) -> tuple[float, int, int]:
    """(linked fraction, linked, total) over recv spans that carry a trace
    context: a recv is LINKED when its packet span id resolves to a send
    span somewhere in the merged trace. Unlinked recvs are degraded
    contexts (span 0) or senders whose dump is missing."""
    send_ids = {
        e["args"]["span"]
        for e in events
        if e.get("ph") == "X" and e.get("name") == "send"
        and e.get("args", {}).get("span")
    }
    total = linked = 0
    for e in events:
        if e.get("ph") != "X" or e.get("name") != "recv":
            continue
        a = e.get("args", {})
        if "span" not in a:
            continue  # a trace recorded without flow links
        total += 1
        if a["span"] and a["span"] in send_ids:
            linked += 1
    return (linked / total if total else 0.0), linked, total


def lane_occupancy(events: list[dict]) -> dict:
    """Per device lane: on-device busy fraction over the lane's active
    window (union of its launch_on_device / launch_on_mesh spans,
    first-to-last extent), plus the fleet mean — the timeline form of the
    plane's fill gauges. Mesh launches keep their own span name (distinct
    attribution in the span table) but busy a lane like any other."""
    by_lane: dict[tuple, list[tuple[float, float]]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") in (
            "launch_on_device", "launch_on_mesh",
        ):
            by_lane.setdefault(
                (e.get("pid", 0), e.get("tid", 0)), []
            ).append((e["ts"], e["ts"] + e.get("dur", 0.0)))
    lanes = {}
    for (pid, tid), ivs in sorted(by_lane.items()):
        window = max(hi for _, hi in ivs) - min(lo for lo, _ in ivs)
        lanes[f"{pid}/{tid}"] = (
            _interval_union(ivs) / window if window > 0 else 1.0
        )
    mean = sum(lanes.values()) / len(lanes) if lanes else 0.0
    return {"mean": mean, "lanes": lanes}


def _load_shifted(path: str) -> tuple[dict, list[dict]]:
    """One export, its clock offset already applied to event timestamps
    (the per-file half of core/trace.py merge_traces)."""
    with open(path) as fh:
        ex = json.load(fh)
    evs = ex.get("traceEvents", [])
    off = float(ex.get("clockOffset", 0.0) or 0.0) * 1e6
    if off:
        for e in evs:
            if "ts" in e:
                e["ts"] += off
    return ex, evs


class _ExportStream:
    """Lazy per-process _TraceIndex cache for the streamed critical-path
    walk: the walk touches O(hops) processes, so at most `cap` dumps are
    ever resident at once."""

    def __init__(self, file_of_pid: dict[int, str], cap: int = 4):
        self._files = file_of_pid
        self._cache: OrderedDict[str, _TraceIndex] = OrderedDict()
        self._cap = cap

    def index_of(self, pid: int) -> _TraceIndex | None:
        f = self._files.get(pid)
        if f is None:
            return None
        idx = self._cache.get(f)
        if idx is None:
            idx = _TraceIndex(_load_shifted(f)[1])
            self._cache[f] = idx
            while len(self._cache) > self._cap:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(f)
        return idx


def stream_report(paths: list[str], top_k: int = 10) -> dict:
    """build_report over trace dumps WITHOUT holding them all in memory:
    one pass, one file resident at a time — a 65,536-vnode swarm's dumps
    don't fit an analyst machine all at once. Per-file events fold into
    bounded state (level-wave timestamp arrays, span count/total/max,
    span-id -> pid for the cross-process hops, a top-k heap of the slowest
    contribution chains); the critical path then walks backwards loading
    only the O(hops) dumps it actually visits (_ExportStream)."""
    files = resolve_trace_files(paths)
    t0 = math.inf
    anchor: dict | None = None
    level_ts: dict[int, array] = {}
    span_agg: dict[str, list[float]] = {}
    send_pid: dict[int, int] = {}
    recv_span_ct: dict[int, int] = {}
    recv_total = 0
    lane_ivs: dict[tuple, list[tuple[float, float]]] = {}
    file_of_pid: dict[int, str] = {}
    offsets: list[float] = []
    heap: list[tuple] = []
    chain_ct, cov_sum, cov_min = 0, 0.0, math.inf
    seq = events_total = 0

    for f in files:
        ex, evs = _load_shifted(f)
        offsets.append(float(ex.get("clockOffset", 0.0) or 0.0))
        for e in evs:
            ph = e.get("ph")
            if ph not in ("X", "i"):
                continue
            events_total += 1
            ts = e["ts"]
            if ts < t0:
                t0 = ts
            pid = e.get("pid", 0)
            if pid not in file_of_pid:
                file_of_pid[pid] = f
            name = e.get("name")
            if ph == "i":
                if name == "level_complete":
                    lvl = int(e.get("args", {}).get("level", -1))
                    level_ts.setdefault(lvl, array("d")).append(ts)
                elif name == "threshold_reached" and (
                    anchor is None or ts < anchor["ts"]
                ):
                    anchor = e
                continue
            dur = e.get("dur", 0.0)
            row = span_agg.get(name)
            if row is None:
                span_agg[name] = [1, dur, dur]
            else:
                row[0] += 1
                row[1] += dur
                if dur > row[2]:
                    row[2] = dur
            a = e.get("args", {})
            if name == "send":
                if a.get("span"):
                    send_pid[a["span"]] = pid
            elif name == "recv":
                if "span" in a:
                    recv_total += 1
                    if a["span"]:
                        recv_span_ct[a["span"]] = (
                            recv_span_ct.get(a["span"], 0) + 1
                        )
            elif name in ("launch_on_device", "launch_on_mesh"):
                lane_ivs.setdefault((pid, e.get("tid", 0)), []).append(
                    (ts, ts + dur)
                )
        # chain spans for one contribution all live on the recipient's
        # recorder, so per-file chain extraction is exact
        for key, c in contribution_chains(evs).items():
            chain_ct += 1
            cov_sum += c["coverage"]
            if c["coverage"] < cov_min:
                cov_min = c["coverage"]
            seq += 1
            item = (c["wall_ms"], seq, key, c)
            if len(heap) < top_k:
                heapq.heappush(heap, item)
            elif item[0] > heap[0][0]:
                heapq.heapreplace(heap, item)
        del ex, evs

    cp = None
    if anchor is not None:
        stream = _ExportStream(file_of_pid)

        def send_of(span: int) -> dict | None:
            spid = send_pid.get(span)
            if spid is None:
                return None
            idx = stream.index_of(spid)
            return idx.sends.get(span) if idx is not None else None

        def device_ivs_of(pid: int):
            idx = stream.index_of(pid)
            return idx.device_ivs.get(pid, ()) if idx is not None else ()

        chain = _walk_chain(anchor, stream.index_of, send_of)
        cp = _chain_to_report(chain, anchor, device_ivs_of)

    wave = {}
    for lvl in sorted(level_ts):
        srt = sorted(level_ts[lvl])
        wave[str(lvl)] = {
            "first": (srt[0] - t0) / 1e6,
            "median": (srt[len(srt) // 2] - t0) / 1e6,
            "last": (srt[-1] - t0) / 1e6,
        }
    linked = sum(
        ct for span, ct in recv_span_ct.items() if span in send_pid
    )
    lanes = {}
    for (pid, tid), ivs in sorted(lane_ivs.items()):
        window = max(hi for _, hi in ivs) - min(lo for lo, _ in ivs)
        lanes[f"{pid}/{tid}"] = (
            _interval_union(ivs) / window if window > 0 else 1.0
        )
    tts = cp["wall_ms"] / 1e3 if cp else 0.0
    return {
        "metric": "trace_time_to_threshold_s",
        "value": tts,
        "backend": "trace",
        "time_to_threshold_s": tts,
        "critical_path_coverage": cp["coverage"] if cp else 0.0,
        "critical_path_len": cp["hops"] if cp else 0,
        "flow_linkage": (linked / recv_total) if recv_total else 0.0,
        "flow_linked": linked,
        "flow_total": recv_total,
        "lane_occupancy": (
            sum(lanes.values()) / len(lanes) if lanes else 0.0
        ),
        "lanes": lanes,
        "critical_path": cp,
        "levels_s": wave,
        "level_wave": wave,
        "span_table": [
            {
                "name": n,
                "count": int(c),
                "total_ms": tot / 1e3,
                "mean_ms": tot / c / 1e3,
                "max_ms": mx / 1e3,
            }
            for n, (c, tot, mx) in sorted(
                span_agg.items(), key=lambda kv: -kv[1][1]
            )
        ],
        "chains": {
            "count": chain_ct,
            "coverage_min": cov_min if chain_ct else 0.0,
            "coverage_mean": cov_sum / chain_ct if chain_ct else 0.0,
            "slowest": [
                {
                    "pid": key[0],
                    "tid": key[1],
                    "origin": key[2],
                    "level": key[3],
                    **c,
                }
                for _, _, key, c in sorted(heap, reverse=True)
            ],
        },
        "clock_offsets_s": offsets,
        "events": events_total,
        "files": len(files),
    }


def build_report(events: list[dict], exports: list[dict] | None = None) -> dict:
    """The machine-readable `trace_report.json`: bench-record shaped
    (metric/value/backend, scripts/bench_check.py extract_metrics) with the
    critical-path breakdown, per-level wave, flow linkage, lane occupancy
    and the per-process clock offsets as payload."""
    cp = critical_path(events)
    linkage, linked, total = flow_linkage(events)
    occ = lane_occupancy(events)
    wave = level_timeline(events)
    offsets = [
        float(ex.get("clockOffset", 0.0) or 0.0) for ex in exports or []
    ]
    tts = cp["wall_ms"] / 1e3 if cp else 0.0
    report = {
        "metric": "trace_time_to_threshold_s",
        "value": tts,
        "backend": "trace",
        "time_to_threshold_s": tts,
        "critical_path_coverage": cp["coverage"] if cp else 0.0,
        "flow_linkage": linkage,
        "flow_linked": linked,
        "flow_total": total,
        "lane_occupancy": occ["mean"],
        "lanes": occ["lanes"],
        "critical_path": cp,
        "levels_s": {
            str(lvl): {"first": f, "median": m, "last": l}
            for lvl, (f, m, l) in wave.items()
        },
        "clock_offsets_s": offsets,
        "events": len(events),
    }
    return report


def print_critical_path(cp: dict | None) -> None:
    if cp is None:
        print("\ncritical path: no threshold_reached instant in trace")
        return
    print(
        f"\ncritical path to threshold: {cp['wall_ms']:.2f} ms over "
        f"{cp['hops']} hop(s), {cp['coverage']:.1%} span-attributed"
    )
    print("  stage breakdown: " + "  ".join(
        f"{k}={v:.2f}ms" for k, v in cp["stages_ms"].items()
    ))
    if cp.get("region_hops"):
        print("  region hops: " + "  ".join(cp["region_hops"]))
    for e in cp["chain"]:
        where = f"pid {e['pid']} tid {e['tid']}"
        tag = (
            f"origin={e['origin']} level={e['level']}"
            if e["origin"] is not None
            else f"level={e['level']}" if e["level"] is not None else ""
        )
        print(
            f"  +{e['t_ms']:9.3f} ms {e['name']:>12} {e['dur_ms']:9.3f} ms"
            f"  [{where}] {tag}"
        )


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m handel_tpu_torch.sim trace",
        description="analyze a traced run's flight-recorder dumps",
    )
    ap.add_argument("paths", nargs="+", help="trace dir(s) or trace_*.json files")
    ap.add_argument("--merged", default="", help="write combined Chrome trace JSON")
    ap.add_argument("--plot", default="", help="write the aggregation-wave PNG")
    ap.add_argument(
        "--top", "--top-k", dest="top", type=int, default=10,
        help="rows kept/shown per table (bounds per-chain output too)",
    )
    ap.add_argument(
        "--critical-path", action="store_true",
        help="walk + print the causal chain to threshold",
    )
    ap.add_argument(
        "--report", default="",
        help="write the machine-readable trace_report.json here",
    )
    args = ap.parse_args(argv)

    # one file resident at a time: a 65k-node swarm's dumps stream through
    report = stream_report(args.paths, top_k=args.top)
    print(
        f"{report['events']} events streamed from {report['files']} file(s)"
    )

    wave = report["levels_s"]
    if wave:
        print("\naggregation wave (level completion, s since first event):")
        print(f"{'level':>6} {'first':>9} {'median':>9} {'last':>9} ")
        for lvl, w in wave.items():
            print(
                f"{int(lvl):>6} {w['first']:>9.4f} {w['median']:>9.4f} "
                f"{w['last']:>9.4f}"
            )

    rows = report["span_table"]
    if rows:
        print("\nslowest-span attribution:")
        print(f"{'span':>14} {'count':>8} {'total ms':>11} {'mean ms':>9} {'max ms':>9}")
        for r in rows[: args.top]:
            print(
                f"{r['name']:>14} {r['count']:>8} {r['total_ms']:>11.2f} "
                f"{r['mean_ms']:>9.3f} {r['max_ms']:>9.3f}"
            )

    ch = report["chains"]
    if ch["count"]:
        print(
            f"\n{ch['count']} contribution chains; span coverage "
            f"min={ch['coverage_min']:.1%} mean={ch['coverage_mean']:.1%}"
        )
        print("slowest contributions (recv -> merge):")
        for c in ch["slowest"]:
            stages = " ".join(
                f"{n}={ms:.2f}ms" for n, ms in c["stages"].items()
            )
            print(
                f"  node {c['tid']} origin={c['origin']} level={c['level']}: "
                f"{c['wall_ms']:.2f} ms ({c['coverage']:.0%} attributed) {stages}"
            )

    if args.critical_path:
        print_critical_path(report["critical_path"])
        print(
            f"\nflow linkage: {report['flow_linked']}/{report['flow_total']} "
            f"recvs resolved to their sender's span "
            f"({report['flow_linkage']:.1%})"
        )
        if report["lanes"]:
            print(
                "lane occupancy: "
                + "  ".join(
                    f"{k}={v:.1%}" for k, v in report["lanes"].items()
                )
                + f"  (mean {report['lane_occupancy']:.1%})"
            )

    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
        print(f"\ntrace report -> {args.report}")

    if args.merged:
        # the one path that genuinely needs every event resident
        events = merge_traces(load_exports(args.paths))["traceEvents"]
        with open(args.merged, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        print(f"\nmerged trace -> {args.merged}")
    if args.plot:
        from handel_tpu_torch.sim.plots import plot_trace_timeline

        plot_trace_timeline(
            {
                int(k): (w["first"], w["median"], w["last"])
                for k, w in wave.items()
            },
            args.plot,
        )
        print(f"wave plot -> {args.plot}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
