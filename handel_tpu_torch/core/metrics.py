"""Pull-based metrics plane: registry, Prometheus exposition, HTTP endpoints
— a copy of handel_tpu/core/metrics.py.

The monitor plane (sim/monitor.py) is push-based and post-hoc: nodes fire
UDP measures at the master which aggregates ONE CSV row after the run. This
module is the live half — a process-local `MetricsRegistry` that wraps the
existing reporter surfaces (`values()` maps, core/report.py; `histograms()`
maps, core/trace.py) behind one scrapeable object, and a stdlib-only
`MetricsServer` (`http.server`, no dependency) exposing

    GET  /metrics            Prometheus text exposition format 0.0.4
    GET  /healthz            liveness (200 while the process serves)
    GET  /readyz             readiness (200 only when every probe passes)
    GET  /alerts             alert/incident JSON snapshot (501 unless a
                             source is wired)
    GET  /fleet              fleet roll-up JSON snapshot (likewise)
    POST /debug/profile?seconds=N   on-demand profiler capture hook

Metric naming convention: `handel_<plane>_<snake_case_key>` — e.g.
`Handel.values()["msgSentCt"]` under plane "sigs" becomes
`handel_sigs_msg_sent_ct`. Planes mirror the monitor measure names:
sigs (protocol), net (transport), penalty (peer scoring), device_verifier
(shared batch service), device (card telemetry, parallel/telemetry.py).
The exposition text is the JAX package's for the same values.

Counter/gauge classification reuses the reporter contract: a reporter may
declare its point-in-time keys explicitly via `gauge_keys()`; the name
suffix heuristic (`Rate`/`Occupancy`/`Size`/`State`, sim/monitor.py
CounterIO) stays as a fallback only.

Thread model: the HTTP server scrapes from its own daemon thread(s) while
the asyncio loop mutates the counters. Reads of int/float attributes are
atomic under the GIL; a dict mutated mid-iteration can raise, so each
collector is sampled under a retry-once guard and failures surface as the
registry's own `handel_metrics_scrape_errors` counter instead of a 500.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable, Mapping
from urllib.parse import parse_qs, urlsplit

from handel_tpu_torch.core.trace import LogHistogram

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: point-in-time key suffixes (the sim/monitor.py CounterIO heuristic —
#: kept ONLY as a fallback behind explicit `gauge_keys()` declarations)
GAUGE_SUFFIXES = ("Rate", "Occupancy", "Size", "State")


def is_gauge_key(key: str, declared: Iterable[str] | None = None) -> bool:
    """Explicit declaration first, name-suffix heuristic as fallback."""
    if declared is not None and key in declared:
        return True
    return key.endswith(GAUGE_SUFFIXES)


def snake(key: str) -> str:
    """camelCase reporter key -> snake_case metric suffix
    (`msgSentCt` -> `msg_sent_ct`, `levelCompleteS` -> `level_complete_s`)."""
    out = []
    for i, ch in enumerate(key):
        if ch.isupper():
            if i and (not key[i - 1].isupper() or
                      (i + 1 < len(key) and key[i + 1].islower())):
                out.append("_")
            out.append(ch.lower())
        elif ch.isalnum():
            out.append(ch)
        else:
            out.append("_")
    return "".join(out)


def metric_name(plane: str, key: str) -> str:
    return f"handel_{snake(plane)}_{snake(key)}"


def _fmt_labels(labels: Mapping[str, str] | None) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


class Sample:
    """One exposition line: (labels, value) under a family name."""

    __slots__ = ("labels", "value")

    def __init__(self, labels: Mapping[str, str] | None, value: float):
        self.labels = dict(labels or {})
        self.value = float(value)


class Family:
    """A named metric family (one `# TYPE` header, many labeled samples)."""

    __slots__ = ("name", "mtype", "help", "samples")

    def __init__(self, name: str, mtype: str, help: str = ""):
        self.name = name
        self.mtype = mtype
        self.help = help
        self.samples: list[Sample] = []


class Counter:
    """Directly-incremented counter instrument."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, by: float = 1.0) -> None:
        self.value += by

    def collect(self) -> Iterable[Family]:
        fam = Family(self.name, "counter", self.help)
        fam.samples.append(Sample(None, self.value))
        yield fam


class Gauge:
    """Directly-set gauge instrument; `fn` makes it callback-backed."""

    def __init__(self, name: str, help: str = "",
                 fn: Callable[[], float] | None = None):
        self.name = name
        self.help = help
        self.fn = fn
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def collect(self) -> Iterable[Family]:
        fam = Family(self.name, "gauge", self.help)
        fam.samples.append(Sample(None, self.fn() if self.fn else self.value))
        yield fam


class HistogramMetric:
    """LogHistogram-backed histogram instrument (fixed log buckets)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.hist = LogHistogram()

    def observe(self, v: float) -> None:
        self.hist.add(v)

    def collect(self) -> Iterable[Family]:
        yield _hist_family(self.name, self.help, [(None, self.hist)])


def _hist_family(name, help_, labeled_hists) -> Family:
    fam = Family(name, "histogram", help_)
    for labels, h in labeled_hists:
        labels = dict(labels or {})
        acc = 0
        for i, c in enumerate(h.counts):
            if not c:
                continue  # only emit buckets where the cumulative count moves
            acc += c
            _, hi = h.bucket_bounds(i)
            fam.samples.append(
                Sample({**labels, "le": _fmt_value(hi)}, acc)
            )
        # the mandatory +Inf bucket, _sum and _count
        fam.samples.append(Sample({**labels, "le": "+Inf"}, h.count))
        fam.samples.append(Sample({**labels, "__kind": "sum"}, h.sum))
        fam.samples.append(Sample({**labels, "__kind": "count"}, h.count))
        if h.count:
            # observed extrema: quantile() clamps to [lo, hi], so a scrape
            # that only carries bucket edges reconstructs edge quantiles
            # biased to the geometric midpoint. Carrying min/max makes the
            # exposition round trip exact (merged_histogram reads them back).
            fam.samples.append(Sample({**labels, "__kind": "min"}, h.lo))
            fam.samples.append(Sample({**labels, "__kind": "max"}, h.hi))
    return fam


class _ReporterCollector:
    """Bridges a `values()` reporter into labeled counter/gauge families."""

    def __init__(self, plane, reporter, labels, gauges):
        self.plane = plane
        self.reporter = reporter
        self.labels = dict(labels or {})
        self._explicit = set(gauges) if gauges is not None else None

    def _gauge_set(self):
        if self._explicit is not None:
            return self._explicit
        gk = getattr(self.reporter, "gauge_keys", None)
        return set(gk()) if callable(gk) else set()

    def collect(self) -> Iterable[Family]:
        vals = dict(self.reporter.values())
        declared = self._gauge_set()
        for k, v in vals.items():
            mtype = "gauge" if is_gauge_key(k, declared) else "counter"
            fam = Family(metric_name(self.plane, k), mtype)
            fam.samples.append(Sample(self.labels, v))
            yield fam


class _LabeledReporterCollector:
    """Bridges a `labeled_values()` reporter — {label value: {key: val}} —
    into families carrying a label DIMENSION (one family per key, one
    sample per label value). The multi-tenant service plane uses it with
    label="session" (`handel_service_pending{session="s3"} 17`), the
    device plane with label="device"
    (`handel_device_verifier_launches{device="3"} 12`)."""

    def __init__(self, plane, reporter, label, labels, gauges,
                 cap=0, on_drop=None):
        self.plane = plane
        self.reporter = reporter
        self.label = label
        self.labels = dict(labels or {})
        self._explicit = set(gauges) if gauges is not None else None
        #: cardinality governance: >0 keeps the top-`cap` label values by
        #: activity, folds the rest into one explicit `_overflow` row and
        #: reports them via `on_drop` — truncation is never silent
        self.cap = int(cap or 0)
        self._on_drop = on_drop
        self._dropped_logged: frozenset = frozenset()

    def _gauge_set(self):
        if self._explicit is not None:
            return self._explicit
        # a reporter may expose different gauge sets for its aggregate
        # values() and its per-label rows (parallel/plane.py DevicePlane
        # does): the labeled declaration wins here when present
        gk = getattr(self.reporter, "labeled_gauge_keys", None)
        if not callable(gk):
            gk = getattr(self.reporter, "gauge_keys", None)
        return set(gk()) if callable(gk) else set()

    def _apply_cap(self, rows: dict, declared) -> tuple[dict, list]:
        """Top-`cap`-by-activity selection. Activity is the summed counter
        mass of a row (gauges ignored so a hot session outranks a deep
        queue); ties and all-gauge reporters fall back to total mass,
        then label order for determinism. Dropped rows are summed into an
        explicit `_overflow` row — the scrape still conserves counter
        totals."""
        def activity(vals) -> tuple:
            counter_mass = sum(
                float(v) for k, v in vals.items()
                if not is_gauge_key(k, declared)
            )
            total = sum(float(v) for v in vals.values())
            return (counter_mass, total)

        ranked = sorted(rows, key=lambda lv: (activity(rows[lv]),
                                              str(lv)), reverse=True)
        keep = set(ranked[:self.cap])
        dropped = [lv for lv in ranked[self.cap:]]
        overflow: dict[str, float] = {}
        for lv in dropped:
            for k, v in rows[lv].items():
                overflow[k] = overflow.get(k, 0.0) + float(v)
        kept = {lv: rows[lv] for lv in rows if lv in keep}
        kept["_overflow"] = overflow
        return kept, dropped

    def collect(self) -> Iterable[Family]:
        declared = self._gauge_set()
        rows = {lv: dict(vals)
                for lv, vals in dict(self.reporter.labeled_values()).items()}
        if self.cap > 0 and len(rows) > self.cap:
            rows, dropped = self._apply_cap(rows, declared)
            key = frozenset(str(lv) for lv in dropped)
            if key != self._dropped_logged:
                self._dropped_logged = key
                logging.getLogger("handel_tpu_torch.metrics").warning(
                    "labeled family %s/%s over series cap %d: folded %d "
                    "rows into _overflow: %s", self.plane, self.label,
                    self.cap, len(dropped),
                    ", ".join(sorted(key)[:16]),
                )
            if self._on_drop is not None:
                self._on_drop(len(dropped))
        fams: dict[str, Family] = {}
        for lv, vals in rows.items():
            for k, v in vals.items():
                name = metric_name(self.plane, k)
                fam = fams.get(name)
                if fam is None:
                    mtype = (
                        "gauge" if is_gauge_key(k, declared) else "counter"
                    )
                    fam = fams[name] = Family(name, mtype)
                fam.samples.append(
                    Sample({**self.labels, self.label: str(lv)}, v)
                )
        yield from fams.values()


class _HistogramReporterCollector:
    """Bridges a `histograms()` reporter (key -> LogHistogram)."""

    def __init__(self, plane, reporter, labels):
        self.plane = plane
        self.reporter = reporter
        self.labels = dict(labels or {})

    def collect(self) -> Iterable[Family]:
        for k, h in dict(self.reporter.histograms()).items():
            yield _hist_family(metric_name(self.plane, k), "",
                               [(self.labels, h)])


class MetricsRegistry:
    """Process-local pull registry over the existing reporter surfaces.

    Collection happens at scrape time: nothing is sampled or copied until
    `/metrics` is hit, so an idle registry costs nothing on the hot path.
    """

    def __init__(self, series_cap: int = 0):
        self._collectors: list = []
        self._readiness: dict[str, Callable[[], bool]] = {}
        self._lock = threading.Lock()
        self.scrapes = 0
        self.scrape_errors = 0
        #: default per-family label-cardinality cap for labeled reporters
        #: (0 = uncapped); [alerts] series_cap in the TOML
        self.series_cap = int(series_cap or 0)
        #: rows folded into `_overflow` across all capped collectors,
        #: exported as handel_metrics_rollup_dropped_series_ct
        self.dropped_series = 0
        #: `GET /alerts` JSON payload source (obs/ alert plane); None ->
        #: the endpoint answers 501
        self.alerts_source: Callable[[], dict] | None = None
        #: `GET /fleet` JSON payload source (obs/ fleet roll-up); None ->
        #: the endpoint answers 501
        self.fleet_source: Callable[[], dict] | None = None

    def set_alerts_source(self, fn: Callable[[], dict] | None) -> None:
        """Wire the /alerts endpoint to a payload callable (the alert
        plane's rule/incident snapshot). Replaceable: last writer wins."""
        self.alerts_source = fn

    def set_fleet_source(self, fn: Callable[[], dict] | None) -> None:
        """Wire the /fleet endpoint to a payload callable (the fleet
        roll-up's host/merge snapshot). Replaceable: last writer wins."""
        self.fleet_source = fn

    def _note_dropped(self, n: int) -> None:
        with self._lock:
            self.dropped_series += int(n)

    # -- registration -------------------------------------------------------

    def register(self, collector) -> None:
        """Anything with `collect() -> Iterable[Family]`."""
        with self._lock:
            self._collectors.append(collector)

    def register_values(self, plane: str, reporter,
                        labels: Mapping[str, str] | None = None,
                        gauges: Iterable[str] | None = None) -> None:
        """Expose a `values()` reporter under `handel_<plane>_*`. Gauge keys
        come from `gauges`, else the reporter's own `gauge_keys()`, else the
        suffix fallback."""
        self.register(_ReporterCollector(plane, reporter, labels, gauges))

    def register_labeled_values(self, plane: str, reporter,
                                label: str = "session",
                                labels: Mapping[str, str] | None = None,
                                gauges: Iterable[str] | None = None,
                                cap: int | None = None) -> None:
        """Expose a `labeled_values()` reporter ({label value: {key: v}})
        under `handel_<plane>_*` with `label` as a label dimension — the
        session axis of the multi-tenant service. Gauge classification as
        in register_values. `cap` bounds label cardinality (top-K by
        activity + `_overflow`); None inherits the registry's series_cap,
        0 disables."""
        self.register(
            _LabeledReporterCollector(
                plane, reporter, label, labels, gauges,
                cap=self.series_cap if cap is None else cap,
                on_drop=self._note_dropped,
            )
        )

    def register_histograms(self, plane: str, reporter,
                            labels: Mapping[str, str] | None = None) -> None:
        """Expose a `histograms()` reporter (key -> LogHistogram)."""
        self.register(_HistogramReporterCollector(plane, reporter, labels))

    def counter(self, name: str, help: str = "") -> Counter:
        c = Counter(name, help)
        self.register(c)
        return c

    def gauge(self, name: str, help: str = "",
              fn: Callable[[], float] | None = None) -> Gauge:
        g = Gauge(name, help, fn=fn)
        self.register(g)
        return g

    def histogram(self, name: str, help: str = "") -> HistogramMetric:
        h = HistogramMetric(name, help)
        self.register(h)
        return h

    # -- readiness ----------------------------------------------------------

    def add_readiness(self, name: str, probe: Callable[[], bool]) -> None:
        with self._lock:
            self._readiness[name] = probe

    def ready(self) -> tuple[bool, dict[str, bool]]:
        """(all probes pass, per-probe status). A probe that raises counts
        as not-ready — a dying dependency must not read as healthy."""
        status: dict[str, bool] = {}
        with self._lock:
            probes = list(self._readiness.items())
        for name, probe in probes:
            try:
                status[name] = bool(probe())
            except Exception:
                status[name] = False
        return all(status.values()), status

    # -- collection / exposition --------------------------------------------

    def collect(self) -> dict[str, Family]:
        """Merged families by name (one `# TYPE` per name even when many
        nodes register the same plane under different labels)."""
        self.scrapes += 1
        merged: dict[str, Family] = {}
        with self._lock:
            collectors = list(self._collectors)
        for col in collectors:
            for attempt in (0, 1):
                try:
                    fams = list(col.collect())
                    break
                except RuntimeError:
                    # reporter dict resized mid-iteration: retry once
                    if attempt:
                        fams = []
                        self.scrape_errors += 1
                except Exception:
                    fams = []
                    self.scrape_errors += 1
                    break
            for fam in fams:
                dst = merged.get(fam.name)
                if dst is None:
                    merged[fam.name] = dst = Family(fam.name, fam.mtype,
                                                    fam.help)
                dst.samples.extend(fam.samples)
        self_fams = [
            ("handel_metrics_scrapes", "counter", float(self.scrapes)),
            ("handel_metrics_scrape_errors", "counter",
             float(self.scrape_errors)),
            ("handel_metrics_rollup_dropped_series_ct", "counter",
             float(self.dropped_series)),
            ("handel_metrics_families", "gauge", float(len(merged) + 4)),
        ]
        for name, mtype, v in self_fams:
            fam = Family(name, mtype)
            fam.samples.append(Sample(None, v))
            merged[name] = fam
        return merged

    def exposition(self) -> str:
        fams = self.collect()
        lines: list[str] = []
        for name in sorted(fams):
            fam = fams[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.mtype}")
            for s in fam.samples:
                kind = s.labels.pop("__kind", "")
                suffix = f"_{kind}" if kind else (
                    "_bucket" if fam.mtype == "histogram" else ""
                )
                lines.append(
                    f"{name}{suffix}{_fmt_labels(s.labels)} "
                    f"{_fmt_value(s.value)}"
                )
        return "\n".join(lines) + "\n"


def parse_exposition(text: str) -> dict[str, dict]:
    """Minimal exposition-format parser for the watch dashboard and tests:
    {family: {"type": t, "samples": [(labels dict, value)]}}. Bucket/sum/
    count lines of a histogram family land under the family name with their
    `_bucket`/`_sum`/`_count` suffix recorded in the labels as `__suffix`."""
    fams: dict[str, dict] = {}
    types: dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
                fams.setdefault(parts[2], {"type": parts[3], "samples": []})
            continue
        if "{" in line:
            mname, rest = line.split("{", 1)
            labelstr, _, valstr = rest.rpartition("}")
            labels = {}
            for item in labelstr.split(","):
                if not item:
                    continue
                k, _, v = item.partition("=")
                labels[k.strip()] = v.strip().strip('"')
            value = valstr.strip()
        else:
            mname, _, value = line.rpartition(" ")
            labels = {}
        mname = mname.strip()
        base, suffix = mname, ""
        for suf in ("_bucket", "_sum", "_count", "_min", "_max"):
            cand = mname[: -len(suf)]
            if mname.endswith(suf) and cand in types \
                    and types[cand] == "histogram":
                base, suffix = cand, suf
                break
        if suffix:
            labels["__suffix"] = suffix
        fam = fams.setdefault(base, {"type": types.get(base, "untyped"),
                                     "samples": []})
        try:
            fam["samples"].append((labels, float(value)))
        except ValueError:
            continue
    return fams


def merged_histogram(fams: dict, name: str) -> LogHistogram | None:
    """Rebuild one LogHistogram from parsed `_bucket` samples (summed across
    all label sets — i.e. across nodes). Quantiles are then exact to the
    shared fixed bucket grid, which is all the dashboard needs."""
    fam = fams.get(name)
    if fam is None or fam["type"] != "histogram":
        return None
    h = LogHistogram()
    per_labels: dict[tuple, list[tuple[float, float]]] = {}
    total_sum = 0.0
    obs_lo = obs_hi = None
    for labels, v in fam["samples"]:
        suffix = labels.get("__suffix", "")
        key = tuple(sorted(
            (k, lv) for k, lv in labels.items()
            if k not in ("le", "__suffix")
        ))
        if suffix == "_bucket" and labels.get("le") not in (None, "+Inf"):
            per_labels.setdefault(key, []).append((float(labels["le"]), v))
        elif suffix == "_sum":
            total_sum += v
        elif suffix == "_min":
            obs_lo = v if obs_lo is None else min(obs_lo, v)
        elif suffix == "_max":
            obs_hi = v if obs_hi is None else max(obs_hi, v)
    for buckets in per_labels.values():
        acc = 0.0
        for le, cum in sorted(buckets):
            c = int(cum - acc)
            acc = cum
            if c <= 0:
                continue
            # invert the bucket upper bound back to its index
            i = LogHistogram._index(le * 0.99)
            h.counts[i] += c
            h.count += c
            lo, _ = LogHistogram.bucket_bounds(i)
            h.lo = min(h.lo, lo)
            h.hi = max(h.hi, le)
    # observed extrema from the _min/_max samples override the bucket-edge
    # approximation: quantile() clamps to [lo, hi], so with these restored
    # the round trip through the exposition format is exact
    if obs_lo is not None:
        h.lo = obs_lo
    if obs_hi is not None:
        h.hi = obs_hi
    h.sum = total_sum
    return h if h.count else None


# -- the HTTP server ---------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    # the registry/server ride on the server object (set by MetricsServer)
    protocol_version = "HTTP/1.1"

    def _reply(self, code: int, body: bytes,
               ctype: str = "text/plain; charset=utf-8") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        path = urlsplit(self.path).path
        reg: MetricsRegistry = self.server.registry  # type: ignore[attr-defined]
        if path == "/metrics":
            self._reply(200, reg.exposition().encode(), CONTENT_TYPE)
        elif path == "/healthz":
            self._reply(200, b"ok\n")
        elif path == "/readyz":
            ok, status = reg.ready()
            body = json.dumps({"ready": ok, "checks": status}).encode() + b"\n"
            self._reply(200 if ok else 503, body, "application/json")
        elif path == "/alerts":
            src = reg.alerts_source
            if src is None:
                self._reply(501, b"no alert plane wired on this node\n")
                return
            try:
                payload = src()
            except Exception as e:  # a broken plane must not kill the server
                self._reply(500, f"alerts snapshot failed: {e}\n".encode())
                return
            body = json.dumps(payload).encode() + b"\n"
            self._reply(200, body, "application/json")
        elif path == "/fleet":
            src = reg.fleet_source
            if src is None:
                self._reply(501, b"no fleet rollup wired on this node\n")
                return
            try:
                payload = src()
            except Exception as e:  # a broken rollup must not kill the server
                self._reply(500, f"fleet snapshot failed: {e}\n".encode())
                return
            body = json.dumps(payload).encode() + b"\n"
            self._reply(200, body, "application/json")
        else:
            self._reply(404, b"not found\n")

    def do_POST(self) -> None:  # noqa: N802
        parts = urlsplit(self.path)
        if parts.path != "/debug/profile":
            self._reply(404, b"not found\n")
            return
        profiler = self.server.profiler  # type: ignore[attr-defined]
        if profiler is None:
            self._reply(501, b"no profiler wired on this node\n")
            return
        try:
            seconds = float(parse_qs(parts.query).get("seconds", ["1"])[0])
            seconds = min(max(seconds, 0.05), 120.0)
        except ValueError:
            self._reply(400, b"bad seconds value\n")
            return
        try:
            out = profiler(seconds)
        except Exception as e:  # capture failure must not kill the server
            self._reply(500, f"profile capture failed: {e}\n".encode())
            return
        body = json.dumps({"seconds": seconds, "trace": out}).encode() + b"\n"
        self._reply(200, body, "application/json")

    def log_message(self, fmt, *args) -> None:  # scrapes are not log events
        pass


class MetricsServer:
    """stdlib HTTP endpoint thread for one process's registry.

    port=0 binds an ephemeral port; the bound port is available as `.port`
    after start() (the sim platform writes it into the run dir so `sim
    watch` can find every node). Daemon threads: the server never blocks
    process exit, and stop() is idempotent.
    """

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1",
                 profiler: Callable[[float], str] | None = None):
        self.registry = registry
        self.host = host
        self.port = port
        self.profiler = profiler
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> "MetricsServer":
        httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        httpd.daemon_threads = True
        httpd.registry = self.registry  # type: ignore[attr-defined]
        httpd.profiler = self.profiler  # type: ignore[attr-defined]
        self.port = httpd.server_address[1]
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, name="metrics-server", daemon=True
        )
        self._thread.start()
        return self

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def set_profiler(self, profiler: Callable[[float], str] | None) -> None:
        """Wire (or replace) the /debug/profile handler after start —
        telemetry is typically built later than the server, which must be
        up before a slow scheme warmup begins."""
        self.profiler = profiler
        if self._httpd is not None:
            self._httpd.profiler = profiler  # type: ignore[attr-defined]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self._thread = None
