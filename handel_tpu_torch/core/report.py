"""Reporter plane — the part of handel_tpu/core/report.py that the port
uses.

Reference: report.go:5-87 — the `Reporter` interface (`Values() map[string]
float64`) and the aggregating decorator. The components expose `values()`
themselves; `ReportAggregator` is the one object the monitor's `CounterIO`
snapshots for a process's device plane, `KernelTimer` the launch-time
counters on it, and `CurveCheckCounters` the host's G2 subgroup checks.
`WarnOnce` is the warn-once log gate Handel and the UDP transport report as
`logWarnCt`.
"""

from __future__ import annotations

import threading
import time
from typing import Mapping, Protocol


class Reporter(Protocol):
    """Anything exposing a flat float counter map (report.go:10-13)."""

    def values(self) -> dict[str, float]: ...


class ReportAggregator:
    """Namespaced union of many reporters, each under a prefix.

    >>> agg = ReportAggregator(verifier=svc, launch=timer)
    >>> agg.values()  # {"verifier_verifierLaunches": ..., "launch_launchCalls": ...}
    """

    def __init__(self, **reporters: Reporter):
        self._reporters = dict(reporters)

    def add(self, prefix: str, reporter: Reporter) -> None:
        self._reporters[prefix] = reporter

    def values(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for prefix, rep in self._reporters.items():
            for k, v in rep.values().items():
                out[f"{prefix}_{k}"] = float(v)
        return out

    def gauge_keys(self) -> set[str]:
        """Union of the children's gauge declarations, under their prefix."""
        out: set[str] = set()
        for prefix, rep in self._reporters.items():
            gk = getattr(rep, "gauge_keys", None)
            if callable(gk):
                out |= {f"{prefix}_{k}" for k in gk()}
        return out


class WarnOnce:
    """Warn-once log gate with a reporter-plane counter.

    A flooder spamming malformed packets must not turn per-packet logging
    into the attack, so repeat offenses per reason drop to debug; every
    occurrence (warned or suppressed) counts toward `logWarnCt`."""

    def __init__(self, logger):
        self.log = logger
        self.counts: dict[str, int] = {}

    def warn(self, key: str, detail) -> None:
        n = self.counts.get(key, 0) + 1
        self.counts[key] = n
        (self.log.warn if n == 1 else self.log.debug)(key, detail)

    def total(self) -> int:
        return sum(self.counts.values())

    def values(self) -> dict[str, float]:
        return {"logWarnCt": float(self.total())}


class KernelTimer:
    """Launch-time counters for the monitor plane.

    Wraps a callable (an engine's `dispatch` or `fetch`) and accumulates the
    wall time spent inside it, the call count and the longest call. A
    service's lane threads call the wrapped function concurrently, so the
    counters are updated under a lock."""

    def __init__(self, fn, name: str = "kernel"):
        self._fn = fn
        self.name = name
        self.calls = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self._fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.calls += 1
                self.total_s += dt
                self.max_s = max(self.max_s, dt)

    def values(self) -> dict[str, float]:
        with self._lock:
            return {
                f"{self.name}Calls": float(self.calls),
                f"{self.name}TimeMs": self.total_s * 1000.0,
                f"{self.name}MaxMs": self.max_s * 1000.0,
            }


class CurveCheckCounters:
    """Process-wide counters for host-side point-validation cost: the G2
    subgroup check (a scalar multiplication by r on every pubkey-bearing
    unmarshal, models/bn254.py) is the largest host item on the registry
    load path."""

    def __init__(self):
        self.g2_checks = 0
        self.g2_time_ms = 0.0

    def add_g2(self, dt_ms: float) -> None:
        self.g2_checks += 1
        self.g2_time_ms += dt_ms

    def values(self) -> dict[str, float]:
        return {
            "g2SubgroupChecks": float(self.g2_checks),
            "g2SubgroupCheckTimeMs": self.g2_time_ms,
        }


#: the per-process instance the host scheme feeds
SUBGROUP_CHECKS = CurveCheckCounters()


def diff_values(
    before: Mapping[str, float], after: Mapping[str, float]
) -> dict[str, float]:
    """Per-key delta of two counter snapshots (measure.go CounterMeasure)."""
    return {k: after[k] - before.get(k, 0.0) for k in after}
