"""Incident lifecycle: firing rules open, escalate and close incidents — a
copy of handel_tpu/obs/incidents.py.

One `IncidentLog.observe(firings)` call per tick takes the currently
firing rules (burn rules from obs/slo.py, incident-opening detector
series from obs/detect.py) and drives the state machine:

- **open** — firings while nothing is open start an incident. At open
  time the log captures a causal-attribution snapshot via `snapshot_fn`
  (obs/plane.py: the slowest critical-path chain from the FlightRecorder
  through the `sim trace` walker, the top anomalous series, unhealthy
  regions, open breakers) — attribution reflects the moment the alert
  fired, not the later post-mortem.
- **correlate** — new rules firing while an incident is open attach to
  it as timeline entries instead of opening a second incident (one
  outage = one incident, even when a region kill also burns three tier
  budgets); severity escalates warn -> page at most once.
- **close** — an incident closes only after its rules have been
  continuously quiet for `min_hold_s` (min-hold half of flap
  suppression). A refire within `cooldown_s` of a close REOPENS the same
  incident and counts a flap instead of minting a new id (cooldown
  half).

Every transition emits a trace instant (`incident_open` /
`incident_escalate` / `incident_close`, cat="incident") so the incident
timeline lands in the same Perfetto export as the signals that caused
it, and `to_report()` serializes the full timeline as the
`incident_report.json` artifact.
"""

from __future__ import annotations

import time
from typing import Callable

#: trace tid for incident instants — the service-level control lane
#: (matches service/federation.py SERVICE_TID)
SERVICE_TID = -1

SEVERITY_CODE = {"warn": 1.0, "page": 2.0}
STATE_CODE = {"open": 1.0, "closed": 0.0}


class Incident:
    """One incident: id, severity, firing rules, attribution, timeline."""

    __slots__ = ("id", "kind", "severity", "state", "opened_at",
                 "escalated_at", "closed_at", "attribution", "rules",
                 "timeline", "flaps")

    def __init__(self, iid: int, kind: str, severity: str, opened_at: float,
                 attribution: dict):
        self.id = iid
        self.kind = kind  # the rule that opened it
        self.severity = severity
        self.state = "open"
        self.opened_at = opened_at
        self.escalated_at: float | None = None
        self.closed_at: float | None = None
        self.attribution = attribution
        self.rules: set[str] = {kind}
        self.timeline: list[dict] = []
        self.flaps = 0

    def event(self, at: float, what: str, **kw) -> None:
        self.timeline.append({"at": round(at, 4), "event": what, **kw})

    def age_s(self, now: float) -> float:
        return (self.closed_at or now) - self.opened_at

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "kind": self.kind,
            "severity": self.severity,
            "state": self.state,
            "opened_at": round(self.opened_at, 4),
            "escalated_at": (
                round(self.escalated_at, 4)
                if self.escalated_at is not None else None
            ),
            "closed_at": (
                round(self.closed_at, 4)
                if self.closed_at is not None else None
            ),
            "rules": sorted(self.rules),
            "flaps": self.flaps,
            "attribution": self.attribution,
            "timeline": self.timeline,
        }


class IncidentLog:
    """The incident state machine plus its reporter/report surfaces."""

    def __init__(self, snapshot_fn: Callable[[], dict] | None = None,
                 recorder=None, min_hold_s: float = 2.0,
                 cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.snapshot_fn = snapshot_fn
        self.recorder = recorder
        self.min_hold_s = min_hold_s
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.incidents: list[Incident] = []
        self.current: Incident | None = None
        self._clear_since: float | None = None
        self._next_id = 1
        self.opened = 0
        self.escalated = 0
        self.closed = 0
        self.flapped = 0
        #: open/escalate/close listeners: fn(event, incident) — the
        #: control wiring (autoscaler repair, front-door mark-down)
        self._listeners: list[Callable[[str, Incident], None]] = []

    def add_listener(self, fn: Callable[[str, Incident], None]) -> None:
        self._listeners.append(fn)

    def _notify(self, event: str, inc: Incident) -> None:
        for fn in self._listeners:
            try:
                fn(event, inc)
            except Exception:
                pass  # a broken consumer must not break the log

    def _instant(self, name: str, inc: Incident, now: float) -> None:
        if self.recorder is not None:
            self.recorder.instant(
                name, tid=SERVICE_TID, cat="incident",
                args={"incident": inc.id, "kind": inc.kind,
                      "severity": inc.severity},
            )

    def _snapshot(self) -> dict:
        if self.snapshot_fn is None:
            return {}
        try:
            return self.snapshot_fn()
        except Exception as e:
            return {"error": f"snapshot failed: {e}"}

    # -- the state machine --------------------------------------------------

    def observe(self, firings: list[tuple[str, str]],
                now: float | None = None) -> None:
        """One tick of [(rule name, severity)] currently firing."""
        now = self.clock() if now is None else now
        inc = self.current
        if firings:
            self._clear_since = None
            worst = ("page" if any(s == "page" for _, s in firings)
                     else "warn")
            if inc is None:
                last = self.incidents[-1] if self.incidents else None
                if (
                    last is not None
                    and last.closed_at is not None
                    and now - last.closed_at < self.cooldown_s
                ):
                    # flap: refire inside the cooldown reopens, no new id
                    inc = last
                    inc.state = "open"
                    inc.closed_at = None
                    inc.flaps += 1
                    self.flapped += 1
                    inc.event(now, "reopen", rules=[n for n, _ in firings])
                    self._instant("incident_reopen", inc, now)
                else:
                    inc = Incident(
                        self._next_id, firings[0][0], worst, now,
                        self._snapshot(),
                    )
                    self._next_id += 1
                    self.incidents.append(inc)
                    self.opened += 1
                    inc.event(now, "open", rules=[n for n, _ in firings])
                    self._instant("incident_open", inc, now)
                    self._notify("open", inc)
                self.current = inc
            for name, _sev in firings:
                if name not in inc.rules:
                    inc.rules.add(name)
                    inc.event(now, "correlate", rule=name)
            if worst == "page" and inc.severity != "page":
                inc.severity = "page"
                inc.escalated_at = now
                self.escalated += 1
                inc.event(now, "escalate")
                self._instant("incident_escalate", inc, now)
                self._notify("escalate", inc)
        elif inc is not None:
            if self._clear_since is None:
                self._clear_since = now
            if now - self._clear_since >= self.min_hold_s:
                inc.state = "closed"
                inc.closed_at = now
                self.closed += 1
                inc.event(now, "close")
                self._instant("incident_close", inc, now)
                self._notify("close", inc)
                self.current = None
                self._clear_since = None

    # -- reporter surface ---------------------------------------------------

    def values(self) -> dict[str, float]:
        return {
            "incidentsOpen": 1.0 if self.current is not None else 0.0,
            "openedCt": float(self.opened),
            "escalatedCt": float(self.escalated),
            "closedCt": float(self.closed),
            "flapCt": float(self.flapped),
        }

    def gauge_keys(self) -> set[str]:
        return {"incidentsOpen"}

    def labeled_values(self) -> dict[str, dict[str, float]]:
        now = self.clock()
        return {
            str(inc.id): {
                "severityCode": SEVERITY_CODE[inc.severity],
                "stateCode": STATE_CODE[inc.state],
                "ageS": inc.age_s(now),
                "ruleCt": float(len(inc.rules)),
                "flapsCt": float(inc.flaps),
            }
            for inc in self.incidents
        }

    def labeled_gauge_keys(self) -> set[str]:
        return {"severityCode", "stateCode", "ageS"}

    # -- the artifact -------------------------------------------------------

    def to_report(self, t0: float = 0.0) -> dict:
        """The incident_report.json timeline body. `t0` rebases the
        monotonic timestamps to run-relative seconds."""

        def rel(inc: dict) -> dict:
            out = dict(inc)
            for k in ("opened_at", "escalated_at", "closed_at"):
                if out.get(k) is not None:
                    out[k] = round(out[k] - t0, 4)
            out["timeline"] = [
                {**e, "at": round(e["at"] - t0, 4)} for e in inc["timeline"]
            ]
            return out

        return {
            "incidents": [rel(i.to_dict()) for i in self.incidents],
            "opened": self.opened,
            "escalated": self.escalated,
            "closed": self.closed,
            "flaps": self.flapped,
        }
