"""AlertPlane: one object composing evaluator + detectors + incidents — a
copy of handel_tpu/obs/plane.py.

The piece the control loop sees. `LifecycleController` (lifecycle/
controller.py) ticks it on its cadence; each tick snapshots every burn
rule, samples every detector series, and feeds the combined firing set
into the incident log. Harnesses (service/driver.py here; the
reference's load and soak harnesses too) build one from the `[alerts]`
TOML section (sim/config.py AlertParams), attach their rules/series, and
register the metrics surfaces:

    handel_alerts_*     evaluator + detector-bank planes, with per-rule
                        (`rule` label) and per-series (`series` label)
                        rows
    handel_incidents_*  incident log aggregates + per-incident rows
    GET /alerts         JSON snapshot (rules, series, incidents)

Attribution snapshots are assembled here: the slowest critical-path
chain from the FlightRecorder (via the `sim trace` walker), the top
anomalous detector series, plus any harness-registered context
providers (unhealthy regions, open breaker lanes).
"""

from __future__ import annotations

import time
from typing import Callable

from handel_tpu_torch.obs.detect import DetectorBank
from handel_tpu_torch.obs.incidents import IncidentLog
from handel_tpu_torch.obs.slo import BurnRateEvaluator


class AlertPlane:
    """Evaluator + detector bank + incident log behind one tick()."""

    def __init__(self, fast_window_s: float = 60.0,
                 slow_window_s: float = 900.0, window_scale: float = 1.0,
                 min_hold_s: float = 2.0, cooldown_s: float = 5.0,
                 recorder=None,
                 trace_source: Callable[[], list] | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.evaluator = BurnRateEvaluator(
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            window_scale=window_scale, clock=clock,
        )
        self.detectors = DetectorBank(clock=clock)
        self.incidents = IncidentLog(
            snapshot_fn=self.snapshot, recorder=recorder,
            min_hold_s=min_hold_s, cooldown_s=cooldown_s, clock=clock,
        )
        #: FlightRecorder events source for the critical-path half of the
        #: attribution snapshot (e.g. `lambda: rec.export()["traceEvents"]`)
        self.trace_source = trace_source
        self._context: dict[str, Callable[[], object]] = {}

    @classmethod
    def from_params(cls, p, recorder=None, trace_source=None,
                    clock: Callable[[], float] = time.monotonic
                    ) -> "AlertPlane":
        """Build from an `[alerts]` params object (sim/config.py
        AlertParams — duck-typed so obs/ never imports sim/)."""
        return cls(
            fast_window_s=p.fast_window_s, slow_window_s=p.slow_window_s,
            window_scale=p.window_scale, min_hold_s=p.min_hold_s,
            cooldown_s=p.cooldown_s, recorder=recorder,
            trace_source=trace_source, clock=clock,
        )

    # -- attribution --------------------------------------------------------

    def add_context(self, name: str, fn: Callable[[], object]) -> None:
        """Harness-specific attribution context sampled at incident-open
        time (e.g. "unhealthy_regions" -> list of region names)."""
        self._context[name] = fn

    def snapshot(self) -> dict:
        """The causal-attribution snapshot captured when an incident
        opens: critical path, top anomalous series, harness context."""
        out: dict = {"top_anomalous": self.detectors.top_anomalous(5)}
        if self.trace_source is not None:
            try:
                from handel_tpu_torch.sim.trace_cli import critical_path

                events = self.trace_source()
                cp = critical_path(events) if events else None
            except Exception:
                cp = None
            if cp:
                out["critical_path"] = {
                    "wall_ms": cp.get("wall_ms"),
                    "coverage": cp.get("coverage"),
                    "region_hops": cp.get("region_hops"),
                    "stages_ms": cp.get("stages_ms"),
                    # the slowest chain's tail is the causal headline;
                    # the full walk lives in the trace export itself
                    "chain_tail": (cp.get("chain") or [])[-8:],
                }
        for name, fn in self._context.items():
            try:
                out[name] = fn()
            except Exception as e:
                out[name] = f"context failed: {e}"
        return out

    # -- the control-loop tick ----------------------------------------------

    def tick(self, now: float | None = None) -> list[tuple[str, str]]:
        """One evaluation round; returns the firing set it observed."""
        now = self.clock() if now is None else now
        self.evaluator.tick(now)
        detections = self.detectors.tick(now)
        firings = self.evaluator.firing() + [
            (d.name, "page") for d in detections if d.opens_incident
        ]
        self.incidents.observe(firings, now)
        return firings

    # -- surfaces -----------------------------------------------------------

    def register_metrics(self, registry) -> None:
        """Wire the handel_alerts_* / handel_incidents_* families and the
        /alerts endpoint onto a MetricsRegistry."""
        registry.register_values("alerts", self.evaluator)
        registry.register_labeled_values(
            "alerts", self.evaluator, label="rule",
            gauges=self.evaluator.labeled_gauge_keys(),
        )
        registry.register_values("alerts", self.detectors)
        registry.register_labeled_values(
            "alerts", self.detectors, label="series",
            gauges=self.detectors.labeled_gauge_keys(),
        )
        registry.register_values("incidents", self.incidents)
        registry.register_labeled_values(
            "incidents", self.incidents, label="incident",
            gauges=self.incidents.labeled_gauge_keys(),
        )
        registry.set_alerts_source(self.alerts_payload)

    def alerts_payload(self) -> dict:
        """The GET /alerts JSON body."""
        rules = {}
        for name, row in self.evaluator.labeled_values().items():
            fast, slow = self.evaluator.burns(name)
            rules[name] = {
                "state": self.evaluator.states()[name],
                "burn_fast": round(fast, 3),
                "burn_slow": round(slow, 3),
                "budget": row["budget"],
            }
        return {
            "open": self.incidents.current is not None,
            "rules": rules,
            "series": self.detectors.labeled_values(),
            "incidents": [i.to_dict() for i in self.incidents.incidents],
        }

    def values(self) -> dict[str, float]:
        """Combined plane for the controller's reporter union."""
        out = dict(self.evaluator.values())
        out.update(self.detectors.values())
        out.update(self.incidents.values())
        return out

    def gauge_keys(self) -> set[str]:
        return (
            self.evaluator.gauge_keys()
            | self.detectors.gauge_keys()
            | self.incidents.gauge_keys()
        )
