"""Critical-path autotuning: the causal tracer's stage attribution drives
the collector's knobs — a copy of handel_tpu/lifecycle/autotune.py.

The end-to-end tracer (sim/trace_cli.py) already decomposes fleet time
into stages — `trace_report.json["stages_ms"]` with keys like `queue`,
`device`, `net`, `verify`, `merge`, `recv` — and its critical-path
analyzer names the dominant one. Until now a human read that report and
edited the config. `CriticalPathAutotuner` closes the loop:

- **queue-dominated** — candidates sit waiting for the collector window
  to close: shrink `max_delay` (smaller batches, sooner launches).
- **device-dominated** — the card is the wall: grow `max_delay` so each
  launch amortizes more candidates per pairing sweep.
- **net-dominated** — transport dominates compute: raise `max_inflight`
  so more launches overlap the wire (applies to lanes wired after the
  change, i.e. autoscaler-attached ones).

A stage only counts as dominant above `dominance` fraction of the summed
stage time, and only `patience` consecutive intervals of the same verdict
trigger a move — the hysteresis that keeps one noisy report from
thrashing the window. Moves are multiplicative (`step`) and clamped to
[`min_delay_s`, `max_delay_s`] / `max_inflight_cap`.
"""

from __future__ import annotations

from handel_tpu_torch.core.logging import DEFAULT_LOGGER, Logger

# stages the collector window can actually influence; recv/merge live in
# the aggregation tree, not the verify plane, and are left to the topology
ACTIONABLE = ("queue", "device", "net")


class CriticalPathAutotuner:
    """Feeds `stages_ms` attribution back into the verify service."""

    def __init__(
        self,
        service,
        dominance: float = 0.4,
        patience: int = 2,
        step: float = 1.25,
        min_delay_s: float = 0.0005,
        max_delay_s: float = 0.008,
        max_inflight_cap: int = 8,
        logger: Logger = DEFAULT_LOGGER,
    ):
        if not 0.0 < dominance <= 1.0:
            raise ValueError("dominance must be in (0, 1]")
        if step <= 1.0:
            raise ValueError("step must be > 1 (multiplicative)")
        self.service = service
        self.dominance = dominance
        self.patience = max(1, patience)
        self.step = step
        self.min_delay_s = min_delay_s
        self.max_delay_s = max_delay_s
        self.max_inflight_cap = max_inflight_cap
        self.log = logger
        self._streak_stage = ""
        self._streak = 0
        self.adjustments = 0
        self.last_dominant = ""

    def observe(self, report: dict | None) -> str:
        """Consume one stage-attribution report (`trace_report.json` shape
        or anything with a `stages_ms` mapping). Returns a description of
        the adjustment made, or '' if the verdict didn't clear the
        hysteresis. Safe to call with None / empty reports (no-op)."""
        stages = (report or {}).get("stages_ms") or {}
        total = sum(v for v in stages.values() if v > 0)
        if total <= 0:
            return ""
        stage, share = max(
            ((k, stages.get(k, 0.0) / total) for k in ACTIONABLE),
            key=lambda kv: kv[1],
        )
        if share < self.dominance:
            self._streak_stage, self._streak = "", 0
            self.last_dominant = ""
            return ""
        self.last_dominant = stage
        if stage == self._streak_stage:
            self._streak += 1
        else:
            self._streak_stage, self._streak = stage, 1
        if self._streak < self.patience:
            return ""
        self._streak = 0  # reset so the NEXT move needs fresh evidence
        return self._adjust(stage, share)

    def _adjust(self, stage: str, share: float) -> str:
        svc = self.service
        action = ""
        if stage == "queue":
            new = max(self.min_delay_s, svc.max_delay / self.step)
            if new != svc.max_delay:
                action = f"max_delay {svc.max_delay * 1e3:.2f} -> {new * 1e3:.2f} ms"
                svc.max_delay = new
        elif stage == "device":
            new = min(self.max_delay_s, svc.max_delay * self.step)
            if new != svc.max_delay:
                action = f"max_delay {svc.max_delay * 1e3:.2f} -> {new * 1e3:.2f} ms"
                svc.max_delay = new
        elif stage == "net":
            new = min(self.max_inflight_cap, svc.max_inflight + 1)
            if new != svc.max_inflight:
                action = f"max_inflight {svc.max_inflight} -> {new}"
                svc.max_inflight = new
        if action:
            self.adjustments += 1
            self.log.info(
                "autotune",
                f"{stage} dominates ({share:.0%} of stage time): {action}",
            )
        return action

    def values(self) -> dict[str, float]:
        return {
            "autotuneAdjustments": float(self.adjustments),
            "tunedMaxDelayMs": self.service.max_delay * 1e3,
            "tunedMaxInflight": float(self.service.max_inflight),
        }

    def gauge_keys(self) -> set[str]:
        return {"tunedMaxDelayMs", "tunedMaxInflight"}
