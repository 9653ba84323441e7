"""Verify-plane elasticity: lanes scale with load, broken lanes get
replaced instead of routed around — a copy of
handel_tpu/lifecycle/autoscaler.py.

The pre-lifecycle plane (parallel/plane.py) is a fixed K: a breaker-open
lane just stops receiving work, permanently degrading the fleet to K-1.
`LaneAutoscaler` closes that loop each control tick:

- **replace** — every lane whose breaker is open is swapped for a fresh
  engine from `engine_factory`: the replacement attaches FIRST (capacity
  never dips), then the broken lane drains out gracefully. No cooldown —
  a dead card is urgent.
- **grow** — queue depth at/above `scale_up_depth`, or the recent launch
  fill at/above `high_fill` (launches leaving no slack), adds a lane up
  to `max_lanes`.
- **shrink** — depth at/below `scale_down_depth` AND recent fill at/below
  `low_fill` (lanes mostly empty) drains the newest lane down to
  `min_lanes`.

"Recent fill" is the per-tick delta of the service's dispatch-side fill
accounting, not the lifetime mean — a plane that was busy an hour ago must
not look busy now. Grow/shrink honor `cooldown_s` so one burst cannot
flap the plane.
"""

from __future__ import annotations

import time
from typing import Callable

from handel_tpu_torch.core.logging import DEFAULT_LOGGER, Logger


class LaneAutoscaler:
    """Elastic lane management over one `BatchVerifierService`."""

    def __init__(
        self,
        service,
        engine_factory: Callable[[], object],
        min_lanes: int = 1,
        max_lanes: int = 8,
        scale_up_depth: int = 256,
        scale_down_depth: int = 8,
        high_fill: float = 0.9,
        low_fill: float = 0.25,
        cooldown_s: float = 2.0,
        drain_timeout_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        logger: Logger = DEFAULT_LOGGER,
    ):
        if min_lanes < 1:
            raise ValueError("min_lanes must be >= 1")
        if max_lanes < min_lanes:
            raise ValueError("max_lanes must be >= min_lanes")
        self.service = service
        self.engine_factory = engine_factory
        self.min_lanes = min_lanes
        self.max_lanes = max_lanes
        self.scale_up_depth = scale_up_depth
        self.scale_down_depth = scale_down_depth
        self.high_fill = high_fill
        self.low_fill = low_fill
        self.cooldown_s = cooldown_s
        self.drain_timeout_s = drain_timeout_s
        self.clock = clock
        self.log = logger
        self._last_change = -1e18
        self._fill_mark = (0.0, 0)  # (fill_sum, fill_launches) at last tick
        self.last_fill_signal = 0.0
        self.lanes_grown = 0
        self.lanes_shrunk = 0
        self.lanes_replaced = 0
        self.incident_nudges = 0
        self._repair_first = False

    def notify_incident(self, kind: str = "") -> None:
        """Incident-plane hook (obs/incidents.py listener): a breaker-storm
        incident makes the next tick repair-first — the grow/shrink
        cooldown is waived once so replacement capacity attaches on the
        very next control interval instead of waiting out a cooldown that
        was meant for ordinary load wiggle."""
        self.incident_nudges += 1
        self._repair_first = True

    def _recent_fill(self) -> float:
        """Mean launch fill since the previous tick (windowed, not
        lifetime); carries the last value through ticks with no launches
        so an idle instant doesn't read as an empty plane."""
        svc = self.service
        prev_sum, prev_n = self._fill_mark
        d_sum = svc.fill_sum - prev_sum
        d_n = svc.fill_launches - prev_n
        self._fill_mark = (svc.fill_sum, svc.fill_launches)
        if d_n > 0:
            self.last_fill_signal = d_sum / d_n
        return self.last_fill_signal

    async def tick(self) -> dict:
        """One control interval: replace broken lanes, then grow/shrink on
        the depth + fill signals. Returns what happened (for the
        controller's log/telemetry)."""
        svc = self.service
        actions: list[str] = []

        # 1. replacement — before any scaling math, so capacity decisions
        # see the post-repair plane. Attach first, drain second: the fleet
        # never dips below its pre-failure lane count mid-swap.
        for lane in [
            l for l in list(svc.plane.lanes)
            if l.breaker.state == "open" and not l.draining
        ]:
            replacement = svc.attach_lane(self.engine_factory())
            await svc.drain_lane(lane, timeout_s=self.drain_timeout_s)
            self.lanes_replaced += 1
            actions.append(f"replaced lane {lane.index} -> {replacement.index}")
            self.log.warn(
                "lane_replaced",
                f"breaker-open lane {lane.index} replaced by "
                f"{replacement.index}",
            )

        depth = svc.queue_depth()
        fill = self._recent_fill()
        active = [l for l in svc.plane.lanes if not l.draining]
        now = self.clock()
        if self._repair_first:
            # incident nudge consumed: repairs above already ran, and the
            # scaling pass below sees a waived cooldown this one tick
            self._repair_first = False
            self._last_change = -1e18
        if now - self._last_change >= self.cooldown_s:
            if (
                (depth >= self.scale_up_depth or fill >= self.high_fill)
                and len(active) < self.max_lanes
            ):
                lane = svc.attach_lane(self.engine_factory())
                self.lanes_grown += 1
                self._last_change = now
                actions.append(f"grew lane {lane.index}")
                self.log.info(
                    "lane_grown",
                    f"lane {lane.index} added (depth {depth}, "
                    f"fill {fill:.2f})",
                )
            elif (
                depth <= self.scale_down_depth
                and fill <= self.low_fill
                and len(active) > self.min_lanes
            ):
                lane = active[-1]  # newest first: keep the veterans' stats
                await svc.drain_lane(lane, timeout_s=self.drain_timeout_s)
                self.lanes_shrunk += 1
                self._last_change = now
                actions.append(f"drained lane {lane.index}")
                self.log.info(
                    "lane_drained",
                    f"lane {lane.index} drained (depth {depth}, "
                    f"fill {fill:.2f})",
                )
        return {
            "actions": actions,
            "depth": depth,
            "fill": fill,
            "lanes": len(svc.plane),
        }

    def values(self) -> dict[str, float]:
        return {
            "lanesGrown": float(self.lanes_grown),
            "lanesShrunk": float(self.lanes_shrunk),
            "lanesReplaced": float(self.lanes_replaced),
            "incidentNudgesCt": float(self.incident_nudges),
            "fillSignal": self.last_fill_signal,
        }

    def gauge_keys(self) -> set[str]:
        return {"fillSignal"}
