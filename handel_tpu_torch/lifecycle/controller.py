"""The periodic control loop over the lifecycle plane — a copy of
handel_tpu/lifecycle/controller.py.

`LifecycleController` runs the autoscaler tick and the autotuner
observation every `interval_s` on the service's event loop. Epoch
rotations stay caller-driven (they are triggered by consensus events,
not a timer) — the controller only surfaces the `EpochManager`'s
telemetry alongside its own.

The `report_source` callable decouples the autotuner from where stage
attribution comes from: in the sim it's the in-memory analyzer over the
live recorder; in production it could read the last trace_report.json a
cron-ed `python -m handel_tpu_torch.sim trace` left behind. It may return None
(no report yet) — the autotuner treats that as a no-op.
"""

from __future__ import annotations

import asyncio
from typing import Callable

from handel_tpu_torch.core.logging import DEFAULT_LOGGER, Logger


class LifecycleController:
    """Ties autoscaler + autotuner (+ epoch telemetry) into one loop."""

    def __init__(
        self,
        service,
        autoscaler=None,
        autotuner=None,
        epoch_manager=None,
        alert_plane=None,
        host_rollup=None,
        report_source: Callable[[], dict | None] | None = None,
        interval_s: float = 0.25,
        logger: Logger = DEFAULT_LOGGER,
    ):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.service = service
        self.autoscaler = autoscaler
        self.autotuner = autotuner
        self.epoch_manager = epoch_manager
        # detection-and-incident plane (obs/plane.py AlertPlane): ticked
        # on the same cadence as the actuators it feeds, so an incident's
        # autoscaler nudge lands at most one interval after detection
        self.alert_plane = alert_plane
        # hierarchical roll-up (obs/rollup.py HostRollup): its local
        # detectors advance on the control cadence so the digest's top-K
        # carries live z-scores when the emit interval comes around
        self.host_rollup = host_rollup
        self.report_source = report_source
        self.interval_s = interval_s
        self.log = logger
        self._task: asyncio.Task | None = None
        self._lock = asyncio.Lock()  # background loop vs direct tick() calls
        self.ticks = 0

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            await self.tick()

    async def tick(self) -> dict:
        """One control interval, also callable directly from tests/sims
        that want deterministic pacing instead of the background loop (the
        lock serializes direct calls against it)."""
        async with self._lock:
            self.ticks += 1
            out: dict = {}
            if self.alert_plane is not None:
                # evaluate BEFORE the autoscaler: a breaker-storm incident
                # opened this tick nudges the autoscaler pass below
                try:
                    out["alerts"] = self.alert_plane.tick()
                except Exception as exc:
                    self.log.warn(
                        "lifecycle", f"alert plane tick failed: {exc!r}"
                    )
            if self.host_rollup is not None:
                try:
                    self.host_rollup.tick()
                except Exception as exc:
                    self.log.warn(
                        "lifecycle", f"host rollup tick failed: {exc!r}"
                    )
            if self.autoscaler is not None:
                out["autoscaler"] = await self.autoscaler.tick()
            if self.autotuner is not None and self.report_source is not None:
                try:
                    report = self.report_source()
                except Exception as exc:  # a broken report must not kill the loop
                    self.log.warn("lifecycle", f"report_source failed: {exc!r}")
                    report = None
                out["autotune"] = self.autotuner.observe(report)
            return out

    def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("lifecycle controller already started")
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is None:
            return
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
        self._task = None

    def values(self) -> dict[str, float]:
        out = {"lifecycleTicks": float(self.ticks)}
        if self.autoscaler is not None:
            out.update(self.autoscaler.values())
        if self.autotuner is not None:
            out.update(self.autotuner.values())
        if self.epoch_manager is not None:
            out.update(self.epoch_manager.values())
        if self.alert_plane is not None:
            out.update(self.alert_plane.values())
        if self.host_rollup is not None:
            out.update(self.host_rollup.values())
        return out

    def gauge_keys(self) -> set[str]:
        keys: set[str] = set()
        for part in (self.autoscaler, self.autotuner, self.epoch_manager,
                     self.alert_plane, self.host_rollup):
            if part is not None:
                keys |= part.gauge_keys()
        return keys
