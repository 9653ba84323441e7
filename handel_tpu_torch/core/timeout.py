"""Level-start timeout strategies and the shared cooperative timer wheel — a
copy of handel_tpu/core/timeout.py.

Reference: timeout.go:11-88 — `TimeoutStrategy` (Start/Stop) and the linear
strategy that starts level i at time i*period (default 50 ms).

The swarm's addition: `LinearTimeout` plus the per-node periodic updater is
2+ asyncio tasks per Handel instance — 130k+ tasks for a 65,536
virtual-node committee, each with its own heap entry churn in the loop. The
`TimerWheel` replaces them with ONE task ticking a hashed wheel of
callbacks; every virtual node holds at most one outstanding one-shot handle
(its next level start) plus one periodic handle (its gossip round), so the
scheduler state is O(nodes), not O(tasks), and the loop stays responsive.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Sequence


class LinearTimeout:
    """Starts level i at time i*period (timeout.go:18-88), as an asyncio task."""

    def __init__(self, handel, levels: Sequence[int], period: float):
        self.handel = handel
        self.levels = list(levels)
        self.period = period
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        for lvl in self.levels:
            self.handel.start_level(lvl)
            await asyncio.sleep(self.period)


class InfiniteTimeout:
    """Never starts a level by timeout — only fast-path completion advances.

    Test strategy trick from the reference (handel_test.go:442-455): with no
    failing nodes, any stall becomes a real bug instead of being masked by
    timeouts.
    """

    def __init__(self, handel=None, levels: Sequence[int] = ()):
        pass

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


class WheelHandle:
    """One scheduled callback; `cancel()` is O(1) (the wheel skips it)."""

    __slots__ = ("cb", "period_ticks", "cancelled")

    def __init__(self, cb: Callable[[], None], period_ticks: int = 0):
        self.cb = cb
        self.period_ticks = period_ticks  # 0 = one-shot
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class TimerWheel:
    """One asyncio task driving many cooperative timers (module docstring).

    Resolution is `tick_s`; callbacks land on their due tick's bucket and
    run inline on the wheel task. Long buckets yield to the loop every
    `YIELD_EVERY` callbacks so a 65k-node periodic burst never starves
    packet delivery for a whole bucket. Callbacks must not raise — an
    exception is counted (`wheelCbErrors`) and swallowed so one broken
    vnode cannot stop the committee's clock.
    """

    YIELD_EVERY = 512

    def __init__(self, tick_s: float = 0.010):
        if tick_s <= 0:
            raise ValueError("tick_s must be > 0")
        self.tick_s = tick_s
        self._buckets: dict[int, list[WheelHandle]] = {}
        self._task: asyncio.Task | None = None
        self._tick = 0  # last processed tick
        # reporter counters
        self.scheduled_ct = 0
        self.fired_ct = 0
        self.cancelled_ct = 0
        self.cb_error_ct = 0

    # -- scheduling --------------------------------------------------------

    def _ticks(self, delay_s: float) -> int:
        return max(1, round(delay_s / self.tick_s))

    def schedule(self, delay_s: float, cb: Callable[[], None]) -> WheelHandle:
        """One-shot callback after ~delay_s (rounded to the tick)."""
        h = WheelHandle(cb)
        self._buckets.setdefault(self._tick + self._ticks(delay_s), []).append(h)
        self.scheduled_ct += 1
        return h

    def schedule_periodic(
        self, period_s: float, cb: Callable[[], None], phase_s: float = 0.0
    ) -> WheelHandle:
        """Recurring callback every ~period_s; `phase_s` staggers the first
        fire so thousands of same-period nodes don't land on one tick."""
        h = WheelHandle(cb, period_ticks=self._ticks(period_s))
        first = self._ticks(phase_s) if phase_s > 0 else h.period_ticks
        self._buckets.setdefault(self._tick + first, []).append(h)
        self.scheduled_ct += 1
        return h

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._tick = int(loop.time() / self.tick_s)
        self._task = loop.create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self._buckets.clear()

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            target = (self._tick + 1) * self.tick_s
            delay = target - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            # process every tick between the last one and now (a saturated
            # loop skips wall ticks; their buckets still run, in order)
            now_tick = max(self._tick + 1, int(loop.time() / self.tick_s))
            ran = 0
            for t in range(self._tick + 1, now_tick + 1):
                bucket = self._buckets.pop(t, None)
                if not bucket:
                    continue
                for h in bucket:
                    if h.cancelled:
                        self.cancelled_ct += 1
                        continue
                    try:
                        h.cb()
                    except Exception:
                        self.cb_error_ct += 1
                    self.fired_ct += 1
                    if h.period_ticks:
                        self._buckets.setdefault(
                            t + h.period_ticks, []
                        ).append(h)
                    ran += 1
                    if ran % self.YIELD_EVERY == 0:
                        await asyncio.sleep(0)
            self._tick = now_tick

    def values(self) -> dict[str, float]:
        return {
            "wheelScheduledCt": float(self.scheduled_ct),
            "wheelFiredCt": float(self.fired_ct),
            "wheelCancelledCt": float(self.cancelled_ct),
            "wheelCbErrors": float(self.cb_error_ct),
            "wheelPendingSize": float(
                sum(len(b) for b in self._buckets.values())
            ),
        }

    def gauge_keys(self) -> set[str]:
        return {"wheelPendingSize"}


class WheelTimeout:
    """LinearTimeout semantics on the shared wheel: level i starts at
    i*period, but with ONE outstanding handle per node at any time (each
    fire schedules the next) instead of a dedicated sleeper task."""

    def __init__(self, wheel: TimerWheel, handel, levels: Sequence[int],
                 period: float):
        self.wheel = wheel
        self.handel = handel
        self.levels = list(levels)
        self.period = period
        self._idx = 0
        self._handle: WheelHandle | None = None
        self._stopped = False

    @classmethod
    def factory(cls, wheel: TimerWheel, period: float):
        """Config.new_timeout-compatible closure."""
        return lambda handel, levels: cls(wheel, handel, levels, period)

    def start(self) -> None:
        self._fire()  # level[0] starts immediately, like LinearTimeout

    def stop(self) -> None:
        self._stopped = True
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None

    def _fire(self) -> None:
        if self._stopped or self._idx >= len(self.levels):
            self._handle = None
            return
        self.handel.start_level(self.levels[self._idx])
        self._idx += 1
        if self._idx < len(self.levels):
            self._handle = self.wheel.schedule(self.period, self._fire)
