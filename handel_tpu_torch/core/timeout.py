"""Level-start timeout strategies — the part of handel_tpu/core/timeout.py
that a node of the port runs.

Reference: timeout.go:11-88 — `TimeoutStrategy` (Start/Stop) and the linear
strategy that starts level i at time i*period (default 50 ms).
"""

from __future__ import annotations

import asyncio
from typing import Sequence


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
