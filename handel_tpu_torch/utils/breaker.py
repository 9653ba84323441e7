"""Circuit breaker for accelerator-health gating — a copy of
handel_tpu/utils/breaker.py.

Lives in utils so the shared batch-verifier service
(parallel/batch_verifier.py) and its device plane (parallel/plane.py) share
it without a cycle.
"""

from __future__ import annotations

import time
from typing import Callable


class CircuitBreaker:
    """Device-health gate: closed → (N consecutive failures) → open →
    (cooldown elapses) → half-open probe → closed on success.

    A dead accelerator (device lost, CUDA runtime error) would
    otherwise fail EVERY batch after a full dispatch attempt; once the
    breaker opens, batches skip the device entirely and take the host
    fallback until one probe launch after the cooldown proves it back.

    State is derived lazily from `opened_at` + cooldown, so transitions
    become visible only when someone looks: every public entry point runs
    `_sync()`, which compares against the last observed state, bumps the
    monotonic `transitions` counter and fires `on_transition(prev, new)`
    — the observability hook (`breakerTransitionsCt` in the service's
    values()). The open→half-open edge therefore lands on the first `allow()`/`state`
    probe after the cooldown, which is exactly when it takes effect.
    """

    def __init__(
        self,
        threshold: int = 3,
        cooldown_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Callable[[str, str], None] | None = None,
    ):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.on_transition = on_transition
        self.failures = 0  # consecutive
        self.opened_at: float | None = None
        self.open_count = 0
        self.transitions = 0  # every observed state edge, monotonic
        self._last_state = "closed"

    def _raw_state(self) -> str:
        if self.opened_at is None:
            return "closed"
        if self.clock() - self.opened_at >= self.cooldown_s:
            return "half-open"
        return "open"

    def _sync(self) -> str:
        new = self._raw_state()
        prev = self._last_state
        if new != prev:
            self._last_state = new
            self.transitions += 1
            if self.on_transition is not None:
                self.on_transition(prev, new)
        return new

    def allow(self) -> bool:
        """May the next batch try the device? True while closed, and for
        the half-open probe once the cooldown has elapsed."""
        return self._sync() != "open"

    def record_success(self) -> None:
        self.failures = 0
        self.opened_at = None
        self._sync()

    def record_failure(self) -> None:
        self.failures += 1
        if self.failures >= self.threshold:
            if self.opened_at is None:
                self.open_count += 1  # closed -> open transition only
            self.opened_at = self.clock()  # (re)start the cooldown
        self._sync()

    @property
    def state(self) -> str:
        return self._sync()
