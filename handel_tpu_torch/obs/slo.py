"""Multi-window error-budget burn-rate SLO evaluation — a copy of
handel_tpu/obs/slo.py.

The math is the standard SRE formulation, kept closed-form so tests can
oracle it exactly. An SLO of `1 - budget` (e.g. 99% of gold sessions
inside their p99 target -> budget 0.01) burns at

    burn = windowed_error_rate / budget

so burn 1x consumes exactly the budget over the SLO period, and a
sustained 14.4x burn exhausts a 30-day budget in ~2 days — the classic
page threshold. Each rule is evaluated over TWO windows (fast ~1m /
slow ~15m, both scaled by `window_scale` so short drills exercise the
same math): the fast window makes detection quick, the slow window makes
the alert *stay* firing long enough to matter and suppresses blips.
A rule pages only when BOTH windows burn >= `page_x`, warns when both
burn >= `warn_x`.

Rules read cumulative (good, bad) event counts from a zero-argument
source callable; the evaluator snapshots them per tick into a bounded
deque (O(slow_window / tick) memory) and differences the window edges —
no per-event state, so a source can be as cheap as two counters.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

#: alert state codes for the metrics plane (gauge `alertState`)
STATE_CODE = {"ok": 0.0, "warn": 1.0, "page": 2.0}


@dataclass(frozen=True)
class BurnRule:
    """One SLO burn-rate rule: a named error budget with page/warn
    multipliers. `budget` is the allowed error fraction (1 - SLO target);
    the thresholds are burn multiples, not error rates."""

    name: str
    budget: float
    page_x: float = 14.4
    warn_x: float = 6.0
    description: str = ""

    def __post_init__(self):
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(
                f"rule {self.name!r}: budget must be in (0, 1], "
                f"got {self.budget}"
            )
        if self.warn_x >= self.page_x:
            raise ValueError(
                f"rule {self.name!r}: warn_x {self.warn_x} must be below "
                f"page_x {self.page_x}"
            )


class BurnRateEvaluator:
    """Ticks every rule's (good, bad) source and classifies ok/warn/page.

    Reporter surface (core/report.py contract): `values()` carries the
    aggregate plane, `labeled_values()` one row per rule under the `rule`
    label — both with explicit gauge declarations so the metrics plane
    never falls back to the suffix heuristic.
    """

    def __init__(self, fast_window_s: float = 60.0,
                 slow_window_s: float = 900.0,
                 window_scale: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if fast_window_s >= slow_window_s:
            raise ValueError(
                f"fast window {fast_window_s}s must be shorter than the "
                f"slow window {slow_window_s}s"
            )
        self.fast_window_s = fast_window_s * window_scale
        self.slow_window_s = slow_window_s * window_scale
        self.clock = clock
        self._rules: dict[str, BurnRule] = {}
        self._sources: dict[str, Callable[[], tuple[float, float]]] = {}
        #: per rule: deque of (t, good, bad) cumulative snapshots
        self._snaps: dict[str, deque] = {}
        self._state: dict[str, str] = {}
        self._burns: dict[str, tuple[float, float]] = {}
        self.ticks = 0
        self.page_transitions = 0
        self.warn_transitions = 0

    # -- registration -------------------------------------------------------

    def add_rule(self, rule: BurnRule,
                 source: Callable[[], tuple[float, float]]) -> None:
        """`source()` returns CUMULATIVE (good, bad) event counts."""
        if rule.name in self._rules:
            raise ValueError(f"duplicate burn rule {rule.name!r}")
        self._rules[rule.name] = rule
        self._sources[rule.name] = source
        self._snaps[rule.name] = deque()
        self._state[rule.name] = "ok"
        self._burns[rule.name] = (0.0, 0.0)

    @property
    def rules(self) -> dict[str, BurnRule]:
        return dict(self._rules)

    # -- the math -----------------------------------------------------------

    @staticmethod
    def _window_burn(snaps, now: float, window_s: float,
                     budget: float) -> float:
        """Burn multiple over [now - window_s, now] from the snapshot
        deque. The window edge is the newest snapshot at or before the
        edge time (falling back to the oldest — early in a run both
        windows see the whole history, which is the correct multiwindow
        degenerate case: with little history fast == slow)."""
        if len(snaps) < 2:
            return 0.0
        edge_t = now - window_s
        edge = snaps[0]
        for s in snaps:
            if s[0] <= edge_t:
                edge = s
            else:
                break
        head = snaps[-1]
        dgood = head[1] - edge[1]
        dbad = head[2] - edge[2]
        total = dgood + dbad
        if total <= 0:
            return 0.0
        return (dbad / total) / budget

    def tick(self, now: float | None = None) -> dict[str, str]:
        """Snapshot every source, recompute burns, return rule states."""
        now = self.clock() if now is None else now
        self.ticks += 1
        for name, rule in self._rules.items():
            try:
                good, bad = self._sources[name]()
            except Exception:
                continue  # a dying source must not kill the evaluator
            snaps = self._snaps[name]
            snaps.append((now, float(good), float(bad)))
            # prune past the slow window (keep one snapshot beyond the
            # edge so the window difference stays full-width)
            while len(snaps) > 2 and snaps[1][0] <= now - self.slow_window_s:
                snaps.popleft()
            fast = self._window_burn(snaps, now, self.fast_window_s,
                                     rule.budget)
            slow = self._window_burn(snaps, now, self.slow_window_s,
                                     rule.budget)
            self._burns[name] = (fast, slow)
            # absorb float rounding so an exactly-threshold stream (the
            # closed-form 6x / 14.4x oracles) classifies at the threshold
            eps = 1e-9
            if fast >= rule.page_x - eps and slow >= rule.page_x - eps:
                state = "page"
            elif fast >= rule.warn_x - eps and slow >= rule.warn_x - eps:
                state = "warn"
            else:
                state = "ok"
            prev = self._state[name]
            if state == "page" and prev != "page":
                self.page_transitions += 1
            if state == "warn" and prev == "ok":
                self.warn_transitions += 1
            self._state[name] = state
        return dict(self._state)

    def states(self) -> dict[str, str]:
        return dict(self._state)

    def burns(self, name: str) -> tuple[float, float]:
        """(fast, slow) burn multiples of one rule as of the last tick."""
        return self._burns[name]

    def firing(self) -> list[tuple[str, str]]:
        """[(rule name, severity)] for every rule not currently ok."""
        return [(n, s) for n, s in self._state.items() if s != "ok"]

    # -- reporter surface ---------------------------------------------------

    def values(self) -> dict[str, float]:
        states = self._state.values()
        return {
            "rulesTotal": float(len(self._rules)),
            "rulesWarn": float(sum(1 for s in states if s == "warn")),
            "rulesPage": float(sum(1 for s in states if s == "page")),
            "evalTicksCt": float(self.ticks),
            "pageTransitionsCt": float(self.page_transitions),
            "warnTransitionsCt": float(self.warn_transitions),
        }

    def gauge_keys(self) -> set[str]:
        return {"rulesTotal", "rulesWarn", "rulesPage"}

    def labeled_values(self) -> dict[str, dict[str, float]]:
        out: dict[str, dict[str, float]] = {}
        for name, rule in self._rules.items():
            fast, slow = self._burns[name]
            out[name] = {
                "burnFast": fast,
                "burnSlow": slow,
                "budget": rule.budget,
                "alertState": STATE_CODE[self._state[name]],
            }
        return out

    def labeled_gauge_keys(self) -> set[str]:
        return {"burnFast", "burnSlow", "budget", "alertState"}
