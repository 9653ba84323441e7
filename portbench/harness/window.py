"""The measured window, made of whole launches.

A launch's verdict instant is the moment its fetch returned (all its
candidates' verdicts are on the host). The window opens at one launch's
verdict instant and closes at the last verdict instant within `seconds` of
the opening; the rate is the candidates of the launches whose verdicts came
after the opening, up to and including the close, over the time between the
two instants. Whole launches fall inside, so the rate does not step with
where the clock's edges fall, and a stall inside the window lowers it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class Launch:
    """One fetched launch: its verdict instant (s), its candidates, and the
    program's counters read at that instant."""

    t: float
    k: int
    counters: dict = field(default_factory=dict)


def close_index(launches: list, open_i: int, seconds: float) -> int | None:
    """The last launch whose verdict instant lies within `seconds` of
    launch `open_i`'s; the next one after the opening where none does (a
    window is never shorter than one launch); None when no launch followed
    the opening."""
    t_end = launches[open_i].t + seconds
    inside = [i for i in range(open_i + 1, len(launches)) if launches[i].t <= t_end]
    if inside:
        return inside[-1]
    return open_i + 1 if open_i + 1 < len(launches) else None


def rate(launches: list, open_i: int, close_i: int) -> float | None:
    """Candidates a second over the window (open_i, close_i]; None for a
    window that holds no launch."""
    if close_i <= open_i:
        return None
    k = sum(l.k for l in launches[open_i + 1 : close_i + 1])
    return k / (launches[close_i].t - launches[open_i].t)


def per_launch(launches: list, open_i: int, close_i: int, total: str, count: str):
    """Counter `total` per counter `count` over the window: the difference
    of each at its two edges. None where `count` did not move."""
    a, b = launches[open_i].counters, launches[close_i].counters
    if total not in a or count not in a:
        return None
    dn = b[count] - a[count]
    return (b[total] - a[total]) / dn if dn else None


def percentile(values, q: float):
    """Nearest-rank q-th percentile (0 < q <= 100); None when empty."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
