"""Streaming anomaly detection over reporter keys and histogram quantiles —
a copy of handel_tpu/obs/detect.py.

Two detector families, both O(1) memory per series and deterministic
under a fixed seed (the determinism test replays a stream and asserts
bit-identical z traces):

- `EwmaDetector` — exponentially weighted mean/variance; z-score of each
  new sample against the pre-update estimates. Cheap, fast to adapt,
  right for smooth gauges (fill ratio, dedup rate, goodput).
- `MadDetector` — frugal streaming median + MAD sketches (one estimate
  and one adaptive step each, rng only for the coin flips the frugal
  update needs — hence the seed). Robust to heavy tails and spikes,
  right for latency quantiles and queue depths.

A `DetectorBank` owns named series: each binds a zero-argument source
callable to a detector with a firing policy (direction, consecutive
count, whether a firing may open an incident). Sources are sampled at
tick time only — an idle bank costs nothing. Helper factories wrap the
three source shapes the package has: a reporter `values()` key, a
LogHistogram quantile, and a counter differenced into a rate.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass
from typing import Callable


class EwmaDetector:
    """EWMA mean/variance z-score. `update(x)` returns the SIGNED z of x
    against the estimates from before x was absorbed; during the first
    `warmup` samples it returns 0.0 (estimates are still forming)."""

    def __init__(self, alpha: float = 0.3, z_threshold: float = 6.0,
                 warmup: int = 5, eps: float = 1e-9):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.z_threshold = z_threshold
        self.warmup = warmup
        self.eps = eps
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, x: float) -> float:
        x = float(x)
        if self.n == 0:
            self.mean = x
            self.n = 1
            return 0.0
        z = (x - self.mean) / math.sqrt(self.var + self.eps)
        d = x - self.mean
        self.mean += self.alpha * d
        # EWMA variance of the residual (West 1979 incremental form)
        self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1
        return 0.0 if self.n <= self.warmup else z


class MadDetector:
    """Frugal streaming median + MAD with a robust z-score.

    Two frugal-quantile sketches: `med` tracks the median of x, `mad`
    the median of |x - med|. Each keeps one float estimate and one
    adaptive step (doubles while moving the same way, halves on
    direction change — frugal-2U). The frugal update flips a seeded
    coin per sample, which is the ONLY nondeterminism: a fixed seed
    replays exactly. z = 0.6745 * (x - med) / mad (the normal-consistent
    MAD scaling)."""

    def __init__(self, z_threshold: float = 6.0, warmup: int = 8,
                 seed: int = 0, eps: float = 1e-9):
        self.z_threshold = z_threshold
        self.warmup = warmup
        self.eps = eps
        self.rng = random.Random(seed * 1_000_003 + 101)
        self.med = 0.0
        self.mad = 0.0
        self._med_step = 1e-6
        self._mad_step = 1e-6
        self._med_dir = 0
        self._mad_dir = 0
        self.n = 0

    def _frugal(self, est: float, step: float, last_dir: int,
                x: float) -> tuple[float, float, int]:
        if x == est or self.rng.random() >= 0.5:
            return est, step, last_dir
        d = 1 if x > est else -1
        step = min(step * 2.0, abs(x - est)) if d == last_dir \
            else max(step * 0.5, self.eps)
        est += d * step
        # never step past the sample — frugal overshoot control
        if (d > 0 and est > x) or (d < 0 and est < x):
            est = x
        return est, step, d

    def update(self, x: float) -> float:
        x = float(x)
        if self.n == 0:
            self.med = x
            self._med_step = max(abs(x) * 0.1, 1e-6)
            self._mad_step = self._med_step
            self.n = 1
            return 0.0
        dev = abs(x - self.med)
        z = 0.6745 * (x - self.med) / (self.mad + self.eps)
        self.med, self._med_step, self._med_dir = self._frugal(
            self.med, self._med_step, self._med_dir, x
        )
        self.mad, self._mad_step, self._mad_dir = self._frugal(
            self.mad, self._mad_step, self._mad_dir, dev
        )
        self.n += 1
        return 0.0 if self.n <= self.warmup else z


@dataclass
class Detection:
    """One firing series at one tick."""

    name: str
    z: float
    value: float
    at: float
    opens_incident: bool


class _Series:
    __slots__ = ("name", "source", "detector", "min_consecutive",
                 "opens_incident", "direction", "hold_while", "consecutive",
                 "active", "last_value", "last_z", "firings")

    def __init__(self, name, source, detector, min_consecutive,
                 opens_incident, direction, hold_while):
        self.name = name
        self.source = source
        self.detector = detector
        self.min_consecutive = min_consecutive
        self.opens_incident = opens_incident
        self.direction = direction
        self.hold_while = hold_while
        self.consecutive = 0
        self.active = False
        self.last_value = 0.0
        self.last_z = 0.0
        self.firings = 0

    def anomalous(self, z: float) -> bool:
        t = self.detector.z_threshold
        if self.direction == "up":
            return z >= t
        if self.direction == "down":
            return z <= -t
        return abs(z) >= t


class DetectorBank:
    """Named detector series sampled together each tick."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self._series: dict[str, _Series] = {}
        self.ticks = 0

    def attach(self, name: str, source: Callable[[], float | None],
               detector, min_consecutive: int = 3,
               opens_incident: bool = False,
               direction: str = "both",
               hold_while: Callable[[], bool] | None = None) -> None:
        """Bind `source` to `detector` under `name`. `direction` gates
        which side of the baseline fires ("up"/"down"/"both");
        `min_consecutive` anomalous ticks are required before the series
        fires (blip suppression); only `opens_incident=True` series feed
        the incident log — the rest are attribution context.

        `hold_while` decouples detection from resolution: a z-score
        detector spots a STEP (one or two anomalous ticks before the
        estimates adapt), but the condition it detected may persist for
        minutes. Once fired, the series keeps firing while `hold_while()`
        is true (e.g. "a region is still unhealthy"), so the incident it
        opened closes on actual recovery, not on the detector's
        adaptation."""
        if name in self._series:
            raise ValueError(f"duplicate detector series {name!r}")
        if direction not in ("up", "down", "both"):
            raise ValueError(f"bad direction {direction!r}")
        self._series[name] = _Series(
            name, source, detector, min_consecutive, opens_incident,
            direction, hold_while,
        )

    def tick(self, now: float | None = None) -> list[Detection]:
        """Sample every source; return the series currently FIRING
        (anomalous for >= min_consecutive ticks, or held firing by their
        `hold_while` condition)."""
        now = self.clock() if now is None else now
        self.ticks += 1
        out: list[Detection] = []
        for s in self._series.values():
            try:
                v = s.source()
            except Exception:
                continue  # a dying source must not kill the bank
            if v is None:
                continue
            z = s.detector.update(v)
            s.last_value = float(v)
            s.last_z = z
            if s.anomalous(z):
                s.consecutive += 1
            else:
                s.consecutive = 0
            if s.consecutive >= s.min_consecutive:
                s.firings += 1
                s.active = True
            elif s.active:
                try:
                    held = s.hold_while is not None and bool(s.hold_while())
                except Exception:
                    held = False
                if not held:
                    s.active = False
            if s.active:
                out.append(Detection(s.name, z, float(v), now,
                                     s.opens_incident))
        return out

    def top_anomalous(self, n: int = 5) -> list[dict]:
        """The n series with the largest current |z| — the anomalous-
        series half of an incident's attribution snapshot."""
        rows = sorted(
            self._series.values(), key=lambda s: abs(s.last_z),
            reverse=True,
        )
        return [
            {"series": s.name, "z": round(s.last_z, 3),
             "value": s.last_value}
            for s in rows[:n] if s.last_z
        ]

    # -- reporter surface ---------------------------------------------------

    def values(self) -> dict[str, float]:
        return {
            "seriesTotal": float(len(self._series)),
            "seriesAnomalous": float(sum(
                1 for s in self._series.values() if s.active
            )),
            "detectTicksCt": float(self.ticks),
            "firingsCt": float(sum(
                s.firings for s in self._series.values()
            )),
        }

    def gauge_keys(self) -> set[str]:
        return {"seriesTotal", "seriesAnomalous"}

    def labeled_values(self) -> dict[str, dict[str, float]]:
        return {
            s.name: {
                "lastValue": s.last_value,
                "lastZ": s.last_z,
                "anomalousTicks": float(s.consecutive),
                "seriesFiringsCt": float(s.firings),
            }
            for s in self._series.values()
        }

    def labeled_gauge_keys(self) -> set[str]:
        return {"lastValue", "lastZ", "anomalousTicks"}


# -- source factories ---------------------------------------------------------


def reporter_key_source(reporter, key: str) -> Callable[[], float | None]:
    """Sample one key of a `values()` reporter (core/report.py)."""

    def src() -> float | None:
        return dict(reporter.values()).get(key)

    return src


def histogram_quantile_source(hist_fn, q: float) -> Callable[[], float | None]:
    """Sample a quantile of a LogHistogram-returning callable — e.g.
    `lambda: reporter.histograms().get("verifyLatencyS")`."""

    def src() -> float | None:
        h = hist_fn()
        return h.quantile(q) if h is not None and h.count else None

    return src


def counter_rate(source: Callable[[], float | None],
                 clock: Callable[[], float] = time.monotonic
                 ) -> Callable[[], float | None]:
    """Difference a cumulative counter source into a per-second rate
    (first sample primes the baseline and returns None)."""
    prev: list = [None, None]  # [value, t]

    def src() -> float | None:
        v = source()
        if v is None:
            return None
        now = clock()
        pv, pt = prev
        prev[0], prev[1] = v, now
        if pv is None or now <= pt:
            return None
        return (v - pv) / (now - pt)

    return src
