"""Reporter-plane pieces — the part of handel_tpu/core/report.py that the
port uses: the warn-once log gate Handel reports as `logWarnCt`, and the
host-side point-validation counters its host scheme feeds (the G2 subgroup
check on unmarshal)."""

from __future__ import annotations


class WarnOnce:
    """Warn-once log gate with a reporter-plane counter.

    A flooder spamming malformed packets must not turn per-packet logging
    into the attack, so repeat offenses per reason drop to debug; every
    occurrence (warned or suppressed) counts toward `logWarnCt`."""

    def __init__(self, logger):
        self.log = logger
        self.counts: dict[str, int] = {}

    def warn(self, key: str, detail) -> None:
        n = self.counts.get(key, 0) + 1
        self.counts[key] = n
        (self.log.warn if n == 1 else self.log.debug)(key, detail)

    def total(self) -> int:
        return sum(self.counts.values())

    def values(self) -> dict[str, float]:
        return {"logWarnCt": float(self.total())}


class CurveCheckCounters:
    """Process-wide counters for host-side point-validation cost: the G2
    subgroup check (a scalar multiplication by r on every pubkey-bearing
    unmarshal, models/bn254.py) is the largest host item on the registry
    load path."""

    def __init__(self):
        self.g2_checks = 0
        self.g2_time_ms = 0.0

    def add_g2(self, dt_ms: float) -> None:
        self.g2_checks += 1
        self.g2_time_ms += dt_ms

    def values(self) -> dict[str, float]:
        return {
            "g2SubgroupChecks": float(self.g2_checks),
            "g2SubgroupCheckTimeMs": self.g2_time_ms,
        }


#: the per-process instance the host scheme feeds
SUBGROUP_CHECKS = CurveCheckCounters()
