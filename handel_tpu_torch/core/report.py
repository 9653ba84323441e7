"""Host-side point-validation counters — the part of handel_tpu/core/report.py
that the port's host scheme feeds (the G2 subgroup check on unmarshal)."""

from __future__ import annotations


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
