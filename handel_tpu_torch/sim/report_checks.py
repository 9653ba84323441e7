"""One source of truth for report acceptance checks — a copy of
handel_tpu/sim/report_checks.py.

The soak and federation harnesses (sim/soak.py, sim/load.py) both emit
bench-record-shaped reports
carrying a `checks` block, and their CI smokes re-assert the same
invariants with human-readable failure detail. Before this module the
predicate logic lived twice — once in the report builder, once in the
smoke's asserts — and could silently drift. Now each invariant is one
`Check`: a name, a predicate over the REPORT dict (so it can be
re-evaluated from the persisted JSON alone), and a failure-message
renderer the smokes raise with.

`attach(report, checks)` is what report builders call (sets `checks` +
`ok`); `assert_checks(report, checks)` is what smokes call — both read
the same predicates, so an artifact that says `ok` is exactly an
artifact the smoke would accept.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence


@dataclass(frozen=True)
class Check:
    name: str
    predicate: Callable[[dict], bool]
    describe: Callable[[dict], str]


def evaluate(report: dict, checks: Sequence[Check]) -> dict[str, bool]:
    return {c.name: bool(c.predicate(report)) for c in checks}


def attach(report: dict, checks: Sequence[Check]) -> dict:
    """Stamp `checks` + `ok` onto a report (the builder-side entry)."""
    report["checks"] = evaluate(report, checks)
    report["ok"] = all(report["checks"].values())
    return report


def assert_checks(report: dict, checks: Sequence[Check]) -> None:
    """Re-assert every check with its failure detail (the smoke-side
    entry) — evaluated fresh from the report, not trusted from `ok`."""
    for c in checks:
        assert c.predicate(report), f"check {c.name}: {c.describe(report)}"


# -- the lifecycle soak's invariants (sim/soak.py report schema) -------------

SOAK_CHECKS: tuple[Check, ...] = (
    Check(
        "zero_dropped",
        # every spawned session reached a terminal verdict, none of them
        # by expiry: zero dropped futures across swap + lane loss
        lambda r: r["soak"]["expired"] == 0 and r["soak"]["unresolved"] == 0,
        lambda r: (
            f"dropped work: expired={r['soak']['expired']} "
            f"unresolved={r['soak']['unresolved']}"
        ),
    ),
    Check(
        "epoch_advanced",
        lambda r: (
            r["soak"]["epoch_rotations"] == 1
            and r["soak"]["summary"]["epoch"] >= 1
        ),
        lambda r: "epoch rotation did not complete",
    ),
    Check(
        # the swap hid between launches: neither the measured stall nor
        # the launch gap straddling it exceeded the cadence bound
        "swap_bounded",
        lambda r: (
            r["epoch_swap_stall_ms"] <= r["soak"]["swap_gap_bound_ms"]
            and r["soak"]["gaps"]["swap_gap_ms"]
            <= r["soak"]["swap_gap_bound_ms"]
        ),
        lambda r: (
            f"epoch swap not hidden between launches: "
            f"stall {r['epoch_swap_stall_ms']}ms / swap gap "
            f"{r['soak']['gaps']['swap_gap_ms']}ms vs bound "
            f"{r['soak']['swap_gap_bound_ms']}ms"
        ),
    ),
    Check(
        "lane_replaced",
        lambda r: (
            r["soak"]["lanes_replaced"] >= 1
            and r["soak"]["summary"]["devices"] >= r["soak"]["devices_floor"]
        ),
        lambda r: "forced lane loss was not repaired by the autoscaler",
    ),
    Check(
        "p99_within_slo",
        lambda r: bool(r["soak"]["tiers"])
        and all(t["met"] for t in r["soak"]["tiers"].values()),
        lambda r: f"tier p99 breached its SLO target: {r['soak']['tiers']}",
    ),
)


# -- the federation load run's invariants (sim/load.py report schema) --------
#
# The kill-drill checks pass vacuously when no kill was scheduled (the
# report's `kill` block is None), so one static list serves both plain
# open-loop runs and the chaos variant.


def _kill(r: dict) -> dict | None:
    return r["federation"].get("kill")


FEDERATION_CHECKS: tuple[Check, ...] = (
    Check(
        "zero_dropped",
        # open-loop accounting closes: every arrival is a completion, an
        # attributed shed, a traced retry-budget failure, or an expiry —
        # nothing silently vanished, nothing still unresolved at exit
        lambda r: (
            r["federation"]["unaccounted"] == 0
            and r["federation"]["unresolved"] == 0
        ),
        lambda r: (
            f"dropped sessions: unaccounted="
            f"{r['federation']['unaccounted']} "
            f"unresolved={r['federation']['unresolved']} of "
            f"{r['federation']['arrivals']} arrivals"
        ),
    ),
    Check(
        "p99_within_slo",
        lambda r: bool(r["federation"]["tiers"])
        and all(t["met"] for t in r["federation"]["tiers"].values()),
        lambda r: (
            f"open-loop tier p99 breached its SLO target: "
            f"{r['federation']['tiers']}"
        ),
    ),
    Check(
        "shed_bounded",
        lambda r: r["shed_rate"] <= r["federation"]["shed_ceiling"],
        lambda r: (
            f"shed rate {r['shed_rate']} above the configured ceiling "
            f"{r['federation']['shed_ceiling']}"
        ),
    ),
    Check(
        "region_killed",
        lambda r: _kill(r) is None
        or (
            _kill(r)["killed_at_s"] is not None
            and _kill(r)["unhealthy_detected_s"] is not None
        ),
        lambda r: (
            f"region kill drill incomplete: {_kill(r)} — the region was "
            f"not stopped or the front door never marked it unhealthy"
        ),
    ),
    Check(
        "spillover_observed",
        lambda r: _kill(r) is None or r["federation"]["spillovers"] > 0,
        lambda r: (
            "a region died but no arrival spilled over to another region"
        ),
    ),
    Check(
        "recovery_traced",
        lambda r: _kill(r) is None
        or (
            _kill(r)["recovery_s"] is not None
            and _kill(r)["post_recovery_completed"] > 0
        ),
        lambda r: (
            f"region recovery not observed: {_kill(r)} — no completion "
            f"landed in the recovered region after its rejoin"
        ),
    ),
)
