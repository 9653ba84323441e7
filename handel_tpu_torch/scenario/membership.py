"""Deterministic membership schedules: who leaves/joins, and when — a copy of
handel_tpu/scenario/membership.py.

A schedule is a pure function of its constructor arguments, so every
process — and every re-run with the same TOML — derives the identical
timeline. Leaves seat on the churner adversary ids (sim/adversary.py
`adversary_roles`: highest non-offline ids), each with a seeded stagger
around the configured departure time so a 10%-churn run doesn't drop all
its churners on one tick. Joins are new identities ABOVE the current
registry (ids n, n+1, ...), admitted through the epoch path
(lifecycle/epoch.py stage_registry -> activate_staged): a join lands in
the NEXT epoch's committee, it does not retro-enter a running round.
"""

from __future__ import annotations

import random
from dataclasses import dataclass


@dataclass(frozen=True)
class MembershipEvent:
    at_s: float  # seconds after run start
    kind: str  # "leave" | "join"
    node_id: int


class MembershipSchedule:
    """The run's membership timeline over an n-node starting committee."""

    def __init__(
        self,
        nodes: int,
        churner_ids: tuple[int, ...] | list[int] = (),
        churn_after_s: float = 0.5,
        joins: int = 0,
        join_at_s: float = 1.0,
        seed: int = 0,
    ):
        self.nodes = nodes
        rng = random.Random(f"membership|{seed}")
        events: list[MembershipEvent] = []
        for nid in sorted(churner_ids):
            # stagger each departure within ±25% of the nominal time
            at = churn_after_s * (0.75 + 0.5 * rng.random())
            events.append(MembershipEvent(at, "leave", nid))
        for k in range(joins):
            events.append(MembershipEvent(join_at_s, "join", nodes + k))
        self.events = sorted(events, key=lambda e: (e.at_s, e.node_id))

    def leaves(self) -> list[MembershipEvent]:
        return [e for e in self.events if e.kind == "leave"]

    def joins(self) -> list[MembershipEvent]:
        return [e for e in self.events if e.kind == "join"]

    def leave_time_of(self, node_id: int) -> float | None:
        for e in self.events:
            if e.kind == "leave" and e.node_id == node_id:
                return e.at_s
        return None

    def final_size(self) -> int:
        return self.nodes - len(self.leaves()) + len(self.joins())
