"""Node -> process/instance allocation with offline injection — a copy of
handel_tpu/sim/allocator.py.

Reference: simul/lib/allocator.go:25-197 — `RoundRobin` (deterministic,
evenly spaced offline nodes) and `RoundRandomOffline` (random offline set),
plus allocation validation. The allocation maps every logical node id to a
(process, instance) slot and marks Failing of them inactive; inactive nodes
are simply never launched (platform passes only active ids).
"""

from __future__ import annotations

import random
from dataclasses import dataclass


@dataclass
class NodeSlot:
    id: int
    instance: int  # machine index
    process: int  # process index within the machine (global numbering)
    active: bool


class RoundRobin:
    """Deterministic allocation: ids round-robin over processes; offline ids
    evenly spaced through the id range (allocator.go:52-86)."""

    def allocate(
        self, total: int, instances: int, procs_per_instance: int, failing: int
    ) -> dict[int, NodeSlot]:
        nproc = instances * procs_per_instance
        offline = set()
        if failing:
            step = total / failing
            offline = {int(i * step) for i in range(failing)}
        out = {}
        for nid in range(total):
            proc = nid % nproc
            out[nid] = NodeSlot(
                id=nid,
                instance=proc // procs_per_instance,
                process=proc,
                active=nid not in offline,
            )
        return verify_allocation(out, total, failing)


class RoundRandomOffline:
    """Round-robin placement with a seeded-random offline set
    (allocator.go:146-162)."""

    def __init__(self, seed: int = 777):
        self.seed = seed

    def allocate(
        self, total: int, instances: int, procs_per_instance: int, failing: int
    ) -> dict[int, NodeSlot]:
        nproc = instances * procs_per_instance
        rng = random.Random(self.seed)
        offline = set(rng.sample(range(total), failing)) if failing else set()
        out = {}
        for nid in range(total):
            proc = nid % nproc
            out[nid] = NodeSlot(
                id=nid,
                instance=proc // procs_per_instance,
                process=proc,
                active=nid not in offline,
            )
        return verify_allocation(out, total, failing)


def verify_allocation(
    alloc: dict[int, NodeSlot], total: int, failing: int
) -> dict[int, NodeSlot]:
    """Invariant checks (allocator.go verifyAllocation)."""
    if len(alloc) != total:
        raise ValueError(f"allocation covers {len(alloc)}/{total} nodes")
    inactive = sum(1 for s in alloc.values() if not s.active)
    if inactive != failing:
        raise ValueError(f"{inactive} offline nodes, expected {failing}")
    return alloc


def new_allocator(name: str):
    """simul/lib/config.go:228-238 allocator factory."""
    name = (name or "round-robin").lower()
    if name in ("round-robin", "roundrobin", "linear"):
        return RoundRobin()
    if name in ("round-random", "random"):
        return RoundRandomOffline()
    raise ValueError(f"unknown allocator {name!r}")
